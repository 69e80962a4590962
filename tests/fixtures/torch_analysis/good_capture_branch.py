"""The corrected twin: branches on the device, or on host metadata."""

import torch


class Window:
    def __init__(self):
        self.inputs = {"running": torch.zeros(2, dtype=torch.bool)}

    # tpudp: captured
    def iterate(self, x: torch.Tensor, steps: int):
        running = self.inputs["running"]
        x = torch.where(running, x + 1, x)
        if x.shape[0] > 1 and steps > 2:      # host metadata: fine
            x = x * 2
        return x
