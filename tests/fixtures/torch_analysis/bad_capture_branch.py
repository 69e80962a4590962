"""Seeded violations for capture-branch."""

import torch


class Window:
    def __init__(self):
        self.inputs = {"running": torch.zeros(2, dtype=torch.bool)}

    # tpudp: captured
    def iterate(self, x: torch.Tensor):
        running = self.inputs["running"]
        if running.any():                     # finding: frozen branch
            x = x + 1
        while (x > 3).all():                  # finding: frozen loop
            x = x - 1
        y = x * 2 if x.sum() > 0 else x      # finding: frozen ternary
        return y
