"""The corrected twin: host values come in as inputs, every draw names
its registered generator."""

import torch


class Window:
    # tpudp: captured
    def iterate(self, x: torch.Tensor, gen, t0: float):
        u = torch.rand(x.shape, generator=gen)
        y = x.clone()
        y.uniform_(generator=gen)
        return y + u + t0
