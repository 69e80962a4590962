"""Seeded violations for capture-nondeterminism."""

import random
import time

import numpy as np
import torch


class Window:
    # tpudp: captured
    def iterate(self, x: torch.Tensor, gen):
        t0 = time.perf_counter()              # finding: frozen clock
        jitter = random.random()              # finding: frozen host RNG
        noise = np.random.normal()            # finding: frozen numpy RNG
        u = torch.rand(x.shape)               # finding: default generator
        y = x.clone()
        y.uniform_()                          # finding: default generator
        return y + u + t0 + jitter + noise
