"""What the drivers share: the run's context, fences, the window's
clock, and the release of the program's state."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Ctx:
    """One run of a cell."""

    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    fault: str | None = None
    t0_wall: float = 0.0
    # with a check only (calibration): no window, the readings alone
    check_only: bool = False
    precisions: tuple = ("fp32",)
    # (label, time.time()) at the ends of set-up's stages, in order
    marks: list = field(default_factory=list)

    def mark(self, label: str) -> None:
        self.marks.append((label, time.time()))

    def setup_parts(self) -> dict:
        """Seconds of each marked stage of set-up, from the process's
        start."""
        out, last = {}, self.t0_wall
        for label, t in self.marks:
            out[label], last = t - last, t
        return out


def fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_device(device: torch.device) -> None:
    """Select the card and create its context (the first CUDA call)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)


class Stopper:
    """Whether the window is over, by the host clock."""

    def __init__(self, ctx: Ctx):
        self.ctx = ctx

    def start(self) -> None:
        self.t0 = time.perf_counter()
        self.t0_wall = time.time()

    def over(self) -> bool:
        return time.perf_counter() - self.t0 >= self.ctx.seconds


def release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0
