"""Device traces — the port of ``tpudp/obs/tracing.py``.

The recorder (``tpudp_torch/obs/record.py``) says what the host was
doing; :func:`trace` says what the card was doing: a
``torch.profiler.profile`` of the region (CPU and, where there is a
card, CUDA activity) whose Chrome trace is written into ``log_dir`` as
``trace-<pid>.json`` — Perfetto and ``chrome://tracing`` load it.  JAX
writes an XLA profile in TensorBoard's format there instead.
:func:`step_annotation` marks one training step in an active trace, as
JAX's ``StepTraceAnnotation`` does.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

@contextlib.contextmanager
def trace(log_dir: str | None) -> Iterator[None]:
    """A ``torch.profiler`` capture into ``log_dir`` (no-op when None);
    the Chrome trace lands in ``log_dir/trace-<pid>.json`` at exit."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace-{os.getpid()}.json"))


def step_annotation(step: int):
    """Mark training step ``step`` in an active trace: a
    ``record_function`` range named ``train_step#<step>``."""
    import torch

    return torch.profiler.record_function(f"train_step#{step}")
