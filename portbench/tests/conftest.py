"""Shared helpers of the benchmark's tests: tiny versions of the cells
for CPU rehearsals, and the card fixture of the ``cuda``-marked tests."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Widths a CPU run can hold in seconds; the drivers and the reference
# take them as they take the cells' own.
TINY_LM = {"config": {"n_layer": 2, "n_embd": 64, "n_head": 2,
                      "vocab_size": 256},
           "traffic": {"batch": 2, "seq_len": 128,
                       "ref_block_rows": 1, "profile_steps": 2}}
TINY_PART = {"config": {"train_size": 256},
             "traffic": {"batch": 16, "warmup_steps": 1,
                         "profile_steps": 2}}


def tiny_cell(name: str, float32: bool = False) -> dict:
    """Cell ``name`` cut to a CPU rehearsal's size; with ``float32`` the
    program computes in float32 (so that a sound run's gaps are
    rounding)."""
    from portbench.harness import manifest

    cell = manifest.cell(name, root=ROOT)
    tiny = TINY_LM if cell["traffic"]["driver"] == "lm_train" else TINY_PART
    cell["config"].update(tiny["config"])
    cell["traffic"].update(tiny["traffic"])
    if float32:
        cell["config"]["program"] = {**cell["config"]["program"],
                                     "dtype": "float32"}
    return cell


@pytest.fixture
def card():
    """The test's card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the port's kernels have no CPU "
                    "mode); run on the card")
    return torch.device("cuda", 0)
