"""Published peaks of the cards the benchmark runs on.

NVIDIA's data sheet, dense rates without sparsity, at the full power
limit.  Keyed by substrings of ``torch.cuda.get_device_name()``, first
match wins, so the PCIe part precedes the generic H100 entries.  The
dense bf16 tensor-core rate is the repository's one peak for MFU, what
ever the compute dtype, so a float32 run's share is understated.
"""

from __future__ import annotations

# (substring, bf16 FLOP/s, HBM bytes/s)
_PEAKS: tuple[tuple[str, float, float], ...] = (
    ("h100 pcie", 756e12, 2.0e12),
    ("h100 80gb hbm3", 989.4e12, 3.35e12),  # the SXM5 part at 700 W
    ("h100 sxm", 989.4e12, 3.35e12),
)


def peaks(device_name: str) -> tuple[float, float] | None:
    """``(flops, bytes)`` a second for a card's name, or None for a card
    the table does not hold."""
    name = device_name.lower()
    for key, flops, nbytes in _PEAKS:
        if key in name:
            return flops, nbytes
    return None
