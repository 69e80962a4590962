"""Seeded tensors made on the device, in a few large calls.

Every weight of a configuration comes from one normal draw of a
generator on the device, seeded from the run's ``--seed`` and a stream
number, so the program and the reference get the same values from the
same seed, and two runs of one seed the same inputs.
"""

from __future__ import annotations

import math

import torch

STREAM_WEIGHTS, STREAM_TOKENS, STREAM_DATA = 0, 1, 2


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(seed) * 8 + stream) % (2 ** 63))
    return g


def make(specs: list, seed: int, device) -> dict:
    """``{name: tensor}`` for ``(name, shape, mean, std, kind)`` specs:
    ``mean + std * z``, views of one float32 buffer."""
    total = sum(math.prod(s[1]) for s in specs)
    flat = torch.randn(total, generator=generator(seed, STREAM_WEIGHTS,
                                                  device),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, mean, std, _kind in specs:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(std).add_(mean)
        at += n
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, values: dict) -> None:
    """Copy ``values`` into ``module``'s parameters and buffers by name;
    every entry of its state must be given, and nothing else."""
    state = module.state_dict(keep_vars=True)
    if set(state) != set(values):
        missing = sorted(set(state) - set(values))[:5]
        extra = sorted(set(values) - set(state))[:5]
        raise KeyError(f"weights do not match the module: missing "
                       f"{missing}, unexpected {extra}")
    for name, t in state.items():
        t.copy_(values[name])
