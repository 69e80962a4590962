"""Seeded violations for unregistered-kernel."""
# tpudp: kernel-module

from tpudp_torch.ops import _build


def shadow_kernel(q):                         # not in the census
    code = _build.launcher("shadow")(q.data_ptr())   # finding
    shadow_kernel.launches += 1
    return code


def paged_decode(q):                          # in the census, uncounted
    return _build.launcher("paged_decode")(q.data_ptr())  # finding
