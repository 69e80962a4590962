"""The corrected twin: a census wrapper counts each launch, through a
helper too."""
# tpudp: kernel-module

from tpudp_torch.ops import _build


def _launch(name, q):
    return _build.launcher(name)(q.data_ptr())


def paged_decode(q):
    paged_decode.calls += 1
    code = _launch("paged_decode", q)
    paged_decode.launches += 1
    return code
