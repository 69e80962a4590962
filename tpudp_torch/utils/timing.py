"""Compatibility shim, as JAX's ``tpudp/utils/timing.py``:
:class:`StepTimer` lives in ``tpudp_torch.obs.timing``."""

from tpudp_torch.obs.timing import StepTimer  # noqa: F401
