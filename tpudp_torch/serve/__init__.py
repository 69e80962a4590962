"""tpudp_torch.serve — continuous-batching inference on the card: slot
scheduler, chunked prefill, streaming decode, and paged KV with
copy-on-write prefix reuse through the paged-attention kernels."""

from tpudp_torch.serve.engine import (Engine, EngineClosed, FinishReason,
                                      QueueFull, Request, RequestFailed)
from tpudp_torch.serve.prefix_cache import PageIndex, PagePool

__all__ = ["Engine", "Request", "FinishReason", "PageIndex", "PagePool",
           "QueueFull", "EngineClosed", "RequestFailed"]
