"""tpudp_torch.serve — continuous-batching inference on the card: slot
scheduler, chunked prefill, streaming decode, paged KV with
copy-on-write prefix reuse through the paged-attention kernels, and
speculative decoding (sequence and tree verify)."""

from tpudp_torch.serve.engine import (Engine, EngineClosed, FinishReason,
                                      QueueFull, Request, RequestFailed)
from tpudp_torch.serve.prefix_cache import PageIndex, PagePool
from tpudp_torch.serve.speculate import (DraftModelDrafter, NgramDrafter,
                                         TreeShape)

__all__ = ["Engine", "Request", "FinishReason", "PageIndex", "PagePool",
           "QueueFull", "EngineClosed", "RequestFailed", "NgramDrafter",
           "DraftModelDrafter", "TreeShape"]
