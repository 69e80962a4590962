"""tpudp_torch.serve — continuous-batching inference on the card: slot
scheduler, chunked prefill, streaming decode, paged KV with
copy-on-write prefix reuse through the paged-attention kernels, the
dense prefix cache, speculative decoding (sequence and tree verify), and
tenancy: priority tiers with exact preemption and co-resident models."""

from tpudp_torch.serve.engine import (Engine, EngineClosed, FinishReason,
                                      QueueFull, Request, RequestFailed)
from tpudp_torch.serve.prefix_cache import PageIndex, PagePool, PrefixCache
from tpudp_torch.serve.speculate import (DraftModelDrafter, NgramDrafter,
                                         TreeShape)
from tpudp_torch.serve.tenancy import TenantClass, TenantScheduler

__all__ = ["Engine", "Request", "FinishReason", "PageIndex", "PagePool",
           "PrefixCache", "QueueFull", "EngineClosed", "RequestFailed",
           "NgramDrafter", "DraftModelDrafter", "TreeShape", "TenantClass",
           "TenantScheduler"]
