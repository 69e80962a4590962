"""tpudp_torch — the PyTorch and CUDA port of ``tpudp``, for NVIDIA Hopper.

The JAX package ``tpudp`` is the reference; this package ports it slice by
slice (ROADMAP.md).  Slice 1 is paged continuous-batching GPT-2 serving:
``tpudp_torch.serve.Engine`` over ``tpudp_torch.models.gpt2``, with the
paged-decode and paged-window attention kernels written in CUDA for
``sm_90a`` (``tpudp_torch/csrc``).  Entry points run on the card unless
the caller passes ``device="cpu"``.
"""
