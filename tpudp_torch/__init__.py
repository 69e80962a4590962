"""tpudp_torch — the PyTorch and CUDA port of ``tpudp``, for NVIDIA Hopper.

The JAX package ``tpudp`` is the reference; this package ports it slice by
slice (ROADMAP.md).  Ported so far:

  * paged continuous-batching serving — ``tpudp_torch.serve.Engine``
    over ``tpudp_torch.models.gpt2`` or ``tpudp_torch.models.llama``
    (grouped-query heads), with the paged-decode and paged-window
    attention kernels, their int8 variants over an int8 page pool
    (``kv_dtype="int8"``), and speculative decoding through the
    paged-window and paged-tree kernels (``serve_cli``);
  * single-device GPT-2 training — ``tpudp_torch.train``
    (``make_optimizer``, ``init_state``, ``make_train_step``), with flash
    attention's forward, dq and dk/dv kernels behind
    ``tpudp_torch.ops.flash_attention`` (``train_cli``).

Every kernel is written in CUDA for ``sm_90a`` (``tpudp_torch/csrc``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
