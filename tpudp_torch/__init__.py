"""tpudp_torch — the PyTorch and CUDA port of ``tpudp``, for NVIDIA Hopper.

The JAX package ``tpudp`` is the reference; this package ports it slice by
slice (ROADMAP.md).  Ported so far:

  * paged continuous-batching GPT-2 serving — ``tpudp_torch.serve.Engine``
    over ``tpudp_torch.models.gpt2``, with the paged-decode and
    paged-window attention kernels (``serve_cli``);
  * single-device GPT-2 training — ``tpudp_torch.train``
    (``make_optimizer``, ``init_state``, ``make_train_step``), with flash
    attention's forward, dq and dk/dv kernels behind
    ``tpudp_torch.ops.flash_attention`` (``train_cli``).

Every kernel is written in CUDA for ``sm_90a`` (``tpudp_torch/csrc``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
