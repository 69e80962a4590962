"""tpudp_torch — the PyTorch and CUDA port of ``tpudp``, for NVIDIA Hopper.

The JAX package ``tpudp`` is the reference; this package ports it slice by
slice (ROADMAP.md).  Ported so far:

  * paged continuous-batching serving — ``tpudp_torch.serve.Engine``
    over ``tpudp_torch.models.gpt2`` or ``tpudp_torch.models.llama``
    (grouped-query heads), with the paged-decode and paged-window
    attention kernels, their int8 variants over an int8 page pool
    (``kv_dtype="int8"``), and speculative decoding through the
    paged-window and paged-tree kernels (``serve_cli``);
  * the data-parallel VGG-11 ladder — the four Part trainers
    (``tpudp_torch.parts``) over the 11 gradient sync rungs
    (``tpudp_torch.parallel``) on ``torch.distributed`` process groups
    (``tpudp_torch.mesh``), with the epoch ``tpudp_torch.trainer.Trainer``
    and the JAX package's data pipeline (``tpudp_torch.data``);
  * single-device GPT-2 training — ``tpudp_torch.train``
    (``make_optimizer``, ``init_state``, ``make_train_step``), with flash
    attention's forward, dq and dk/dv kernels behind
    ``tpudp_torch.ops.flash_attention`` (``train_cli``);
  * the parallel strategies — ``tpudp_torch.strategy.build_strategy``
    (tp, fsdp, zero1, pp with gpipe and 1f1b, ep with the MoE MLP of
    ``tpudp_torch.models.moe``, sp with ``tpudp_torch.parallel.
    ring_attention``) over ``tpudp_torch.mesh.make_mesh_nd`` meshes,
    through the Trainer and ``train_cli --mesh --strategy``;
  * checkpoints and supervision — ``tpudp_torch.utils.checkpoint``
    (verified save, restore and resume, asynchronous writes, emergency
    dumps), ``tpudp_torch.utils.watchdog``, the in-process supervisor
    ``tpudp_torch.resilience`` and ``tpudp_torch.training_faults``.

Every kernel is written in CUDA for ``sm_90a`` (``tpudp_torch/csrc``);
the VGG ladder runs none (cuDNN, cuBLAS and NCCL do its work).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
