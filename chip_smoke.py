#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Runs from the root of a checkout, needs one CUDA card and ``nvcc``, and
imports nothing of JAX or of the JAX package ``tpudp``.  Phases, each of
which fails the run (nonzero exit, no result line) when it fails:

  1. device — the card's name and power limit, as nvidia-smi reports them;
  2. build — every CUDA kernel of the port, from ``tpudp_torch/csrc``,
     one nvcc per source, all started together; then the HGMMA (wgmma)
     instructions in the SASS of the flash forward, dq and dk/dv
     libraries, counted with ``cuobjdump -sass`` — none in any of them
     fails the run (the bf16 flash kernels must run on the tensor cores);
  3. kernels vs plain — each kernel against its plain PyTorch version on
     the same inputs: fragmented block tables (pages shared between
     slots, ``-1`` tails, whole-pool ``layer=`` mode), GPT-2 small's
     heads and a grouped-query shape, decode / prefill / 3-token windows,
     float32 (atol = rtol = 2e-5: only the summation order differs) and
     bfloat16 (atol 2e-2 and rtol 1.6e-2, two bf16 ulps: the plain
     path rounds probabilities to bf16 before P.V, the kernels keep them
     in float32, and both round outputs above 2 to a 1/64 grid); then the
     paged-window kernel at the edges of its schedule (``WINDOW_EDGES``:
     head dim 32, 128 rows a KV head, depth 0, a depth of 1,000 keys
     split across blocks, a 64-row chunk over 64-token pages) in the
     schedule's 8-row tiles and the kernel's widest (32 rows), each case
     called twice back to back so a merge ticket left unreset would show;
  3b. tree kernel vs plain — the paged-tree kernel against its plain
     version on the same fragmented tables, node queries and window K/V
     as strided views of one projection, the trees fork2x2, fork3+1,
     chain4 and a 32-node tree (the kernel's widest), GPT-2 small's heads
     and a grouped-query shape, per-layer and whole-pool, with phase 3's
     tolerances;
  3c. int8 kernels vs plain — the int8 variants of the paged-decode and
     paged-window kernels against their plain version (dequantize, then
     the einsum) on phase 3's fragmented tables over pools quantized by
     the port's ``_quantize_kv`` (one all-zero vector included), GPT-2
     small's heads (12/12) and LLaMA-GQA's (12/3), decode / prefill /
     3-token windows, per-layer and whole-pool, float32 queries (atol =
     rtol = 2e-5: the plain path dequantizes to the same float32 values)
     and bfloat16 queries (phase 3's bf16 tolerance: the plain path
     rounds the dequantized K/V to bf16, the kernels keep float32); then
     the int8 window variant at phase 3's schedule edges; then the
     paged-decode kernel and its int8 variant at the edges of theirs
     (``DECODE_EDGES``: depths 0, 31, 32 and 63, a slot at 1,023 keys
     beside one at 0, head dims 32 and 128, 1, 4 and 8 query heads a KV
     head, 64-token pages, an idle slot whose output must be zeros) over
     float32, bf16 and int8 pools, each case called twice back to back;
  4. main path — GPT-2 small at full width (random weights from --seed,
     float32) served by ``Engine(kv_pages=512)`` on the card, which
     resolves to the CUDA kernels; 8 greedy requests of 17-300 prompt
     tokens, two sharing a 64-token prefix (the second is admitted after
     the first retired, so its prefix is mapped from the page index).
     Both kernels of that path must have launched in that run, the page
     bookkeeping must check, and the tokens must equal the same engine's
     on the plain PyTorch attention — or differ first where the plain
     logits' top-2 gap is below 1e-3 (a near-tie of the random weights).
     Then one scheduler step with 8 slots decoding runs under
     ``torch.profiler`` (wall ms, device kernels, device busy share);
  4b. speculative main path — the same model and engine geometry with
     ``speculate_k=4`` and ``NgramDrafter(max_ngram=3, min_ngram=2)``, then
     with ``speculate_k=2, speculate_tree="fork2x2"``, serving 8 greedy
     requests of 32 new tokens: 4 period-4 tiled prompts of 64-256 tokens
     and 4 of phase 4's prompts, beside the non-speculative kernel and
     plain engines on the same prompts.  Each run must verify windows
     and accept drafts; every verify window and prefill chunk must have
     launched the paged-window kernel once per layer (the sequence run),
     every tree window the paged-tree kernel once per layer (the tree
     run), and every plain decode step the paged-decode kernel; the
     tokens must agree with the plain engine's under phase 4's near-tie
     rule; no kernel engine of phases 4 and 4b may list a fallback in
     ``metrics()["paged_attn"]``;
  4c. LLaMA main path — ``benchmarks/matrix_bench.py``'s ``llama_gqa``
     widths (12 layers, d 768, 12 query heads over 3 KV heads, SwiGLU
     hidden 2048, vocab 32000; context 1024, float32, random weights
     from --seed) served by ``Engine(kv_pages=512, kv_dtype="int8")`` on
     phase 4's traffic, three times: on the int8 kernels, on the plain
     attention over the same int8 pool, and on an fp32 pool through the
     fp kernels at 4 query heads per KV head.  The int8 run must launch
     each int8 kernel once per layer and decode step or prefill chunk
     and no fp kernel, its page bookkeeping must check, and its tokens
     must agree with the plain int8 run's under phase 4's near-tie rule
     (the gap read from the plain int8 prefill); agreement with the fp32
     run, page bytes, tokens/s, TTFT and a profiled decode step on each
     pool are printed, not gated; the fallbacks may name only tree verify
     over int8 (as in JAX);
  4d. routes — the shapes the kernels do not take, served by the kernel
     engine through the einsum path as decided at build time: GPT-2
     small's widths over 16 heads (head dim 48) cut to 2 layers, whose
     engine must list all four paged families in
     ``metrics()["paged_attn"]["fallbacks"]`` and launch no kernel; the
     phase-4 model with a 40-node ``speculate_tree``, which must list
     tree verify alone, verify trees and launch no tree kernel while its
     decode and prefill go through theirs; both serving tokens that agree
     with the plain engine's under phase 4's near-tie rule; and
     ``multihead_attention(impl='flash')`` at head dim 48 routed to the
     dense math (counted once, no flash kernel launched) and equal to
     it;
  4e. fused decode windows — phase 4's eight prompts at once (8 slots,
     96 new tokens each) through GPT-2 small over an fp32 pool (K4) and
     LLaMA-GQA over an int8 pool (K4-int8), greedy, each with
     ``decode_fuse=8`` and 1, then GPT-2 sampled (temperature 0.8, top-k
     40, top-p 0.95, per-request seeds) both ways, in turns (fused,
     single).  Each fused run must
     replay one captured CUDA graph (``metrics()["fused_window"]``),
     launch the paged-decode kernel 12 times per single decode step,
     warm-up iteration and replayed iteration, make at most 1/8 x 1.25
     host dispatches (single steps plus windows) per decoded token
     (``benchmarks/serve_bench.py``'s ``dispatch_ok``) and list no decode
     family in its fallbacks; greedy tokens must agree with
     ``decode_fuse=1`` under phase 4's near-tie rule, sampled tokens
     must be identical.  Prints tokens/s and TTFT p50 both ways, the
     p50 wall ms of single decode steps and of windows, ms per replayed
     iteration, and a window of each model under ``torch.profiler``.
     Phases 4 and 4c also print the p50 wall ms of their single decode
     steps (host ms per ``Engine.step``);
  4f. fused speculation — phase 4b's eight prompts (8 slots, max_len
     512, 32 new tokens each) through GPT-2 small over an fp32 pool with
     a draft GPT-2 of its vocabulary (4 layers, d 192, 3 heads, 1028
     positions: ``benchmarks/serve_bench.py``'s sizing), ``speculate_k=4``
     and ``decode_fuse=8``: greedy against the plain engine (einsum, no
     speculation) and the host-drafted kernel engine
     (``DraftModelDrafter(bucket=max_len)``, ``decode_fuse=1``) under
     phase 4's near-tie rule, sampled (temperature 0.9, top-k 12) equal to
     the host-drafted engine's tokens and acceptance.  Each fused run must
     capture one CUDA graph, launch the paged-window kernel 12 times per
     prefill chunk, host verify step, warm-up and replayed iteration, and
     sync the host once a window (its fetch; the first window's capture
     aside).  A shorter LLaMA-GQA case over int8 pages (4 prompts, 16
     tokens) holds K5-int8 inside the graph the same way.  Then, at
     serve_bench's zero-weight geometry (acceptance 1; 8 one-chunk
     prompts, 256 new tokens), fused speculation, host-drafted speculation
     and plain fused decode in turns (A B C): tokens/s, decoded
     tokens a window, device ms per replayed iteration and the draft's
     share of it (the draft alone captured in a graph of its own);
  4g. the robustness layer on GPT-2 small's kernel engine — a step fault
     at the second prefill call and at the second fused speculation
     window: each request requeued once, tokens equal to the unfaulted
     run's, the window not captured again; every call failing: ``ERROR``
     after one requeue; a 1.5 s stall in a decode step caught by a
     ``Watchdog(kill=False)`` of 0.5 s and contained; a deadline; a
     ``BitFlipLogits`` canary quarantining the engine; ``drain()``;
  5. flash kernels vs plain — the forward (``o``, ``lse``), dq and dk/dv
     kernels against their plain PyTorch versions on q, k, v taken as
     strided views of a ``(b, t, 3 h dh)`` projection and a random ``do``:
     GPT-2 small's heads (h 12, dh 64, b 4) at t 128 and 2048, dh 128 at
     t 256, dh 32 at t 256 (a scale not exact in bf16), t 200 (a partial
     tile at 64 and at 128 rows), and t 96 through the public op with
     its 128 blocks clamped to 96 (its autograd gradients too); causal
     and not, float32 (atol = rtol = 2e-5 forward, 1e-4 gradients;
     ``lse`` always at 2e-5) and bfloat16 (atol 2e-2 and rtol 1.6e-2, two
     bf16 ulps; the tensor-core kernels round P and dS to bf16, the plain
     versions do not; and, since most values of a long causal row are
     far below atol, each 64-token tile's error norm within 1e-2 of the
     reference's norm there);
  6. training main path — GPT-2 small at full width (random weights from
     --seed, bfloat16, context 2048, ``attn_impl='flash'``) trained by
     ``tpudp_torch.train`` with ``make_optimizer(learning_rate=0.01)``
     for 2 warm-up and 8 timed steps at batch 4 x 2048 tokens from a
     numpy seed.  Each flash kernel must launch once per layer and step;
     no call may be routed to the dense math; the same weights and
     batches trained with ``attn_impl='dense'``
     (no flash launch) must give per-step losses within rtol 2e-2 (bf16
     dense scores round otherwise than the kernels' float32 ones).  Each
     run then takes one step split into forward / backward / optimizer
     between CUDA events and one step under ``torch.profiler`` (device
     ms by kernel, the device's busy share);
  7. data-parallel VGG-11 — the training ladder through the port's entry
     points (``tpudp_torch.parts.part*.main`` and ``cli.run_part`` with
     an ``argv``), VGG-11 at full width, global batch 256, synthetic
     CIFAR-10-shaped data, world size 1 over NCCL; no port kernel may
     launch.  7a: the four Parts, Part 2b also under ``--ring``,
     ``--bf16-grads`` and ``--int8-grads``, the ``ring_bidir``,
     ``allreduce_hd`` and ``allreduce_a2a`` rungs, and int8 error
     feedback (``Trainer(compress='int8_ef', sync='none')``), float32, on
     5,120 train and 1,024 test images (20 iterations, one log window,
     then the eval): every loss finite, the reference's lines printed,
     and every rung but bf16's within ``VGG_LOSS_RTOL`` of Part 1's loss
     after 20 iterations (int8 error feedback within it of a plain loop
     of error feedback on the same batches).
     7b: Parts 1, 2b (all-reduce and ring) and 3 in float32, and Part 1
     in bfloat16, for 3 log windows: images/s and ms per step over the 2 steady
     windows (the warm-up window left out), peak device memory, the
     share of the card's peak from the FLOPs of the model's own shapes,
     and one profiled step of Parts 1 and 3 (device ms by kind of
     kernel, host gaps, busy share).  7c: two ranks on the one card over
     gloo with CUDA tensors (``allreduce`` and ``auto``, 4 steps at
     global batch 256) must end with bit-equal parameters and buffers;
     prints the gradient all-reduce's wall ms a step (gloo, staged
     through the host); then Part 2b ``--sync-bn`` and Part 3
     ``--spmd-mode gspmd`` (4 steps each, deterministic cuDNN) must end
     bit-equal across ranks with a first loss within ``SYNC_BN_RTOL`` of
     one rank's at the global batch.  Every Part runs on the loader's
     ``'auto'`` backend and fails unless it resolved to the native one;
     7b prints the loader alone on both backends, holds the native
     batches (4 train, 1 eval) byte-equal to numpy's, and runs Part 1 on
     the numpy and native loaders in turns in both dtypes (``vgg-ab``
     lines: images/s of each run);
  9. (run after phase 7, before the timing phase) ResNet at ImageNet
     geometry — ``tpudp_torch.train_resnet.main``
     (the port of ``examples/train_resnet.py``): ResNet-50 at full width,
     224x224, 1000 classes, global batch 256, the example's synthetic
     set on the native loader, bfloat16 for 30 steps and float32 (TF32
     off) for 20, logged every 10: images/s over the steady windows, ms a
     step, peak memory, the share of the card's peak from the model's own
     FLOPs (``resnet_forward_macs``), the step alone on one device batch
     and one profiled step (device ms by kind); the loader alone at 224
     on both backends; ResNet-50's train-mode logits at 224 (flax's
     init, batch 4) on the card in bfloat16 and float32 against the
     CPU's float32 logits, within ``RESNET_RTOL``; ResNet-101 and
     ResNet-152 for 5 bfloat16 steps at batch 64 (finite losses, ms a
     step, peak memory, the step alone, one profiled step's busy share);
     no port kernel may launch;
  10. (run after phase 9, before the timing phase) checkpoints, resume,
     the supervisor and GPT-2 served from its checkpoint, in a temporary
     directory outside the checkout.  10a: Part 1 (VGG-11, full width,
     2,560 train and 512 test images, batch 256) through ``cli.run_part``
     under deterministic cuDNN — run A trains 2 epochs with
     ``--checkpoint-async --keep-checkpoints 1``, which must leave one
     step_N; run B trains 1 with ``--checkpoint-dir``, then a fresh
     process resumes it from step_1 and stalls a step of epoch 2 under
     ``--step-timeout``: it must dump its state and exit 42, and the
     relaunch must print the fast-forward line, end with A's step_2
     (parameters, BatchNorm statistics, momentum, step, loss_sum) bit for
     bit and print A's ``Test set:`` line, as must ``--eval-only`` on B's
     directory.  10b: Part 1's Trainer under ``fit(resilience=)`` with a
     NaN batch, a raising step and a raising loader, one run each: final
     parameters, buffers and momentum bit-equal to an uninterrupted run,
     ``rollbacks``, ``step_retries`` and ``loader_restarts`` one each.
     10c: ``train_cli --attn flash --dtype bfloat16 --save-checkpoint``
     trains GPT-2 small (12 x 768, vocab 50,257, 4 x 1024 tokens) for 20
     steps — each flash kernel 12 launches a step — then ``serve_cli
     --checkpoint-dir`` serves 8 requests on the kernel engine (K4 and K5
     launched); the restored weights must equal the trained ones bit for
     bit, and its greedy tokens must agree with an engine of the trained
     model held in memory under phase 4's near-tie rule; its tokens, and
     phase 4's prompts on a kernel engine of the restored model, must
     agree with the plain engine's on the restored model (K1-K3 are held
     to their plain versions at t 1024 in phase 5); ``--layers 11`` must
     exit with its ``error:`` line.  10d: ``ckpt-cost`` lines — for
     ResNet-50 (bf16, one step in), VGG-11 and the GPT-2 state: bytes on
     disk, a synchronous save's ms, an asynchronous save's blocking and
     background ms, a restore's ms without and with verification; then a
     VGG-11 fit of 2 epochs of 50,000 images with no save, an epoch-end
     synchronous save and an asynchronous one, in turns;
  11. (run after phase 10, before the timing phase) the parallel
     strategies — ``tpudp_torch.strategy.build_strategy`` at GPT-2
     small's full width (12 x 768, 12 heads, vocab 50,257, t 1024,
     float32, TF32 off, global batch 4, 2 steps a rung, SGD lr 0.01
     momentum 0.9) on two ranks of the one card over gloo with CUDA
     tensors (NCCL takes one card a rank): tp ``1x2``, fsdp and zero1
     ``2``, pp ``1x2`` under gpipe and 1f1b with 4 microbatches, ep
     ``1x2`` with 4 experts at capacity factor 4.0 (no token drops, no
     balance loss) and sp ``1x2`` with ring attention; flash attention
     (K1-K3) everywhere but sp.  Each rung's losses must be within
     ``STRATEGY_RTOL`` of the one-rank step's on the same weights and
     batches (the dense MoE model for ep, the dense-attention model for
     sp), its replicated parameters bit-equal across the ranks, K1-K3
     must launch under every rung but sp, and fsdp's parameters and
     momentum and zero1's momentum must take about half of one rank's;
     ``strategy`` lines print each rung's ms a step, each rank's peak
     memory, its parameter and optimizer bytes beside the one-rank
     step's, the flash launches and the collectives' wall ms (gloo,
     staged through the host: their count and how many were staged);
  12. (run after phase 11, before the timing phase) the rest of the
     training side: 12a, the MPMD pipeline (``schedule='1f1b_mpmd'``):
     GPT-2 small as phase 11 at a global batch of 8 x 1024 in 4
     microbatches, on four gloo ranks of the card (``data 2 x pipe 2``,
     interleave 2: 4 chunks of 3 layers, the in-step sharded optimizer)
     and on two (``pipe 2``, interleave 1); each rank's losses must be
     within ``MPMD_RTOL`` of the one-rank step's and its stage's
     parameters after the steps within ``MPMD_ATOL`` of the one-rank
     step's same layers, the data replicas
     of a stage must hold bit-equal parameters, K1-K3 must launch on
     every rank, and a rank's momentum for the blocks must be 1/(PP*DP)
     of one rank's; ``mpmd`` lines print ms a step, the bubble fraction,
     the peak memory and the collectives' wall ms and share.  12c, the
     chunked loss: the one-rank step's first step beside a
     ``loss_chunk=1024`` step from the same weights — losses within
     1e-5, the chunked peak below the plain one (``chunk-loss`` line).
     12b, LLaMA-GQA training: one rank through ``train_cli --family
     llama --kv-heads 3`` with flash attention (K1-K3 12 a step each)
     and with dense attention, the losses within 2e-2 (``llama-cli``
     lines); then tp ``1x2`` (``wk``/``wv`` whole: 3 KV heads on 2
     ranks), fsdp and zero1 ``2`` and sp ``1x2`` on two gloo ranks, held
     as phase 11's rungs are (``llama-strategy`` lines).  No phase-12
     flash call may go to the dense math;
  13. (run after phase 12, before the timing phase) 13a, ViT-B/14 at
     224 (86 M parameters, 256 tokens, 12 heads of 64, 1,000 classes,
     bfloat16, AdamW, random weights from --seed) trained through
     ``tpudp_torch.train_vit``'s entry point at the example's ImageNet
     line (batch 128), once with ``--attn flash`` (K1-K3, non-causal)
     and once with ``--attn dense``, from the same weights and batches:
     the flash run must launch K1, K2 and K3 12 times a step each (a
     profiled step too, by the wrappers' counts, and its profile must
     record each kernel), send no flash call to the dense math, and
     its losses must be within VIT_LOSS_RTOL of the dense run's; the two
     models' logits on one batch within VIT_LOGIT_REL (relative error
     norm); ``vit`` lines print images/s, ms a step, peak memory and the
     share of the profiled step's device time in K1-K3, beside the card.
     13b, VGG-11 under ``vgg_tp_rules`` (each convolution's output
     channels split over ``model``) at data 1 x model 2 on two gloo
     ranks of the card, CIFAR geometry, batch 256, float32 with TF32 off
     and deterministic cuDNN, 3 steps, against the one-rank step on the
     same global batches: the first loss within VGG_TP_RTOL, the first
     update of the parameters and running statistics within
     VGG_TP_UPDATE_REL of its norm over all of them and
     VGG_TP_TENSOR_REL tensor by tensor (the convolutions' biases, whose
     gradient through BatchNorm is 0, within VGG_TP_BIAS_ATOL), beside
     the same readings of the one-rank step on cuDNN's other algorithms,
     the later losses within
     VGG_TP_TRAJ_RTOL, no port
     kernel launched; the ``vgg-tp`` line prints ms a step and the
     staged collectives' share.  The same two ranks then run 13c,
     ResNet-50 at ImageNet geometry (224, 1,000 classes) under
     ``vgg_tp_rules`` (``TPResNet``: its convolutions' output channels
     split, ``stem_bn`` and ``proj_bn`` whole on the gathered
     activations), float32, TF32 off, deterministic cuDNN, global batch
     RESNET_TP_BATCH, RESNET_TP_STEPS steps: the first loss within
     RESNET_TP_RTOL of the one-rank step's, the later ones within
     RESNET_TP_TRAJ_RTOL, the first update within RESNET_TP_UPDATE_REL of
     its norm, no port kernel launched; 13d, ViT-B/14 at 224 under
     ``gpt2_tp_rules`` (``TPViT``: 6 heads a rank), bf16, flash, global
     batch VIT_TP_BATCH, VIT_TP_STEPS steps: K1-K3 launch 12 times a step
     on each rank and the losses are within VIT_LOSS_RTOL of the
     one-rank ViT's; 13e, GPT-2 small (phase 11's model and batch) under
     ``vgg_tp_rules``, which split nothing of it: the replicated step
     (the whole model on each rank), one step, its loss within
     STRATEGY_RTOL of the one-rank step's;
  14. (run after phase 13, before the timing phase) 14a, ``train_cli`` at
     GPT-2 small, ``--attn flash --dtype bfloat16``, P14_TRAIN_STEPS
     steps and ``--sample`` P14_SAMPLE: K1-K3 launch 12 a step each
     (counts zeroed just before, read just after) and the sample agrees
     with ``generate()`` on the trained weights; 14b, ``generate_cli``
     at GPT-2 medium (24 x 1,024, 16 heads), float32: ``--beam``
     P14_BEAM, greedy and ``--concurrent`` P14_CONCURRENT, beam width 1
     equal to greedy, the beam's score within P14_SCORE_ATOL of one full
     forward's log-probabilities, every copy agreeing with greedy, ms a
     new token printed; 14c, one paged kernel engine with
     ``decode_fuse`` P14_FUSE: GPT-2 small as the default model, a
     second GPT-2 small (another seed, the same pool) and the GPT-2
     medium (its own pool), tenants ``high`` and three low-priority
     classes routing to the three models, a ``PreemptionStorm`` into
     ``high``: every request agrees with the same traffic on the einsum
     engine, preemptions happen, K4 and K5 launch, ``check_paged`` and
     every pool and index check clean, tokens/s and TTFT p50 a tenant
     printed; 14d, the dense engine at GPT-2 small with
     ``prefix_cache_blocks`` on shared-prefix traffic agrees with the
     engine without it, hits, and prints the prefill ms saved; 14e,
     ``paged_attn='gather'`` agrees with ``'einsum'`` on phase 4's
     traffic and launches no kernel.  14a's K1-K3 and 14c's K4/K5
     launches join the timing records' counts;
  15. (run after phase 14, before the timing phase) disaggregated
     serving and the obs layer, at GPT-2 small's full width (float32,
     phase 4's paged kernel engines, ``decode_fuse`` FUSE).  15a,
     ``DisaggCluster`` of a prefill engine and two decode engines: 12
     greedy requests of 17-300 prompt tokens (``p15_prompts``), P15_NEW
     new tokens each, handed off after their first token; a dropped and
     a corrupt transfer (one round each: the first two of the prefill
     host's), a ``SlowLink`` on decode host 1's transfers, a
     ``rebalance`` once P15_HANDOFFS requests were handed off, a
     ``kill_host`` of decode host 2 while it decodes, then a
     ``BitFlipLogits`` canary on host 1 that quarantines it and
     evacuates its live requests from the journal: every request must
     agree with one colocated kernel engine and with the einsum engine
     on the same traffic under phase 4's near-tie rule, ``check()`` must
     be clean, every fault must fire, both decode hosts must launch K4
     and K5 (their requests all came in as tickets); ``15a cluster``
     lines print tickets, pages and MB moved, the median export, pack
     and admit ms a ticket, and tokens/s beside the colocated engine's.
     15b, LLaMA-GQA over int8 pools at phase 4c's geometry: a request
     exported mid-stream, through ``pack_batch``/``unpack_batch``,
     admitted on a second engine must launch K4-int8 and K5-int8 (no fp
     kernel) over its adopted pages (int8 payloads and float32 scales)
     and agree with its unmigrated run.  15c, two gloo processes sharing
     the card run ``DisaggHost.round`` on 15a's first P15_RANK_PROMPTS
     prompts: rank 0's first transfer is bit-flipped, rank 1 must
     quarantine it and leave a ``flightrec-*transfer_quarantined*.json``,
     and its tokens must agree with 15a's colocated engine.  15d, phase
     4e's greedy traffic in three arms in turns (A B C C B A):
     ``obs=True``, ``obs=False`` (the device counters run in both, as in
     JAX) and ``obs=False`` with the counters stubbed out
     (``counters_off``): tokens identical, tokens/s and wall ms per
     replayed window iteration printed for each arm, the device counters
     equal to the host stats (graph replays included, phase 4e's launch
     gates) and zero in the stubbed arm, the counters' own cost
     (``counters_cost``: a window iteration's counter row in a graph, an
     eager decode step's call), the Chrome trace and the Prometheus text
     read back, and a fault injected into the first fused window
     contained with a flight record whose last spans are
     ``fused_decode`` and ``containment``.
     15a's, 15b's and 15d's K4/K5 launches join the timing records'
     counts;
  16. (run after phase 15, before the timing phase) the robustness
     remainder at GPT-2 small's full width (float32 parameters from
     ``random_params(--seed)``, bf16 flash attention through K1-K3, SGD).
     16a, three gloo ranks sharing the card train data-parallel
     (``allreduce``) under ``ResiliencePolicy(sdc_check_every=2)`` with
     ``Trainer(track_sdc_fingerprint=True)``: global batch 12 (4 a rank)
     x 1024 tokens, 2 epochs of 4 steps over 48 synthetic sequences
     (``ShardedSampler(batch_contiguous=12)``), windows of 2, the
     supervisor's own checkpoints.  A clean run (checks, no detection,
     the ranks' parameters bit-equal), a one-shot ``BitFlipParams`` on
     rank 2 (one detection naming ``p2``, one transient, final parameters
     bit-equal to the clean run's by fingerprint and by bytes), both with
     ``Trainer(verify_replicas=True)`` logging ``replica consistency OK``
     after each epoch; a desync (one epoch, a flip on rank 2 with no SDC
     check: every rank raises ``ReplicaDivergenceError`` naming rank 2)
     and a persistent flip on rank 1 (rank 1 exits 44 and writes the
     marker naming ``p1``, the others raise ``SdcPersistentError``); it
     prints a fingerprint's device ms over the parameters and momentum
     against its byte bound, the gather's wall ms, a replica check's wall
     s, the rollback's restore and replay seconds.  16b, the clean run's
     ``step_1`` resumed on two ranks at 6 rows each through
     ``restore_newest``: epoch 2's window losses agree with the 3-rank
     run's (P16_RELAUNCH_RTOL).  16c, the VGG-11 ladder's CLI
     (``run_part`` at ``--num-devices 2 --verify-replicas``) on two gloo
     CPU ranks, beside 16b and 16d: the all-reduce rung logs ``replica
     consistency OK``, the ``none`` rung raises ``ReplicaDivergenceError``
     naming a leaf, and each rank reads the port's launch counts before
     and after each run: none launched.  16d, one rank,
     ``skip_nonfinite=2`` under a cosine schedule with one non-finite
     step: it is skipped, every step's learning rate equals optax's
     formula at the held-back count, and the parameters after each step
     agree with ``torch.optim.SGD`` stepped at those rates on the applied
     updates (P16_SKIP_TOL).
     16a's (rank 0, clean run), 16b's (rank 0) and 16d's K1-K3 launches
     join the timing records' counts;
  17. (run after phase 16, before the timing phase) the audit's card
     half: each single-process program of
     ``tpudp_torch/analysis/programs.py`` once at its pinned geometry on
     the card (a fused window captured before the counted call): its
     K1-K6 launches, a captured window's replays included, must equal
     the committed lock's ``kernels`` census; ``audit`` lines print
     ``torch.cuda.max_memory_allocated`` beside the lock's CPU
     ``peak_live_bytes`` and the host syncs
     ``torch.cuda.set_sync_debug_mode("warn")`` reports beside the
     lock's ``host_reads`` (printed, not held).  Phases 6 and 7b print
     ``mfu`` lines: the model FLOPs a second of phase 6's GPT-2 step and
     of Part 1's VGG-11 step over the card's dense bf16 peak
     (``tpudp_torch/utils/flops.py``), beside the card's name and power
     limit;
  8. timing — each kernel at its main path's shapes (the paged-window
     kernel at a prefill chunk and at phase 4b's verify window, each
     record tagged with its ``case``; the schedules of both paged
     kernels printed after) against its byte /
     flop bound, its plain version and one PyTorch library call (a
     yardstick the port never calls: ``scaled_dot_product_attention`` on
     the gathered K/V for the paged kernels — dequantized, with the KV
     heads expanded, for the int8 variants at phase 4c's shapes; for the
     tree kernel the
     gathered cache K/V and the window under a boolean mask; its causal
     forward, and its autograd backward — dq, dk and dv in one — for the
     flash kernels), read three ways in the same run: ``ms`` by CUDA
     events around each call submitted to an idle device (the host's
     submission plus the device time: the reading of every earlier run
     and the one the kernel targets are held to), ``device_ms`` by
     events around each call queued behind a device spin (the device
     time alone), and ``host_ms`` by the host's clock around that queued
     call (its submission); the flash kernels then again at 13a's
     ViT-B/14 shape, non-causal (``vit-b-t256`` lines, not in the JSON
     line, which carries the GPT-2 shape's records).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import copy
import contextlib
import dataclasses
import io
import json
import os
import queue
import re
import shutil
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # outside the tensor cores
BF16_FLOP_PER_S = 989e12      # tensor cores, dense
NEW_TOKENS = 32  # per request on the main path
# Phase 4e: the window length and new tokens per request (decode-bound),
# and benchmarks/serve_bench.py's slack on the fused dispatch bound 1/N.
FUSE, FUSE_NEW_TOKENS, FUSED_DISPATCH_EPS = 8, 96, 0.25
# Phase 4f: drafts a verify window, the engines' max_len (the draft's
# history width), new tokens of the LLaMA int8 case and of the
# zero-weight timing (one-chunk prompts, so the fused windows, which run
# once no prompt prefills, take most of its tokens).
SPEC_K, SPEC_MAX_LEN, SPEC_LLAMA_TOKENS, SPEC_TIMING_TOKENS = 4, 512, 16, 256
REPLACES = {
    "paged_decode": "tpudp/ops/paged_attention.py:161",
    "paged_window": "tpudp/ops/paged_attention.py:319",
    "paged_decode_int8": "tpudp/ops/paged_attention.py:161",
    "paged_window_int8": "tpudp/ops/paged_attention.py:319",
    "paged_tree": "tpudp/ops/paged_attention.py:474",
    "flash_fwd": "tpudp/ops/flash_attention.py:65",
    "flash_dq": "tpudp/ops/flash_attention.py:152",
    "flash_dkv": "tpudp/ops/flash_attention.py:192",
}
# The int8 variants are entry points of their fp kernel's source.
SOURCES = {name: f"tpudp_torch/csrc/{name.removesuffix('_int8')}.cu"
           for name in REPLACES}
# LLaMA-GQA at benchmarks/matrix_bench.py's llama_gqa widths.
LLAMA_GQA = dict(vocab_size=32_000, max_seq_len=1024, num_layers=12,
                 d_model=768, num_heads=12, num_kv_heads=3, mlp_hidden=2048)
# Flash checks: name -> (batch, time, heads, head dim); t 1024 is phase
# 10c's training shape, and 6 heads a rank phase 11's tensor-parallel one
# (and 12b's LLaMA-GQA tp rank's; its one rank is gpt2-t1024's shape);
# phase 12a's microbatches are 1 and 2 rows (and 12b's fsdp/zero1 ranks
# 2), 12c's batch 8, 16b's relaunched ranks 6 (16a's ranks take 4);
# 13a's ViT-B/14 at 224 (256 tokens, non-causal in the model: the case
# runs both ways, as every case does), and 13d's tp rank of it.
FLASH_CASES = {"gpt2-t128": (4, 128, 12, 64), "gpt2-t2048": (4, 2048, 12, 64),
               "gpt2-t1024": (4, 1024, 12, 64),
               "gpt2-tp2-t1024": (4, 1024, 6, 64),
               "mpmd-mb1-t1024": (1, 1024, 12, 64),
               "mpmd-mb2-t1024": (2, 1024, 12, 64),
               "gpt2-b8-t1024": (8, 1024, 12, 64),
               "gpt2-b6-t1024": (6, 1024, 12, 64),
               "dh128-t256": (2, 256, 4, 128), "dh32-t256": (2, 256, 4, 32),
               "t200-partial": (1, 200, 3, 64), "t96-clamped": (2, 96, 4, 64),
               "vit-b-t256": (128, 256, 12, 64),
               "vit-b-tp2-t256": (32, 256, 6, 64)}
# The largest error a 64-token tile of a bf16 flash output may have
# relative to the reference's norm there: 3x the largest that sound
# kernels read.  On an H100 the tensor-core kernels read 0.0012-0.0033
# over phase 5's cases (o, dq, dk and dv); a plain model of their
# roundings reads 0.0023-0.0030 on the CPU; a forward that drops one key
# tile from the rows past t/2 at t 2048 reads 0.25.
BF16_TILE_REL_ERR = 1e-2
# The sources whose bf16 kernels run on the tensor cores.
WGMMA_SOURCES = ("flash_fwd", "flash_dq", "flash_dkv")
# A tree of 40 nodes (13 first steps, two continuations each): wider than
# the tree kernel's 32.
WIDE_TREE = (-1,) + (0,) * 13 + tuple(1 + i // 2 for i in range(26))
# Device cycles spun ahead of each call timed on the device clock alone
# (about 1 ms at the H100's clocks), long enough for the host to queue
# the call behind them.
SPIN_CYCLES = 2_000_000
TRAIN_BATCH, TRAIN_T = 4, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
# Phase 7: the reference's global batch; 7a's synthetic sets (20
# iterations, one log window, then the eval); 7b's train set (3 windows:
# the warm-up window and 2 steady ones); 7c's steps and its ranks' limit.
VGG_BATCH, VGG_TRAIN, VGG_TEST = 256, 5_120, 1_024
VGG_BENCH_WINDOWS = 3
VGG_BENCH_TRAIN = VGG_BENCH_WINDOWS * 20 * VGG_BATCH
GLOO_STEPS, GLOO_TIMEOUT = 4, 300
# Phase 9: ResNet-50's global batch, image size, train set, steps a
# dtype and log window; the step alone's repeats; the loader's batches
# (numpy's crop at 224 takes hundreds of ms a batch); ResNet-101's and
# ResNet-152's batch and steps.
RESNET_BATCH, RESNET_SIZE, RESNET_TRAIN = 256, 224, 2048
RESNET_STEPS = {"bfloat16": 30, "float32": 20}
RESNET_LOG_EVERY, RESNET_ALONE_STEPS = 10, 5
RESNET_NUMPY_BATCHES, RESNET_NATIVE_BATCHES = 4, 11
RESNET_DEEP_BATCH, RESNET_DEEP_STEPS = 64, 5
# ResNet-50's logits on the card against the CPU's float32 ones (flax's
# init, train mode, a batch of 4 at 224): relative error norms.  bfloat16
# rounding alone reads 0.0103 at 64x64 on the CPU (its own float32
# against its bfloat16; PERF.md, tests/test_torch_resnet.py); float32
# with TF32 off as tests/test_torch_cuda_resnet.py holds it.
RESNET_CHECK_BATCH = 4
RESNET_RTOL = {"bfloat16": 0.03, "float32": 1e-4}
# 7c's BatchNorm cases: name -> (sync rung, spmd_mode, the model's
# bn_axis): Part 2b --sync-bn and Part 3 --spmd-mode gspmd.
GLOO_BN_CASES = {"part2b --sync-bn": ("allreduce", "shard_map", "data"),
                 "part3 --spmd-mode gspmd": ("auto", "gspmd", None)}
# 7c: SyncBN's first loss against one rank at the global batch, as
# tests/test_sync_bn.py pins it for JAX.
SYNC_BN_RTOL = 1e-6
# 7a's limits on a rung's loss after 20 iterations against Part 1's, at
# world size 1.  The first window (lr 0.1, the loss climbing from 2.3 to
# about 10) magnifies any difference: with cuDNN's default algorithms
# three Part 1 runs on an H100 spread by 1.4% in one run of this script
# and 8.1% in another (7a's first line prints it), as much as a rung's
# own effect could be.  7a so runs the ladder with deterministic cuDNN,
# where every rung but bf16 and int8 error feedback computes Part 1's
# gradients exactly (one-rank collectives and division by 1 are exact):
# any difference beyond float32 rounding is a fault.  int8 error feedback
# moves each update onto a 127-level grid (16.5% from Part 1's loss on an
# H100): it is held at the same limit to a plain loop of error feedback
# on the same batches (plain_ef_loss), which the grid's roundings do not
# separate from it.
VGG_LOSS_RTOL = 1e-5
# Phase 10: Part 1's synthetic sets (10 batches of 256 an epoch, 2 eval
# batches), its epochs, the device call the resumed process stalls (its
# calls start at epoch 2's first batch: the third batch) and the
# watchdog's deadline;
# GPT-2 small trained at 4 x 1024 tokens for 20 steps; the epoch whose
# checkpoint cost is timed (CIFAR-10's 50,000 images).
CKPT_TRAIN, CKPT_TEST, CKPT_EPOCHS = 2_560, 512, 2
CKPT_STALL_CALL, CKPT_STEP_TIMEOUT = 3, 4.0
GPT2_CKPT_BATCH, GPT2_CKPT_T, GPT2_CKPT_STEPS = 4, 1024, 20
EPOCH_IMAGES = 50_000
# Phase 11: GPT-2 small's global batch, tokens, steps a rung, the ranks'
# limit, and the rtol of a rung's losses against the one-rank step's
# (JAX's own, tests/test_tensor_parallel.py:77); the rungs: name ->
# (strategy, mesh, options, model overrides).
STRATEGY_BATCH, STRATEGY_T, STRATEGY_STEPS = 4, 1024, 2
STRATEGY_TIMEOUT, STRATEGY_RTOL = 420, 2e-4
STRATEGY_MOE = dict(mlp_impl="moe", num_experts=4, capacity_factor=4.0,
                    expert_axis="expert")
STRATEGY_RUNGS = {
    "tp": ("tp", {"data": 1, "model": 2}, {}, {}),
    "fsdp": ("fsdp", {"data": 2}, {}, {}),
    "zero1": ("zero1", {"data": 2}, {}, {}),
    "pp-gpipe": ("pp", {"data": 1, "pipe": 2}, {"n_microbatches": 4}, {}),
    "pp-1f1b": ("pp", {"data": 1, "pipe": 2},
                {"n_microbatches": 4, "schedule": "1f1b"}, {}),
    "ep": ("ep", {"data": 1, "expert": 2}, {"aux_loss_coef": 0.0},
           STRATEGY_MOE),
    "sp": ("sp", {"data": 1, "seq": 2}, {},
           {"attn_impl": "ring", "seq_axis": "seq"}),
}
# Phase 12: 12a's global batch and microbatches, its runs (name -> (ranks,
# mesh, interleave)) and their limit, and the limits of its losses
# (relative) and its parameters after the steps (absolute) against the
# one-rank step's, set from the largest differences read on an H100
# (8.7e-8 and 7.5e-9, PERF.md): the losses' about ten times it, the
# parameters' eight float32 steps at LayerNorm's weights of 1.0, so one
# rounding there does not fail the run; 12b's train_cli steps and its
# rungs on two ranks (LLaMA-GQA: 3 KV heads, so tp keeps wk/wv whole);
# 12c's chunk.
MPMD_BATCH, MPMD_MICRO, MPMD_TIMEOUT = 8, 4, 300
MPMD_RTOL, MPMD_ATOL = 1e-6, 1e-6
MPMD_RUNS = {"dp2-pp2-v2": (4, {"data": 2, "pipe": 2}, 2),
             "pp2-v1": (2, {"data": 1, "pipe": 2}, 1)}
LLAMA_CLI_STEPS = 6
LLAMA_RUNGS = {
    "llama-tp": ("tp", {"data": 1, "model": 2}, {}, {}),
    "llama-fsdp": ("fsdp", {"data": 2}, {}, {}),
    "llama-zero1": ("zero1", {"data": 2}, {}, {}),
    "llama-sp": ("sp", {"data": 1, "seq": 2}, {},
                 {"attn_impl": "ring", "seq_axis": "seq"}),
}
RUNG_TABLES = {"gpt2": STRATEGY_RUNGS, "llama": LLAMA_RUNGS}
RUNG_VOCAB = {"gpt2": 50_257, "llama": 32_000}
LOSS_CHUNK = 1024
# Phase 13a: ViT-B/14 at 224 through train_vit (the example's ImageNet
# line: batch 128, AdamW), its steps and log window (the first window
# holds the warm-up), its synthetic set, the batch of the logits check,
# and the bf16 limits of flash against dense: the logits' relative error
# norm (bfloat16 roundings through 12 layers; ResNet-50's bf16 logits
# read 0.005 against the 0.03 of phase 9) and the losses' (phase 6's).
VIT_BATCH, VIT_STEPS, VIT_LOG_EVERY, VIT_TRAIN = 128, 9, 3, 512
VIT_CHECK_BATCH, VIT_LOGIT_REL, VIT_LOSS_RTOL = 16, 3e-2, 2e-2
# Phase 13b: VGG-11 under vgg_tp_rules at data 1 x model 2 (two gloo
# ranks on the card), CIFAR geometry, float32, TF32 off, deterministic
# cuDNN: global batch, steps, the ranks' limit, and the limits against
# the one-rank step on the same batches.  The split convolutions change
# the summation order only (cuDNN picks other algorithms at half the
# output channels), so the first step is held tight: its loss
# (relative) and its update of the parameters and running statistics,
# as the norm of the difference from one rank's update over the norm of
# that update, over all of them (VGG_TP_UPDATE_REL) and tensor by tensor
# (VGG_TP_TENSOR_REL).  A gradient sums up to 262,144 products a
# channel whose signs cancel (BatchNorm's scale: the normalized input
# sums to zero over the batch), so its float32 rounding is large beside
# it: a probe on an H100 read 1.2e-3 at BatchNorm scales, with every
# convolution below that; a fault in a collective's gradient moves an
# update by its own size.  A convolution's bias feeds a BatchNorm, which
# takes the batch mean out: its gradient is 0 in exact arithmetic and
# rounding noise in either run, so its update is held absolutely
# (VGG_TP_BIAS_ATOL; the probe read 2.8e-9).  The one-rank step with
# cuDNN's other algorithms (benchmark mode) is measured the same way,
# as the rounding's own spread.  VGG-11 on random data then magnifies a
# rounding about 30-fold a step (the probe: 7.5e-8, 2.5e-6, 7.9e-5 over
# the three losses; phase 7a documents the same for Part 1), so the
# later losses are held to VGG_TP_TRAJ_RTOL, ten times that reading.
VGG_TP_BATCH, VGG_TP_STEPS, VGG_TP_TIMEOUT = 256, 3, 480
VGG_TP_RTOL, VGG_TP_UPDATE_REL, VGG_TP_TENSOR_REL = 1e-6, 1e-3, 1e-2
VGG_TP_TRAJ_RTOL, VGG_TP_BIAS_ATOL = 1e-3, 1e-7
# 13c-13e in 13b's two ranks: ResNet-50 at 224 under vgg_tp_rules (global
# batch, steps; float32, TF32 off, deterministic cuDNN), held as 13b's
# VGG-11: the split convolutions change the summation order only, so the
# first loss and the first update are held tight, the later loss
# loosely (a rounding grows a step); ViT-B/14 at 224 under gpt2_tp_rules
# (bf16; its losses against the one-rank ViT's at VIT_LOSS_RTOL); GPT-2
# small's replicated step under vgg_tp_rules (phase 11's model, one
# step, at STRATEGY_RTOL).
RESNET_TP_BATCH, RESNET_TP_STEPS = 8, 2
RESNET_TP_RTOL, RESNET_TP_TRAJ_RTOL, RESNET_TP_UPDATE_REL = 1e-5, 1e-3, 1e-3
VIT_TP_BATCH, VIT_TP_STEPS = 32, 2
# Phase 14: 14a's train_cli run (GPT-2 small, t 1024, batch 4) and its
# greedy sample; 14b's new tokens and beam width at GPT-2 medium, and its
# concurrent copies; 14c's tenant engine (slots, pages over two KV
# geometries, window length, the low tier's requests and new tokens, the
# storm's bursts into the high tier at these steps and its new tokens);
# 14d's shared prefix, its tails and the cache's blocks; the limit on a
# beam score against one full forward's log-probabilities.
P14_TRAIN_STEPS, P14_SAMPLE = 4, 32
P14_NEW, P14_BEAM, P14_CONCURRENT = 32, 4, 8
P14_SLOTS, P14_PAGES, P14_FUSE, P14_LOW, P14_LOW_NEW = 8, 1024, 8, 9, 32
P14_STORM_AT, P14_STORM_NEW = (3, 6, 9, 12), 8
P14_PREFIX, P14_TAILS, P14_BLOCKS = 256, 6, 256
P14_SCORE_ATOL = 1e-3
# Phase 15: 15a's requests (phase 4's eight prompts and four more of its
# lengths, 17-300 tokens) and new tokens each (phase 4's); the delay
# SlowLink adds to each of decode host 1's transfers (the rebalance's:
# host 1 sends nothing else), a few ms beside a transfer's; the canary's
# tokens a run (two: a run ends a tick after its prefill, so host 1 dies
# within a few ticks of its arming, while the request it was just handed
# still decodes) and the commit BitFlipLogits flips (canary call 3: the
# second run's second token, so the first run pins the reference); the
# handoffs before the rebalance, the kill and the canary (half the
# requests reach the decode hosts while both live); the ticks or rounds after which a cluster counts as wedged (the prefill
# host takes one 16-token chunk a tick: ~110 for 15a's prompts); 15b's
# new tokens and the source engine's steps before the export (the
# 100-token prompt's 7 chunks, then decode); 15c's prompts and its ranks'
# limit (spawn, import, CUDA init and GPT-2 small's weights a rank).
P15_REQUESTS, P15_NEW = 12, NEW_TOKENS
P15_SLOW_S = 0.005
P15_HANDOFFS = P15_REQUESTS // 2
P15_CANARY_TOKENS, P15_FLIP = 2, (3, None, 3)
P15_MAX_TICKS = 2000
P15_INT8_NEW, P15_INT8_STEPS = 32, 12
P15_RANK_PROMPTS, P15_RANK_LIMIT = 4, 240
# Phase 16: 16a's ranks, global batch, tokens, synthetic sequences (4
# steps an epoch), epochs, log window and check cadence; the one-shot flip
# (step, rank, bit), the persistent one (from step, rank, bit) and the
# desync's one-shot flip with no SDC check (step, rank, bit); 16b's
# ranks and the limit on its losses against the 3-rank run's (the same
# global batches; the all-reduce sums 2 partial gradients for 3, and
# cuBLAS sees 6 rows a rank for 4); 16d's steps and the step made
# non-finite and the limit on its parameters against torch.optim.SGD
# stepped at the same rates (rtol, atol); the limits of the spawned runs
# and of 16c's CLI runs.
P16_RANKS, P16_BATCH, P16_T, P16_SEQS = 3, 12, 1024, 48
P16_EPOCHS, P16_LOG_EVERY, P16_CHECK_EVERY = 2, 2, 2
P16_FLIP, P16_PERSIST, P16_DESYNC = (3, 2, 5), (3, 1, 7), (1, 2, 5)
P16_RELAUNCH_RANKS, P16_RELAUNCH_RTOL = 2, 1e-4
P16_SKIP_STEPS, P16_NAN_STEP, P16_SKIP_TOL = 4, 1, (1e-5, 1e-6)
P16_SDC_TIMEOUT, P16_CLI_TIMEOUT = 420, 240


class SmokeFailure(RuntimeError):
    pass


def hgmma_counts(build) -> dict:
    """HGMMA instructions in the SASS of each built WGMMA_SOURCES library,
    by ``cuobjdump -sass``."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts = {}
    for src in WGMMA_SOURCES:
        sass = subprocess.run([cuobjdump, "-sass",
                               str(build.library_path(src))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts[src] = sum("HGMMA" in line for line in sass.splitlines())
    return counts


def phase_clock():
    """``mark(label)`` prints the seconds since the previous mark and
    since the first, on a ``clock`` line."""
    start = last = time.perf_counter()

    def mark(label: str) -> None:
        nonlocal last
        now = time.perf_counter()
        print(f"clock {label}: {now - last:.1f}s (total {now - start:.1f}s)",
              flush=True)
        last = now

    return mark


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mfu_line(torch, label: str, flops: int, sec: float) -> None:
    """An ``mfu`` line: ``flops`` a step of ``sec`` over the card's dense
    bf16 peak (``tpudp_torch.utils.flops``), beside the card."""
    from tpudp_torch.utils import flops as F

    name = torch.cuda.get_device_name(0)
    got = F.mfu(flops, sec, name)
    print(f"mfu {label}: "
          + ("not measured (no peak for this card)" if got is None else
             f"{got:.4f} of {name}'s dense bf16 peak "
             f"({F.chip_peak_flops(name) / 1e12:.1f} TFLOP/s)")
          + f", {flops / 1e12:.4f} TFLOP a step in {1e3 * sec:.2f} ms; "
          f"{device_line()}", flush=True)


# -- phase 3: kernels vs their plain versions ---------------------------


def fragmented_case(torch, *, b, h, kv, dh, page_tokens, max_pages, cur,
                    scalar_pos, dtype, layers, seed, device, depth=None):
    """A pool and block tables shaped like copy-on-write traffic: slots
    0-3 map the same prefix pages, every slot continues into private
    pages, entries past each slot's window are ``-1`` except for a few
    mapped stale pages, and the pool holds ``layers`` layers (one
    selected by ``layer``, the others noise).  Every entry a query can
    see is mapped, as the engine guarantees.  A scalar depth is drawn
    page-aligned unless ``depth`` gives it."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    t_max = max_pages * page_tokens
    if scalar_pos:
        p0 = int(torch.randint(0, t_max - cur, (1,), generator=g))
        p0 = p0 - p0 % page_tokens if depth is None else depth
        pos = torch.tensor(p0)
        last = torch.full((b,), p0 + cur - 1)
    else:
        pos = torch.randint(0, t_max - cur + 1, (b,), generator=g)
        pos[0] = t_max - cur  # one slot at the table's far end
        last = pos + cur - 1
    n_real = b * (max_pages + 2) + 8
    perm = torch.randperm(n_real, generator=g).tolist()
    shared = [perm.pop() for _ in range(3)]
    table = torch.full((b, max_pages), -1, dtype=torch.int32)
    for s in range(b):
        n_vis = int(last[s]) // page_tokens + 1
        for i in range(n_vis):
            table[s, i] = shared[i] if s < 4 and i < 3 else perm.pop()
        for i in range(n_vis, min(n_vis + 2, max_pages)):
            if s % 2:
                table[s, i] = perm.pop()  # stale mapped page past the edge
    gd = torch.Generator(device=device).manual_seed(seed)
    shape = (layers, n_real + 1, page_tokens, kv, dh)
    k = torch.randn(shape, generator=gd, device=device).to(dtype)
    v = torch.randn(shape, generator=gd, device=device).to(dtype)
    q = torch.randn((b, cur, h, dh), generator=gd, device=device).to(dtype)
    return q, k, v, table.to(device), pos.to(device, torch.int32)


def check_kernels(torch, pa, device) -> list[str]:
    lines = []
    shapes = {"gpt2": dict(h=12, kv=12, dh=64),
              "gqa": dict(h=32, kv=8, dh=128)}
    traffic = {"decode": (1, False), "prefill": (16, True),
               "window3": (3, False)}
    tol = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    failures = []
    for sname, dims in shapes.items():
        for tname, (cur, scalar) in traffic.items():
            for dtype in (torch.float32, torch.bfloat16):
                for layer in (None, 1):
                    q, k, v, table, pos = fragmented_case(
                        torch, b=8, page_tokens=16, max_pages=64, cur=cur,
                        scalar_pos=scalar, dtype=dtype, layers=2,
                        seed=len(lines), device=device, **dims)
                    kk, vv = (k, v) if layer is not None else (k[0], v[0])
                    pages = (kk, vv)
                    got = pa.paged_attention(q, pages, table, pos,
                                             dtype=dtype, impl="kernel",
                                             layer=layer)
                    sl = (k[layer], v[layer]) if layer is not None else pages
                    want = pa._einsum_paged(q, sl, table, pos, dtype=dtype,
                                            grouped=True)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    t = tol[dtype]
                    ok = torch.allclose(got.float(), want.float(), **t)
                    name = (f"{sname} {tname} {str(dtype)[6:]} "
                            f"{'whole-pool' if layer is not None else 'layer'}")
                    lines.append(f"kernel-check {name}: max_abs_err={err:.3e}"
                                 f" atol={t['atol']} rtol={t['rtol']} "
                                 f"{'ok' if ok else 'MISS'}")
                    if not ok:
                        failures.append(name)
    for line in lines:
        print(line, flush=True)
    if failures:
        raise SmokeFailure(f"kernels disagree with the plain version: "
                           f"{failures}")
    return lines


# K5's edges: name -> (query heads, KV heads, head dim, page tokens,
# table pages, window rows, depth).  One slot at a scalar depth given as a
# host int, as the engine's prefill sends it, so the wrapper's schedule
# splits the keys as on the main path.
WINDOW_EDGES = {
    "dh32": (8, 4, 32, 16, 64, 16, 144),
    "rows128": (16, 4, 64, 16, 64, 32, 200),  # 32 positions x 4 heads
    "depth0": (12, 3, 64, 16, 64, 16, 0),
    "depth1000": (12, 12, 64, 16, 64, 16, 1000),
    "page64": (12, 3, 64, 64, 16, 64, 320),   # a 64-row chunk
}


def check_window_edges(torch, pa, device, int8: bool) -> None:
    """K5 (or K5-int8) at the edges of its schedule, WINDOW_EDGES, in
    whole-pool mode against its plain version at phase 3's tolerances,
    in the schedule's row tiles and in the kernel's widest (32 rows, four
    a warp); each case runs twice back to back, so a merge ticket left
    unreset by the first call would show in the second."""
    tol = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    label = "kernel-check int8 edge" if int8 else "kernel-check edge"
    failures = []
    seed = 300 + 100 * int8
    row_cap = pa.ROW_TILE_ROWS
    cases = [(name, dims, dtype, rows)
             for rows in (row_cap, pa.TILE_ROWS)
             for name, dims in WINDOW_EDGES.items()
             for dtype in (torch.float32, torch.bfloat16)]
    try:
        for name, dims, dtype, rows in cases:
            h, kv, dh, page_tokens, max_pages, cur, depth = dims
            pa.ROW_TILE_ROWS = rows
            seed += 1
            q, k, v, table, _ = fragmented_case(
                torch, b=1, h=h, kv=kv, dh=dh, page_tokens=page_tokens,
                max_pages=max_pages, cur=cur, scalar_pos=True,
                dtype=torch.float32 if int8 else dtype, layers=2, seed=seed,
                device=device, depth=depth)
            if int8:
                pages = int8_pool(torch, k, v,
                                  (slice(None), int(table[0, 0]), 0, 0))
                q = q.to(dtype)
            else:
                pages = (k, v)
            sched = pa.window_schedule(1, cur, h, kv, depth + cur,
                                       pa._sm_count(q.device))
            want = pa._einsum_paged(q, tuple(buf[1] for buf in pages),
                                    table, depth, dtype=dtype, grouped=True)
            t = tol[dtype]
            for run in (1, 2):
                got = pa.paged_attention(q, pages, table, depth, dtype=dtype,
                                         impl="kernel", layer=1)
                torch.cuda.synchronize()
                err, ok = compare(torch, got, want, t)
                case = f"{name} {str(dtype)[6:]} rows {rows} run {run}"
                print(f"{label} {case}: row_tile={sched.row_tile} splits="
                      f"{sched.splits} grid={sched.grid} max_abs_err="
                      f"{err:.3e} atol={t['atol']} rtol={t['rtol']} "
                      f"{'ok' if ok else 'MISS'}", flush=True)
                if not ok:
                    failures.append(case)
    finally:
        pa.ROW_TILE_ROWS = row_cap
    if failures:
        raise SmokeFailure(f"the {'int8 ' if int8 else ''}window kernel "
                           f"disagrees with its plain version at its "
                           f"edges: {failures}")


# K4's edges: name -> (query heads, KV heads, head dim, page tokens, table
# pages, per-slot depths); an idle slot (its table row all -1) has depth
# None and attends nothing.  Tile edges, one slot near the capacity of
# 1,024 keys beside one at 0, head dims 32 and 128, groups 1, 4 and 8 (two
# row tiles a KV head), 64-token pages, and an idle slot.
DECODE_EDGES = {
    "tile-edges": (12, 12, 64, 16, 64, (0, 31, 32, 63)),
    "capacity": (12, 3, 64, 16, 64, (1023, 0)),
    "dh32": (16, 2, 32, 16, 64, (100, 317, 5)),
    "dh128": (32, 8, 128, 16, 64, (200, 31, 640)),
    "groups8": (16, 2, 64, 16, 64, (150, 999, 64)),
    "page64": (12, 3, 64, 64, 16, (1000, 63, 64)),
    "idle": (12, 12, 64, 16, 64, (300, None, 50)),
}
# An idle slot's depth: the kernel walks its tiles and finds no page.
IDLE_DEPTH = 40


def decode_edge_case(torch, dims, seed, device):
    """Float32 whole-pool inputs (2 layers) for one DECODE_EDGES case: each
    slot maps distinct pages up to its depth, the idle slot none; returns
    ``q, k, v, table, pos`` and the idle slots."""
    h, kv, dh, page_tokens, max_pages, depths = dims
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_pages = sum(d // page_tokens + 1 for d in depths if d is not None) + 2
    perm = torch.randperm(n_pages, generator=g).tolist()
    table = torch.full((len(depths), max_pages), -1, dtype=torch.int32)
    for s, d in enumerate(depths):
        for i in range(0 if d is None else d // page_tokens + 1):
            table[s, i] = perm.pop()
    gd = torch.Generator(device=device).manual_seed(seed)
    shape = (2, n_pages + 1, page_tokens, kv, dh)
    k = torch.randn(shape, generator=gd, device=device)
    v = torch.randn(shape, generator=gd, device=device)
    q = torch.randn((len(depths), 1, h, dh), generator=gd, device=device)
    pos = torch.tensor([IDLE_DEPTH if d is None else d for d in depths],
                       dtype=torch.int32)
    idle = [s for s, d in enumerate(depths) if d is None]
    return q, k, v, table.to(device), pos.to(device), idle


def check_decode_edges(torch, pa, device) -> None:
    """K4 and K4-int8 at the edges of their schedule, DECODE_EDGES, in
    whole-pool mode against the plain version (zeros for an idle slot)
    at phase 3's tolerances, over float32, bf16 and int8 pools (float32
    and bf16 queries); each case runs twice back to back, so a merge
    ticket left unreset by the first call would show in the second."""
    tol = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    pools = (("fp32", torch.float32), ("bf16", torch.bfloat16),
             ("int8", torch.float32), ("int8", torch.bfloat16))
    failures = []
    seed = 500
    for name, dims in DECODE_EDGES.items():
        for pool, dtype in pools:
            seed += 1
            q, k, v, table, pos, idle = decode_edge_case(torch, dims, seed,
                                                         device)
            if pool == "int8":
                pages = int8_pool(torch, k, v,
                                  (slice(None), int(table[0, 0]), 0, 0))
            else:
                pages = (k.to(dtype), v.to(dtype))
            q = q.to(dtype)
            want = pa._einsum_paged(q, tuple(buf[1] for buf in pages), table,
                                    pos, dtype=dtype, grouped=True)
            want[idle] = 0.0
            t = tol[dtype]
            sched = pa.decode_schedule(q.shape[0], q.shape[2], dims[1],
                                       dims[4] * dims[3],
                                       pa._sm_count(q.device))
            for run in (1, 2):
                got = pa.paged_attention(q, pages, table, pos, dtype=dtype,
                                         impl="kernel", layer=1)
                torch.cuda.synchronize()
                err, ok = compare(torch, got, want, t)
                ok = ok and not got[idle].any()
                case = f"{name} {pool}/{str(dtype)[6:]} run {run}"
                print(f"kernel-check decode edge {case}: row_tile="
                      f"{sched.row_tile} lanes={sched.lanes} splits="
                      f"{sched.splits} grid={sched.grid} max_abs_err="
                      f"{err:.3e} atol={t['atol']} rtol={t['rtol']} "
                      f"{'ok' if ok else 'MISS'}", flush=True)
                if not ok:
                    failures.append(case)
    if failures:
        raise SmokeFailure(f"the decode kernels disagree with their plain "
                           f"version at their edges: {failures}")


def window_views(torch, q, kv, seed):
    """Node queries and window K/V as the tree forward makes them:
    strided views of one ``(b, T+1, (h + 2 kv) dh)`` projection whose
    query part is ``q``."""
    b, t1, h, dh = q.shape
    g = torch.Generator(device=q.device).manual_seed(seed)
    proj = torch.randn((b, t1, (h + 2 * kv) * dh), generator=g,
                       device=q.device).to(q.dtype)
    proj[..., :h * dh] = q.reshape(b, t1, h * dh)
    qv, wk, wv = proj.split([h * dh, kv * dh, kv * dh], dim=-1)
    return (qv.reshape(b, t1, h, dh), wk.reshape(b, t1, kv, dh),
            wv.reshape(b, t1, kv, dh))


def check_tree_kernels(torch, pa, device) -> None:
    """Phase 3b: K6 against ``_tree_plain``.  The fragmented tables map
    every position up to ``pos0 + T``, a superset of the strictly
    visible cache."""
    from tpudp_torch.serve.speculate import TREE_SHAPES, TreeShape

    shapes = {"gpt2": dict(h=12, kv=12, dh=64),
              "gqa": dict(h=32, kv=8, dh=128)}
    tol = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    # 32 nodes, the kernel's widest: 7 first steps, 24 second, 3 each.
    trees = {name: TREE_SHAPES[name]
             for name in ("fork2x2", "fork3+1", "chain4")}
    trees["wide32"] = TreeShape("wide32", (-1,) + (0,) * 7 + tuple(
        1 + i // 3 for i in range(24)))
    failures = []
    seed = 100
    for sname, dims in shapes.items():
        for tree, shape in trees.items():
            anc = shape.ancestors
            for dtype in (torch.float32, torch.bfloat16):
                for layer in (None, 1):
                    seed += 1
                    q, k, v, table, pos0 = fragmented_case(
                        torch, b=8, page_tokens=16, max_pages=64,
                        cur=len(anc), scalar_pos=False, dtype=dtype,
                        layers=2, seed=seed, device=device, **dims)
                    q, wk, wv = window_views(torch, q, dims["kv"], seed)
                    kk, vv = (k, v) if layer is not None else (k[0], v[0])
                    got = pa.tree_paged_attention(q, (kk, vv), table, pos0,
                                                  wk, wv, anc, dtype=dtype,
                                                  layer=layer)
                    want = pa._tree_plain(q, kk, vv, table, pos0, wk, wv,
                                          anc, layer)
                    torch.cuda.synchronize()
                    err, ok = compare(torch, got, want, tol[dtype])
                    t = tol[dtype]
                    name = (f"{sname} {tree} {str(dtype)[6:]} "
                            f"{'whole-pool' if layer is not None else 'layer'}")
                    print(f"kernel-check tree {name}: max_abs_err={err:.3e} "
                          f"atol={t['atol']} rtol={t['rtol']} "
                          f"{'ok' if ok else 'MISS'}", flush=True)
                    if not ok:
                        failures.append(name)
    if failures:
        raise SmokeFailure(f"the tree kernel disagrees with its plain "
                           f"version: {failures}")


def int8_pool(torch, k, v, zero_at):
    """``(k8, v8, k_scale, v_scale)`` from float32 pages by the port's
    quantizer, with the K and V vectors at index ``zero_at`` zeroed
    first (a zero vector keeps scale 1)."""
    from tpudp_torch.models.generate import _quantize_kv

    k, v = k.clone(), v.clone()
    k[zero_at] = 0.0
    v[zero_at] = 0.0
    (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
    return k8, v8, ks, vs


def check_int8_kernels(torch, pa, device) -> None:
    """Phase 3c: the int8 variants of K4 and K5 against their plain
    version on phase 3's fragmented tables."""
    shapes = {"gpt2": dict(h=12, kv=12, dh=64),
              "llama-gqa": dict(h=12, kv=3, dh=64)}
    traffic = {"decode": (1, False), "prefill": (16, True),
               "window3": (3, False)}
    tol = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    failures = []
    seed = 200
    for sname, dims in shapes.items():
        for tname, (cur, scalar) in traffic.items():
            for dtype in (torch.float32, torch.bfloat16):
                for layer in (None, 1):
                    seed += 1
                    q, k, v, table, pos = fragmented_case(
                        torch, b=8, page_tokens=16, max_pages=64, cur=cur,
                        scalar_pos=scalar, dtype=torch.float32, layers=2,
                        seed=seed, device=device, **dims)
                    # A visible all-zero vector: slot 0's first key.
                    zero_at = (slice(None), int(table[0, 0]), 0, 0)
                    pool = int8_pool(torch, k, v, zero_at)
                    q = q.to(dtype)
                    sl = tuple(b[1] for b in pool)
                    pages = pool if layer is not None else sl
                    got = pa.paged_attention(q, pages, table, pos,
                                             dtype=dtype, impl="kernel",
                                             layer=layer)
                    want = pa._einsum_paged(q, sl, table, pos, dtype=dtype,
                                            grouped=True)
                    torch.cuda.synchronize()
                    t = tol[dtype]
                    err, ok = compare(torch, got, want, t)
                    name = (f"{sname} {tname} {str(dtype)[6:]} "
                            f"{'whole-pool' if layer is not None else 'layer'}")
                    print(f"kernel-check int8 {name}: max_abs_err={err:.3e} "
                          f"atol={t['atol']} rtol={t['rtol']} "
                          f"{'ok' if ok else 'MISS'}", flush=True)
                    if not ok:
                        failures.append(name)
    if failures:
        raise SmokeFailure(f"the int8 kernels disagree with their plain "
                           f"version: {failures}")


# -- phase 4: the main path ----------------------------------------------


def make_prompts(np, seed: int, vocab: int):
    """Eight prompts of 17-300 tokens; prompts 0 and 7 share their first
    64 tokens."""
    rng = np.random.default_rng(seed)
    lens = [100, 17, 45, 77, 128, 190, 300, 150]
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32)
               for n in lens]
    prompts[7][:64] = prompts[0][:64]
    return prompts


def drive(eng, done, step_ms: list, windows: list | None = None) -> None:
    """Step ``eng`` until ``done()``.  Of the steps that ran no prefill
    chunk, the wall ms of each single decode step go to ``step_ms`` and,
    with ``windows``, each fused window's wall ms and replays to
    ``windows`` (a step ends in the fetch of its tokens, so its wall time
    holds the host's scheduling and the device's work)."""
    st = eng.stats
    while not done():
        before = (st["decode_steps"], st["prefill_chunks"],
                  st["fused_windows"])
        replays = eng._window.replays if eng._window is not None else 0
        t0 = time.perf_counter()
        eng.step()
        ms = 1e3 * (time.perf_counter() - t0)
        if st["prefill_chunks"] != before[1]:
            continue
        if st["decode_steps"] == before[0] + 1:
            step_ms.append(ms)
        elif windows is not None and st["fused_windows"] == before[2] + 1:
            windows.append((ms, eng._window.replays - replays))


def p50(values) -> float:
    return sorted(values)[len(values) // 2] if values else float("nan")


def serve(torch, Engine, model, prompts, paged_attn, kv_dtype=None):
    """Serve the prompts on one engine: 0-6 at once, 7 (prompt 0's
    prefix) once request 0 has retired; the page bookkeeping is checked
    at both points, outside the timing.  Returns the engine, handles,
    wall seconds of the serving and the wall ms of its single decode
    steps (:func:`drive`)."""
    eng = Engine(model, device="cuda", num_slots=8, prefill_chunk=16,
                 kv_pages=512, paged_attn=paged_attn, kv_dtype=kv_dtype)
    step_ms: list[float] = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(p, NEW_TOKENS) for p in prompts[:7]]
    drive(eng, lambda: handles[0].done, step_ms)
    wall = time.perf_counter() - t0
    eng.check_paged()
    t0 = time.perf_counter()
    handles.append(eng.submit(prompts[7], NEW_TOKENS))
    drive(eng, lambda: not (eng.queue_depth or eng.slots_in_use), step_ms)
    torch.cuda.synchronize()
    wall += time.perf_counter() - t0
    eng.check_paged()
    return eng, handles, wall, step_ms


SERVE_KERNELS = ("paged_decode", "paged_window")  # phase 4's path


def int8_plain_logits(torch, np, model, seq):
    """The last position's logits of ``seq`` prefilled in 16-token
    chunks through a fresh int8 pool on the plain attention, as the plain
    int8 engine prefills."""
    from tpudp_torch.models.generate import Int8Pages, _forward_paged

    dev = model.wte.weight.device
    n_pages = -(-seq.size // 16)
    pool = Int8Pages.zeros(model.config, n_pages + 1, 16, dev)
    table = torch.arange(n_pages, device=dev, dtype=torch.int32)[None]
    active = torch.ones(1, dtype=torch.bool, device=dev)
    padded = np.zeros(n_pages * 16, np.int64)
    padded[:seq.size] = seq
    tokens = torch.as_tensor(padded, device=dev)[None]
    with torch.no_grad():
        for start in range(0, seq.size, 16):
            logits, _ = _forward_paged(model, tokens[:, start:start + 16],
                                       pool, table, start, active)
    return logits[0, (seq.size - 1) % 16]


def agree_with_plain(torch, np, model, prompts, handles, ref, label,
                     kv_dtype=None, against="the plain engine"):
    """Tokens of ``handles`` equal the plain engine's ``ref`` (or those
    of the engine ``against`` names) or differ first where the plain
    logits' top-2 gap is below 1e-3 (a near-tie of the random weights);
    raises otherwise.  Over an int8 pool the gap is read from the plain
    int8 prefill of the sequence."""
    from tpudp_torch.models.generate import KVCache, _forward_cached

    for i, (h, r) in enumerate(zip(handles, ref)):
        if h.tokens == r.tokens:
            continue
        t = next((j for j, (a, b) in enumerate(zip(h.tokens, r.tokens))
                  if a != b), min(len(h.tokens), len(r.tokens)))
        seq = np.concatenate([prompts[i], np.asarray(r.tokens[:t])])
        if kv_dtype == "int8":
            last = int8_plain_logits(torch, np, model, seq)
        else:
            cache = KVCache.zeros(model.config, 1, seq.size, "cuda")
            with torch.no_grad():
                logits, _ = _forward_cached(
                    model, torch.as_tensor(seq, device="cuda")[None].long(),
                    cache, 0)
            last = logits[0, -1]
        top2 = torch.topk(last, 2).values
        gap = float(top2[0] - top2[1])
        print(f"{label} request {i}: first differing token {t}, plain "
              f"top-2 gap {gap:.3e}", flush=True)
        if gap >= 1e-3:
            raise SmokeFailure(f"{label} request {i} diverges at token {t} "
                               f"with a top-2 gap of {gap} (not a near-tie)")
    print(f"{label} tokens agree with {against} "
          f"({sum(h.tokens == r.tokens for h, r in zip(handles, ref))}/"
          f"{len(handles)} identical)", flush=True)


def serve_summary(handles, wall) -> str:
    n_tok = sum(len(h.tokens) for h in handles)
    ttft = sorted(h.token_times[0] - h.submit_time for h in handles)
    return (f"{len(handles)} requests, {n_tok} tokens in {wall:.3f}s = "
            f"{n_tok / wall:.1f} tokens/s, TTFT p50 "
            f"{1e3 * ttft[len(ttft) // 2]:.1f} ms")


def main_path(torch, np, pa, seed: int):
    from tpudp_torch.models import gpt2
    from tpudp_torch.serve import Engine

    cfg = gpt2.GPT2Config()  # GPT-2 small: 12 x 768, 12 heads, 50257
    model = gpt2.build(cfg, seed, "cuda")
    prompts = make_prompts(np, seed, cfg.vocab_size)

    for fn in pa.KERNELS.values():
        fn.launches = 0
    eng, handles, wall, step_ms = serve(torch, Engine, model, prompts, None)
    launches = {name: fn.launches for name, fn in pa.KERNELS.items()}
    if eng.paged_attn != "kernel":
        raise SmokeFailure(f"paged_attn resolved to {eng.paged_attn!r}")
    fallbacks = eng.metrics()["paged_attn"]["fallbacks"]
    if fallbacks:
        raise SmokeFailure(f"the main path fell back on {fallbacks}")
    for name in SERVE_KERNELS:
        if launches[name] == 0:
            raise SmokeFailure(f"kernel {name} never launched on the main "
                               f"path")
    if eng.stats["prefix_hit_tokens"] < 64:
        raise SmokeFailure(f"the shared prefix was not mapped: "
                           f"{dict(eng.stats)}")
    if not all(h.ok and len(h.tokens) == NEW_TOKENS for h in handles):
        raise SmokeFailure("a request did not complete")
    n_tok = sum(len(h.tokens) for h in handles)
    print(f"main-path kernel engine: {serve_summary(handles, wall)}, "
          f"launches {launches}, stats {dict(eng.stats)}", flush=True)
    print(f"main-path kernel engine: host ms per Engine.step (single "
          f"decode steps, p50 of {len(step_ms)}) {p50(step_ms):.3f}",
          flush=True)

    _, ref, ref_wall, _ = serve(torch, Engine, model, prompts, "einsum")
    if any(fn.launches != launches[n] for n, fn in pa.KERNELS.items()):
        raise SmokeFailure("the plain engine launched a kernel")
    print(f"main-path plain engine: {n_tok / ref_wall:.1f} tokens/s",
          flush=True)
    agree_with_plain(torch, np, model, prompts, handles, ref, "main-path")
    profile_decode_step(torch, Engine, model, prompts, "main-path kernel")
    return model, prompts, launches


# -- phase 4b: the speculative main path ----------------------------------


def spec_prompts(np, seed: int, vocab: int, prompts):
    """Four period-4 tiled prompts of 64-256 tokens (the repetitive
    workload of ``benchmarks/serve_bench.py``'s speculation rows) and
    four of phase 4's prompts."""
    rng = np.random.default_rng(seed + 2)
    tiled = [np.tile(rng.integers(0, vocab, size=4), n // 4).astype(np.int32)
             for n in (64, 128, 192, 256)]
    return tiled + [prompts[i] for i in (1, 2, 3, 4)]


def serve_spec(torch, Engine, model, prompts, pa, **kw):
    """Serve all prompts at once (8 greedy requests of NEW_TOKENS) on a
    fresh engine with the kernel counts zeroed just before; returns the
    engine, handles, wall seconds and the counts read just after."""
    eng = Engine(model, device="cuda", num_slots=8, prefill_chunk=16,
                 kv_pages=512, **kw)
    for fn in pa.KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(p, NEW_TOKENS) for p in prompts]
    eng.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in pa.KERNELS.items()}
    eng.check_paged()
    if not all(h.ok and len(h.tokens) == NEW_TOKENS for h in handles):
        raise SmokeFailure("a request did not complete")
    return eng, handles, wall, launches


def spec_main_path(torch, np, pa, model, prompts, seed: int) -> dict:
    """Phase 4b: sequence and tree speculation through the kernels,
    beside the non-speculative kernel and plain engines."""
    from tpudp_torch.serve import Engine, NgramDrafter

    cfg = model.config
    work = spec_prompts(np, seed, cfg.vocab_size, prompts)
    base, base_h, base_wall, _ = serve_spec(torch, Engine, model, work, pa)
    print(f"spec-path non-speculative kernel engine: "
          f"{serve_summary(base_h, base_wall)}", flush=True)
    _, ref, ref_wall, plain_launches = serve_spec(
        torch, Engine, model, work, pa, paged_attn="einsum")
    if any(plain_launches.values()):
        raise SmokeFailure("the plain engine launched a kernel")
    print(f"spec-path plain engine: {serve_summary(ref, ref_wall)}",
          flush=True)
    agree_with_plain(torch, np, model, work, base_h, ref,
                     "spec-path non-speculative")
    runs = {"sequence": dict(speculate_k=4),
            "tree": dict(speculate_k=2, speculate_tree="fork2x2")}
    tree_launches = None
    for label, kw in runs.items():
        eng, handles, wall, launches = serve_spec(
            torch, Engine, model, work, pa,
            drafter=NgramDrafter(max_ngram=3, min_ngram=2), **kw)
        st = eng.stats
        steps = st["verify_steps"] if label == "sequence" else \
            st["tree_verify_steps"]
        print(f"spec-path {label} engine: {serve_summary(handles, wall)}, "
              f"acceptance rate {eng.acceptance_rate}, launches "
              f"{launches}, stats {dict(st)}", flush=True)
        if steps == 0 or st["draft_accepted"] == 0:
            raise SmokeFailure(f"the {label} run verified {steps} windows "
                               f"and accepted {st['draft_accepted']} drafts")
        fallbacks = eng.metrics()["paged_attn"]["fallbacks"]
        if fallbacks:
            raise SmokeFailure(f"the {label} run fell back on {fallbacks}")
        want = {name: 0 for name in pa.KERNELS}
        want.update(paged_decode=cfg.num_layers * st["decode_steps"],
                    paged_window=cfg.num_layers * (
                        st["prefill_chunks"] + st["verify_steps"]),
                    paged_tree=cfg.num_layers * st["tree_verify_steps"])
        if launches != want:
            raise SmokeFailure(f"the {label} run launched {launches}, its "
                               f"steps need {want}")
        agree_with_plain(torch, np, model, work, handles, ref,
                         f"spec-path {label}")
        if label == "tree":
            tree_launches = launches["paged_tree"]
    return {"paged_tree": tree_launches}


# -- phase 4c: the LLaMA main path over int8 pages -------------------------


def first_divergence(a, b) -> int | None:
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def llama_main_path(torch, np, pa, seed: int) -> dict:
    """Phase 4c: LLaMA-GQA served over an int8 pool through the int8
    kernels, beside the plain attention over int8 and the fp kernels
    over an fp32 pool."""
    from tpudp_torch.models import llama
    from tpudp_torch.serve import Engine

    cfg = llama.LlamaConfig(**LLAMA_GQA)
    model = llama.build(cfg, seed, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"llama-path model: {n_params} parameters, "
          f"{4 * n_params / 1e9:.3f} GB in float32", flush=True)
    prompts = make_prompts(np, seed, cfg.vocab_size)
    runs = {}
    for label, paged_attn, kv_dtype in (("int8 kernel", None, "int8"),
                                        ("int8 plain", "einsum", "int8"),
                                        ("fp32 kernel", None, None)):
        for fn in pa.KERNELS.values():
            fn.launches = 0
        eng, handles, wall, step_ms = serve(torch, Engine, model, prompts,
                                            paged_attn, kv_dtype)
        launches = {name: fn.launches for name, fn in pa.KERNELS.items()}
        if not all(h.ok and len(h.tokens) == NEW_TOKENS for h in handles):
            raise SmokeFailure(f"a request of the {label} run did not "
                               f"complete")
        page_bytes = eng.page_pool.page_bytes()
        print(f"llama-path {label} engine: {serve_summary(handles, wall)}, "
              f"page_bytes {page_bytes}, launches {launches}, stats "
              f"{dict(eng.stats)}, paged_attn {eng.metrics()['paged_attn']}, "
              f"host ms per Engine.step (single decode steps, p50 of "
              f"{len(step_ms)}) {p50(step_ms):.3f}", flush=True)
        runs[label] = (eng, handles, launches, page_bytes)
    eng, handles, launches, _ = runs["int8 kernel"]
    st = eng.stats
    want = {name: 0 for name in pa.KERNELS}
    want["paged_decode_int8"] = cfg.num_layers * st["decode_steps"]
    want["paged_window_int8"] = cfg.num_layers * st["prefill_chunks"]
    if eng.paged_attn != "kernel" or launches != want:
        raise SmokeFailure(f"the int8 run ({eng.paged_attn}) launched "
                           f"{launches}, its steps need {want}")
    if any(runs["int8 plain"][2].values()):
        raise SmokeFailure("the plain int8 engine launched a kernel")
    for label, allowed in (("int8 kernel", ["tree_verify_paged"]),
                           ("fp32 kernel", [])):
        fallbacks = runs[label][0].metrics()["paged_attn"]["fallbacks"]
        if fallbacks != allowed:
            raise SmokeFailure(f"the {label} run falls back on {fallbacks}")
    fp_launches = runs["fp32 kernel"][2]
    if not (fp_launches["paged_decode"] and fp_launches["paged_window"]):
        raise SmokeFailure(f"the fp32 run launched {fp_launches}")
    if st["prefix_hit_tokens"] < 64:
        raise SmokeFailure(f"the shared prefix was not mapped: {dict(st)}")
    agree_with_plain(torch, np, model, prompts, handles,
                     runs["int8 plain"][1], "llama-path int8", "int8")
    fp_handles = runs["fp32 kernel"][1]
    same = sum(h.tokens == r.tokens for h, r in zip(handles, fp_handles))
    firsts = [first_divergence(h.tokens, r.tokens)
              for h, r in zip(handles, fp_handles)]
    print(f"llama-path int8 vs fp32 pool: {same}/{len(handles)} requests "
          f"identical, first divergence per request {firsts}; "
          f"page_bytes int8 {runs['int8 kernel'][3]} vs fp32 "
          f"{runs['fp32 kernel'][3]} "
          f"({runs['fp32 kernel'][3] / runs['int8 kernel'][3]:.2f}x tokens "
          f"per byte)", flush=True)
    for label, kv_dtype in (("int8", "int8"), ("fp32", None)):
        profile_decode_step(torch, Engine, model, prompts,
                            f"llama-path {label} kernel", kv_dtype=kv_dtype)
    del model, runs
    torch.cuda.empty_cache()
    return {name: launches[name]
            for name in ("paged_decode_int8", "paged_window_int8")}


# -- phase 4d: shapes the kernels do not take -----------------------------


def routes_path(torch, np, pa, fa, model, prompts, seed: int) -> None:
    """Phase 4d: a head dim and a tree the kernels do not take, served by
    kernel engines whose build-time dispatch sends them to the einsum
    path, and flash attention at head dim 48 routed to the dense math."""
    from tpudp_torch.models import gpt2
    from tpudp_torch.ops import attention
    from tpudp_torch.serve import Engine, NgramDrafter
    from tpudp_torch.serve.engine import PAGED_FAMILIES

    cfg48 = gpt2.GPT2Config(num_layers=2, num_heads=16)  # head dim 48
    model48 = gpt2.build(cfg48, seed, "cuda")
    work = prompts[1:5]
    eng, handles, wall, launches = serve_spec(torch, Engine, model48, work,
                                              pa)
    fallbacks = eng.metrics()["paged_attn"]["fallbacks"]
    print(f"routes head-dim-48 kernel engine: {serve_summary(handles, wall)},"
          f" fallbacks {fallbacks}, launches {launches}", flush=True)
    if (eng.paged_attn != "kernel" or fallbacks != sorted(PAGED_FAMILIES)
            or any(launches.values())):
        raise SmokeFailure(f"the head-dim-48 engine ({eng.paged_attn}) "
                           f"falls back on {fallbacks} and launched "
                           f"{launches}")
    _, ref, _, _ = serve_spec(torch, Engine, model48, work, pa,
                              paged_attn="einsum")
    agree_with_plain(torch, np, model48, work, handles, ref,
                     "routes head-dim-48")
    del model48

    cfg = model.config
    work = spec_prompts(np, seed, cfg.vocab_size, prompts)[:4]
    eng, handles, wall, launches = serve_spec(
        torch, Engine, model, work, pa, speculate_k=2,
        speculate_tree=WIDE_TREE,
        drafter=NgramDrafter(max_ngram=3, min_ngram=2))
    st = eng.stats
    fallbacks = eng.metrics()["paged_attn"]["fallbacks"]
    print(f"routes {len(WIDE_TREE)}-node tree kernel engine: "
          f"{serve_summary(handles, wall)}, fallbacks {fallbacks}, launches "
          f"{launches}, stats {dict(st)}", flush=True)
    want = {name: 0 for name in pa.KERNELS}
    want.update(paged_decode=cfg.num_layers * st["decode_steps"],
                paged_window=cfg.num_layers * (st["prefill_chunks"]
                                               + st["verify_steps"]))
    if (fallbacks != ["tree_verify_paged"] or launches != want
            or st["tree_verify_steps"] == 0):
        raise SmokeFailure(f"the wide-tree engine falls back on {fallbacks},"
                           f" launched {launches} (its steps need {want}) "
                           f"and verified {st['tree_verify_steps']} trees")
    _, ref, _, _ = serve_spec(torch, Engine, model, work, pa,
                              paged_attn="einsum")
    agree_with_plain(torch, np, model, work, handles, ref,
                     f"routes {len(WIDE_TREE)}-node tree")

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((2, 256, 4, 48), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    before = (attention.dense_routes,
              {name: fn.launches for name, fn in fa.KERNELS.items()})
    got = attention.multihead_attention(q, k, v, causal=True, impl="flash",
                                        dtype=torch.bfloat16)
    after = (attention.dense_routes,
             {name: fn.launches for name, fn in fa.KERNELS.items()})
    want = attention.dense_attention(q, k, v, causal=True,
                                     dtype=torch.bfloat16)
    print(f"routes flash head-dim-48: dense routes {before[0]} -> "
          f"{after[0]}, flash launches {after[1]}", flush=True)
    if after != (before[0] + 1, before[1]) or not torch.equal(got, want):
        raise SmokeFailure("flash attention at head dim 48 was not routed "
                           "to the dense math")


# -- phase 4e: fused decode windows (CUDA graphs over K4 and K4-int8) -----


def serve_fused(torch, Engine, model, prompts, pa, fuse, kv_dtype=None,
                sampled=False, **engine_kw):
    """Phase 4's eight prompts at once on a fresh ``decode_fuse=fuse``
    engine, FUSE_NEW_TOKENS each (sampled: temperature 0.8, top-k 40,
    top-p 0.95, request ``i`` seeded ``i``), the kernel counts zeroed
    just before and read just after.  Returns the engine, handles, wall
    seconds, counts, the wall ms of its single decode steps, and for
    each window that ran no prefill chunk its wall ms and replays.
    ``engine_kw`` go to the engine (phase 15d's ``obs``)."""
    eng = Engine(model, device="cuda", num_slots=8, prefill_chunk=16,
                 kv_pages=512, kv_dtype=kv_dtype, decode_fuse=fuse,
                 **engine_kw)
    sampling = (dict(temperature=0.8, top_k=40, top_p=0.95) if sampled
                else {})
    for fn in pa.KERNELS.values():
        fn.launches = 0
    step_ms: list[float] = []
    windows: list[tuple[float, int]] = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(p, FUSE_NEW_TOKENS, seed=i, **sampling)
               for i, p in enumerate(prompts)]
    drive(eng, lambda: not (eng.queue_depth or eng.slots_in_use), step_ms,
          windows)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in pa.KERNELS.items()}
    eng.check_paged()
    if not all(h.ok and len(h.tokens) == FUSE_NEW_TOKENS for h in handles):
        raise SmokeFailure("a request did not complete")
    return eng, handles, wall, launches, step_ms, windows


def check_fused_run(eng, handles, launches, kernel, label) -> None:
    """Phase 4e's gates on a ``decode_fuse=FUSE`` run: every window went
    through the one captured graph, the paged-decode kernel launched once
    a layer per single step, warm-up iteration and replayed iteration,
    host dispatches per decoded token within the fused bound, and no
    decode family on a fallback."""
    st = eng.stats
    m = eng.metrics()
    w = m.get("fused_window")
    layers = eng.config.num_layers
    if not (w and w["graph"] and w["captures"] == 1 and w["replays"]
            and st["fused_windows"]):
        raise SmokeFailure(f"{label}: the windows did not replay a captured "
                           f"graph: {w}, stats {dict(st)}")
    want = layers * (st["decode_steps"] + w["replays"] + 2)
    if launches[kernel] != want:
        raise SmokeFailure(f"{label}: {kernel} launched {launches[kernel]}, "
                           f"{layers} a layer per decode step, warm-up and "
                           f"replayed iteration need {want}")
    decoded = st["tokens"] - len(handles)  # first tokens ride the prefill
    per_token = (st["decode_steps"] + st["fused_windows"]) / decoded
    bound = (1 / FUSE) * (1 + FUSED_DISPATCH_EPS)
    fallbacks = m["paged_attn"]["fallbacks"]
    print(f"{label}: {st['fused_windows']} windows, {st['fused_steps']} "
          f"fused steps, {w['replays']} replays of {w['captures']} captured "
          f"graph, {st['decode_steps']} single decode steps; host dispatches "
          f"per decoded token {per_token:.4f} (bound {bound:.4f}); "
          f"{kernel} launches {launches[kernel]} = {layers} x (decode "
          f"steps + replays + 2 warm-up); fallbacks {fallbacks}", flush=True)
    if per_token > bound:
        raise SmokeFailure(f"{label}: {per_token:.4f} host dispatches per "
                           f"decoded token, over {bound:.4f}")
    if {"decode_paged", "fused_decode_paged"} & set(fallbacks):
        raise SmokeFailure(f"{label}: decode falls back on {fallbacks}")


def fused_summary(handles, wall, step_ms, windows) -> str:
    iters = sum(r for _, r in windows)
    return (f"{serve_summary(handles, wall)}; single decode steps p50 "
            f"{p50(step_ms):.3f} ms ({len(step_ms)}); windows without a "
            f"prefill chunk p50 {p50([ms for ms, _ in windows]):.3f} ms "
            f"({len(windows)}), "
            + (f"{sum(ms for ms, _ in windows) / iters:.3f} ms per replayed "
               f"iteration" if iters else "no replayed iteration"))


def fused_path(torch, np, pa, model, prompts, seed: int) -> dict:
    """Phase 4e: GPT-2 small over an fp32 pool (K4) and LLaMA-GQA over an
    int8 pool (K4-int8), greedy, then GPT-2 sampled, each run with
    ``decode_fuse=FUSE`` and 1 in turns (fused, single);
    a profiled window of each model.  Returns the fused runs'
    paged-decode launches."""
    from tpudp_torch.models import llama
    from tpudp_torch.serve import Engine

    launched = {}
    cases = (("gpt2 greedy", model, prompts, None, False),
             ("gpt2 sampled", model, prompts, None, True),
             ("llama int8 greedy", None, None, "int8", False))
    for label, case_model, case_prompts, kv_dtype, sampled in cases:
        if case_model is None:
            cfg = llama.LlamaConfig(**LLAMA_GQA)
            case_model = llama.build(cfg, seed, "cuda")
            case_prompts = make_prompts(np, seed, cfg.vocab_size)
        kernel = "paged_decode_int8" if kv_dtype else "paged_decode"
        runs = {FUSE: [], 1: []}
        for fuse in (FUSE, 1):
            run = serve_fused(torch, Engine, case_model, case_prompts, pa,
                              fuse, kv_dtype, sampled)
            eng, handles, wall, launches, step_ms, windows = run
            print(f"fused-path {label} decode_fuse={fuse} (run "
                  f"{len(runs[fuse]) + 1}): "
                  f"{fused_summary(handles, wall, step_ms, windows)}; "
                  f"stats {dict(eng.stats)}", flush=True)
            runs[fuse].append(run)
        single = runs[1][0][1]
        for eng, handles, _, launches, _, _ in runs[FUSE]:
            check_fused_run(eng, handles, launches, kernel,
                            f"fused-path {label}")
            launched[kernel] = launched.get(kernel, 0) + launches[kernel]
            if sampled:
                same = sum(h.tokens == r.tokens
                           for h, r in zip(handles, single))
                if same != len(handles):
                    raise SmokeFailure(f"fused-path {label}: {same}/"
                                       f"{len(handles)} sampled requests "
                                       f"equal their decode_fuse=1 tokens")
                print(f"fused-path {label} tokens equal decode_fuse=1 "
                      f"({same}/{len(handles)} identical)", flush=True)
            else:
                agree_with_plain(torch, np, case_model, case_prompts,
                                 handles, single, f"fused-path {label}",
                                 kv_dtype, against="decode_fuse=1")
        if not sampled:
            profile_decode_step(torch, Engine, case_model, case_prompts,
                                f"fused-path {label} window",
                                kv_dtype=kv_dtype, decode_fuse=FUSE)
    del case_model
    torch.cuda.empty_cache()
    return launched


# -- phase 4f: fused speculation (a CUDA graph over the draft and K5) -----


def spec_draft(torch, gpt2, vocab: int, seed: int, zero: bool = False):
    """The draft model of ``benchmarks/serve_bench.py``'s fused
    speculation rows for GPT-2 small: a third of its layers, a quarter of
    its width, 64-wide heads, its vocabulary and ``max_seq_len + k``
    positions (random weights from ``seed``, or zeros)."""
    cfg = gpt2.GPT2Config(vocab_size=vocab, max_seq_len=1024 + SPEC_K,
                          num_layers=4, num_heads=3, d_model=192)
    model = gpt2.build(cfg, seed, "cuda")
    if zero:
        zero_weights(torch, model)
    return model


def zero_weights(torch, model):
    """serve_bench's zero-weight trees: every logit is 0, so every argmax
    (draft or target) is token 0 and every draft is accepted."""
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()


def spec_engine(Engine, DraftModelDrafter, model, draft, mode, **kw):
    """A serving engine of phase 4f: ``fused`` (speculation inside the
    window), ``host`` (host-drafted, the referee: one verify window a
    step), ``decode`` (plain fused decode windows) or ``plain`` (the
    plain attention, no speculation).  The drafter's bucket is pinned to
    max_len, the window's history width, in both speculating engines:
    the fused engine's own host-drafted steps (while a prompt prefills)
    then draft on the referee's shapes."""
    common = dict(device="cuda", num_slots=8, prefill_chunk=16,
                  kv_pages=512, max_len=SPEC_MAX_LEN, **kw)
    if mode == "plain":
        return Engine(model, paged_attn="einsum", **common)
    if mode == "decode":
        return Engine(model, decode_fuse=FUSE, **common)
    return Engine(model, speculate_k=SPEC_K,
                  decode_fuse=FUSE if mode == "fused" else 1,
                  drafter=DraftModelDrafter(draft, bucket=SPEC_MAX_LEN),
                  **common)


def count_window_syncs(torch, eng, counts: list) -> None:
    """Count the host syncs inside each of ``eng``'s fused speculation
    windows (``torch.cuda.set_sync_debug_mode``): the window's one fetch
    must be the only one."""
    import warnings

    window = eng._spec_fused_window(eng._mstates[None])
    run = window.run

    def counted(values, steps):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = run(values, steps)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchroniz" in str(w.message) for w in caught))
        return out

    window.run = counted


def spec_run(torch, pa, eng, prompts, new, sampled=False, syncs=None):
    """Serve ``prompts`` at once on ``eng`` (``new`` tokens each; sampled:
    temperature 0.9, top-k 12, request ``i`` seeded ``i``) with the kernel
    counts zeroed just before and read just after; returns the handles,
    wall seconds and counts."""
    sampling = dict(temperature=0.9, top_k=12) if sampled else {}
    if syncs is not None:
        count_window_syncs(torch, eng, syncs)
    for fn in pa.KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(p, new, seed=i, **sampling)
               for i, p in enumerate(prompts)]
    eng.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in pa.KERNELS.items()}
    eng.check_paged()
    if not all(h.ok and len(h.tokens) == new for h in handles):
        raise SmokeFailure("a request did not complete")
    return handles, wall, launches


def check_spec_fused_run(eng, launches, syncs, kernel, label) -> None:
    """Phase 4f's gates on a fused speculation run: one captured graph,
    every window through it with one host sync (its fetch), the verify
    kernel once a layer per prefill chunk, host verify step, warm-up
    iteration and replayed iteration, and no fallback."""
    st = eng.stats
    m = eng.metrics()
    w = m.get("fused_spec_window")
    layers = eng.config.num_layers
    if not (w and w["graph"] and w["captures"] == 1
            and st["fused_spec_windows"]):
        raise SmokeFailure(f"{label}: the windows did not replay one "
                           f"captured graph: {w}, stats {dict(st)}")
    want = layers * (st["prefill_chunks"] + st["verify_steps"]
                     + w["replays"] + 2)
    if launches[kernel] != want or not launches[kernel]:
        raise SmokeFailure(f"{label}: {kernel} launched {launches[kernel]}, "
                           f"{layers} a layer per prefill chunk, verify step, "
                           f"warm-up and replayed iteration need {want}")
    # The first window also captures the graph (torch.cuda.graph
    # synchronizes around a capture).
    if len(syncs) != st["fused_spec_windows"] or set(syncs[1:]) != {1}:
        raise SmokeFailure(f"{label}: host syncs per window {syncs}, one "
                           f"(the fetch) expected for each of "
                           f"{st['fused_spec_windows']} windows after the "
                           f"first")
    fallbacks = m["paged_attn"]["fallbacks"]
    if set(fallbacks) - {"tree_verify_paged"}:
        raise SmokeFailure(f"{label}: falls back on {fallbacks}")
    print(f"{label}: {st['fused_spec_windows']} windows (host syncs in "
          f"each {syncs}: the fetch), {st['fused_spec_steps']} fused "
          f"iterations, {w['replays']} replays of {w['captures']} captured "
          f"graph, {st['verify_steps']} host verify steps, acceptance "
          f"{eng.acceptance_rate:.3f}; {kernel} launches {launches[kernel]} "
          f"= {layers} x (prefill chunks + verify steps + replays + 2 "
          f"warm-up)", flush=True)


def graph_device_ms(torch, fn, n=20, generators=()) -> float:
    """Device ms of ``fn`` captured alone in a CUDA graph (with the
    ``generators`` it draws from registered): events around ``n``
    replays."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    return replay_ms(torch, graph.replay, n)


def replay_ms(torch, replay, n=20) -> float:
    replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def spec_timing(torch, np, pa, gpt2, Engine, DraftModelDrafter, verify_rows,
                model, seed: int) -> None:
    """Phase 4f's timing at serve_bench's zero-weight geometry (acceptance
    1): fused speculation, host-drafted speculation and plain fused
    decode, in turns (A B C); tokens/s, tokens a window, device ms
    per replayed iteration and the shares of its draft, verify forward
    and acceptance."""
    zmodel = copy.deepcopy(model)
    zero_weights(torch, zmodel)
    zdraft = spec_draft(torch, gpt2, model.config.vocab_size, seed + 1,
                        zero=True)
    rng = np.random.default_rng(seed + 3)
    prompts = [rng.integers(0, model.config.vocab_size, size=16)
               .astype(np.int32) for _ in range(8)]
    results = {mode: [] for mode in ("fused", "host", "decode")}
    fused_eng = None
    for mode in ("fused", "host", "decode"):
        eng = spec_engine(Engine, DraftModelDrafter, zmodel, zdraft, mode)
        handles, wall, _ = spec_run(torch, pa, eng, prompts,
                                    SPEC_TIMING_TOKENS)
        st = eng.stats
        decoded = st["tokens"] - len(handles)  # first tokens: the prefill
        windows = st["fused_spec_windows"] or st["fused_windows"]
        per_window = decoded / windows if windows else float("nan")
        results[mode].append(st["tokens"] / wall)
        print(f"spec-timing {mode} (run {len(results[mode])}): "
              f"{serve_summary(handles, wall)}; acceptance "
              f"{eng.acceptance_rate}; windows {windows}, decoded tokens a "
              f"window {per_window:.2f}; host verify steps "
              f"{st['verify_steps']}; stats {dict(st)}", flush=True)
        if mode == "fused":
            if eng.acceptance_rate != 1.0:
                raise SmokeFailure(f"zero weights accepted "
                                   f"{eng.acceptance_rate} of the drafts")
            fused_eng = eng
    window = fused_eng._spec_window
    iter_ms = replay_ms(torch, window.graph.replay)
    draft_ms = graph_device_ms(torch, window.draft)
    # The iteration's other parts, each captured alone on its inputs.
    b = window.inputs
    drafts = window.draft()
    tokens = torch.cat([b["last"][:, None], drafts], dim=1)

    def verify():
        return window.forward(tokens, b["lens"], b["running"], b["table"])

    logits = verify()
    verify_ms = graph_device_ms(torch, verify)
    accept_ms = graph_device_ms(
        torch, lambda: verify_rows(logits, drafts, b["temps"], b["top_k"],
                                   b["top_p"], window.generators),
        generators=window.generators)
    print(f"spec-timing fused window device ms per replayed iteration "
          f"{iter_ms:.4f}: its draft (prefill of {SPEC_MAX_LEN} tokens a "
          f"slot in {window.chunk}-token chunks, {SPEC_K - 1} steps) alone "
          f"{draft_ms:.4f} ({100 * draft_ms / iter_ms:.1f}% of the "
          f"iteration), the target's verify forward alone {verify_ms:.4f} "
          f"({100 * verify_ms / iter_ms:.1f}%), acceptance (verify_rows) "
          f"alone {accept_ms:.4f} ({100 * accept_ms / iter_ms:.1f}%), the "
          f"rest {iter_ms - draft_ms - verify_ms - accept_ms:.4f}",
          flush=True)
    print("spec-timing tokens/s: " + ", ".join(
        f"{mode} {v[0]:.1f}" for mode, v in results.items())
          + f"; fused over host-drafted "
          f"{sum(results['fused']) / sum(results['host']):.2f}x, over fused "
          f"decode {sum(results['fused']) / sum(results['decode']):.2f}x "
          f"(no gain is claimed: a smoke run)", flush=True)
    del zmodel, zdraft, fused_eng, window, logits


def spec_fused_path(torch, np, pa, model, prompts, seed: int) -> dict:
    """Phase 4f: fused speculation on GPT-2 small (K5 inside the graph)
    against the host-drafted and plain engines, greedy and sampled; a
    shorter LLaMA-GQA case over int8 pages (K5-int8); then the zero-weight
    timing.  Returns the fused runs' K5 and K5-int8 launches."""
    from tpudp_torch.models import gpt2, llama
    from tpudp_torch.ops.sampling import verify_rows
    from tpudp_torch.serve import DraftModelDrafter, Engine

    t0 = time.perf_counter()
    cfg = model.config
    draft = spec_draft(torch, gpt2, cfg.vocab_size, seed + 1)
    work = spec_prompts(np, seed, cfg.vocab_size, prompts)
    launched = {}
    runs = {}
    for mode, sampled in (("fused", False), ("host", False),
                          ("plain", False), ("fused", True),
                          ("host", True)):
        eng = spec_engine(Engine, DraftModelDrafter, model, draft, mode)
        syncs = [] if mode == "fused" else None
        handles, wall, launches = spec_run(torch, pa, eng, work, NEW_TOKENS,
                                           sampled, syncs)
        label = f"spec-fused-path {mode} {'sampled' if sampled else 'greedy'}"
        print(f"{label}: {serve_summary(handles, wall)}, acceptance "
              f"{eng.acceptance_rate}, launches {launches}, stats "
              f"{dict(eng.stats)}", flush=True)
        if mode == "fused":
            check_spec_fused_run(eng, launches, syncs, "paged_window", label)
            launched["paged_window"] = (launched.get("paged_window", 0)
                                        + launches["paged_window"])
        if mode == "plain" and any(launches.values()):
            raise SmokeFailure("the plain engine launched a kernel")
        runs[mode, sampled] = handles
    agree_with_plain(torch, np, model, work, runs["fused", False],
                     runs["plain", False], "spec-fused-path greedy")
    agree_with_plain(torch, np, model, work, runs["fused", False],
                     runs["host", False], "spec-fused-path greedy",
                     against="the host-drafted engine")
    fused, host = runs["fused", True], runs["host", True]
    same = sum(h.tokens == r.tokens and h.draft_accepted == r.draft_accepted
               for h, r in zip(fused, host))
    if same != len(fused):
        raise SmokeFailure(f"spec-fused-path sampled: {same}/{len(fused)} "
                           f"requests equal the host-drafted engine's "
                           f"tokens and acceptance")
    print(f"spec-fused-path sampled tokens and acceptance equal the "
          f"host-drafted engine's ({same}/{len(fused)} identical)",
          flush=True)
    del draft
    # LLaMA-GQA over int8 pages: K5-int8 inside the graph.
    lcfg = llama.LlamaConfig(**LLAMA_GQA)
    lmodel = llama.build(lcfg, seed, "cuda")
    ldraft = spec_draft(torch, gpt2, lcfg.vocab_size, seed + 2)
    lprompts = make_prompts(np, seed, lcfg.vocab_size)[:4]
    lruns = {}
    for mode in ("fused", "host"):
        eng = spec_engine(Engine, DraftModelDrafter, lmodel, ldraft, mode,
                          kv_dtype="int8")
        syncs = [] if mode == "fused" else None
        handles, wall, launches = spec_run(torch, pa, eng, lprompts,
                                           SPEC_LLAMA_TOKENS, syncs=syncs)
        label = f"spec-fused-path llama int8 {mode}"
        print(f"{label}: {serve_summary(handles, wall)}, acceptance "
              f"{eng.acceptance_rate}, launches {launches}", flush=True)
        if mode == "fused":
            check_spec_fused_run(eng, launches, syncs, "paged_window_int8",
                                 label)
            launched["paged_window_int8"] = launches["paged_window_int8"]
        lruns[mode] = handles
    agree_with_plain(torch, np, lmodel, lprompts, lruns["fused"],
                     lruns["host"], "spec-fused-path llama int8", "int8",
                     against="the host-drafted engine")
    del lmodel, ldraft, lruns
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    spec_timing(torch, np, pa, gpt2, Engine, DraftModelDrafter, verify_rows,
                model, seed)
    torch.cuda.empty_cache()
    print(f"spec-fused-path: phase 4f {time.perf_counter() - t0:.1f}s "
          f"(checks {t1 - t0:.1f}s, timing {time.perf_counter() - t1:.1f}s)",
          flush=True)
    return launched


# -- phase 4g: the serving engine's robustness layer ----------------------


def robust_engine(Engine, model, **kw):
    return Engine(model, device="cuda", num_slots=4, prefill_chunk=16,
                  kv_pages=256, max_len=SPEC_MAX_LEN, **kw)


def robust_serve(eng, prompts, new, **kw):
    handles = [eng.submit(p, new, **kw) for p in prompts]
    eng.run_until_complete()
    eng.check_paged()
    return handles


def robustness_path(torch, np, model, prompts, seed: int) -> None:
    """Phase 4g, on GPT-2 small's kernel engine: step faults at a prefill
    and at a fused speculation window (each request requeued once with
    the unfaulted tokens; a second fault gives ERROR), a stalled step
    caught by the watchdog and contained, a deadline, a canary
    quarantine, and drain."""
    from tpudp_torch.models import gpt2
    from tpudp_torch.serve import (DraftModelDrafter, Engine, EngineClosed,
                                   FinishReason)
    from tpudp_torch.serve.faults import (BitFlipLogits, FaultySteps,
                                          SlowSteps)
    from tpudp_torch.utils.watchdog import Watchdog

    t0 = time.perf_counter()
    work = [p[:40] for p in prompts[:4]]
    draft = spec_draft(torch, gpt2, model.config.vocab_size, seed + 1)

    def nth(kind, n, hook, at):
        """Fire ``hook`` (at its set ``at``) at the ``n``-th device call of
        ``kind``."""
        seen = []

        def fire(k, index):
            if k == kind:
                seen.append(index)
                if len(seen) == n:
                    at.add(index)
            hook(k, index)
        return fire

    cases = {"prefill": dict(decode_fuse=FUSE),
             "fused_spec": dict(decode_fuse=FUSE, speculate_k=SPEC_K,
                                drafter=DraftModelDrafter(draft))}
    for kind, kw in cases.items():
        clean = robust_serve(robust_engine(Engine, model, **kw), work, 24)
        hook = FaultySteps(fail_at=set(), kind=kind)
        eng = robust_engine(Engine, model, step_fault_hook=nth(
            kind, 2, hook, hook.fail_at), **kw)
        handles = robust_serve(eng, work, 24)
        st = eng.stats
        requeued = st["requeued"]
        if not (hook.fired and st["step_failures"] == 1 and requeued
                and not st["errors"]):
            raise SmokeFailure(f"robust {kind} fault: fired {hook.fired}, "
                               f"stats {dict(st)}")
        if [h.tokens for h in handles] != [h.tokens for h in clean]:
            raise SmokeFailure(f"robust {kind} fault: the requeued requests' "
                               f"tokens differ from the unfaulted run's")
        # Every call of the kind fails: the requeue is spent, then ERROR.
        always = FaultySteps(fail_at=range(10 ** 4), kind=kind)
        eng2 = robust_engine(Engine, model, step_fault_hook=always, **kw)
        failed = robust_serve(eng2, work[:2], 24)
        if not all(h.finish_reason is FinishReason.ERROR for h in failed):
            raise SmokeFailure(f"robust {kind} second fault: "
                               f"{[h.finish_reason for h in failed]}")
        print(f"robust {kind} fault: {st['step_failures']} contained, "
              f"{requeued} requests requeued once, tokens equal the "
              f"unfaulted run's ({len(handles)}/{len(handles)}); every "
              f"call failing: {[h.finish_reason.value for h in failed]} "
              f"after {eng2.stats['requeued']} requeues", flush=True)
        if kind == "fused_spec" and (
                eng.metrics()["fused_spec_window"]["captures"] != 1):
            raise SmokeFailure("robust fused_spec fault: the window was "
                               "captured again after containment")
    wd = Watchdog(timeout_s=0.5, kill=False, poll_s=0.05).start()
    try:
        stall = SlowSteps(stall_at=set(), delay_s=1.5, kind="decode")
        eng = robust_engine(Engine, model, watchdog=wd, step_timeout_s=0.5,
                            step_fault_hook=nth("decode", 3, stall,
                                                stall.stall_at))
        handles = robust_serve(eng, work[:2], 12)
        if not (stall.fired and eng.stats["step_failures"] >= 1
                and wd.last_hang and all(h.ok for h in handles)):
            raise SmokeFailure(f"robust watchdog: fired {stall.fired}, "
                               f"stats {dict(eng.stats)}")
        print(f"robust watchdog: a {stall.delay_s}s stall in a decode step "
              f"seen in region {wd.last_hang['region']!r} and contained "
              f"({eng.stats['step_failures']} step failures), "
              f"{len(handles)} requests complete", flush=True)
    finally:
        wd.stop()
    eng = robust_engine(Engine, model)
    late = eng.submit(work[0], 200, deadline_s=1.0)
    while len(late.tokens) < 2 and not late.done:
        eng.step()
    time.sleep(1.05)
    eng.run_until_complete()
    if late.finish_reason is not FinishReason.DEADLINE:
        raise SmokeFailure(f"robust deadline: {late.finish_reason}")
    print(f"robust deadline: retired after {len(late.tokens)} tokens",
          flush=True)
    flip = BitFlipLogits([(5, None, 3)], vocab=model.config.vocab_size,
                         canary_only=True)
    eng = robust_engine(Engine, model, canary_every_s=0.0,
                        canary_new_tokens=4, token_fault_hook=flip)
    eng.submit(work[1], 40)
    for _ in range(400):
        if eng.quarantined:
            break
        eng.step()
    if not (eng.quarantined and flip.fired):
        raise SmokeFailure(f"robust canary: not quarantined "
                           f"({eng.metrics().get('canary')})")
    print(f"robust canary: {eng.quarantine_reason}", flush=True)
    eng = robust_engine(Engine, model, decode_fuse=FUSE)
    handles = [eng.submit(p, 12) for p in work]
    eng.step()
    eng.drain()
    try:
        eng.submit(work[0], 2)
        raise SmokeFailure("robust drain: submit after drain() was taken")
    except EngineClosed:
        pass
    if not (eng.closed and all(h.ok for h in handles)):
        raise SmokeFailure("robust drain: work in flight did not finish")
    print(f"robust drain: {len(handles)} requests finished, submit refused; "
          f"phase 4g {time.perf_counter() - t0:.1f}s", flush=True)
    del draft
    torch.cuda.empty_cache()


# -- phase 5: flash kernels vs their plain versions -----------------------


def projection_views(torch, b, t, h, dh, dtype, seed):
    """q, k, v as the model makes them — strided views of one ``(b, t,
    3 h dh)`` projection — and a random ``do``, from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * dh), generator=g, device="cuda")
    qkv = qkv.to(dtype)
    q, k, v = (z.reshape(b, t, h, dh) for z in qkv.chunk(3, dim=-1))
    do = torch.randn((b, t, h, dh), generator=g, device="cuda").to(dtype)
    return qkv, q, k, v, do


def compare(torch, got, want, tol):
    """``(max_abs_err, ok)`` of ``got`` against ``want`` in float32."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err, torch.allclose(got, want, **tol)


def tile_rel_err(torch, got, want, rows=64) -> float:
    """The largest error of a tile of ``rows`` tokens of a ``(b, t, h,
    dh)`` output relative to the reference's size there: the norm of
    ``got - want`` over the tile over the norm of ``want``.  Where the
    rows' values are small (long causal rows at t 2048), an absolute
    tolerance reads a wrong tile as a right one; this does not."""
    got, want = got.float(), want.float()
    err2 = (got - want).square().sum(dim=(0, 2, 3))
    ref2 = want.square().sum(dim=(0, 2, 3))
    tile = torch.arange(got.shape[1], device=got.device) // rows
    n = int(tile[-1]) + 1
    err2, ref2 = (torch.zeros(n, device=got.device).index_add_(0, tile, x)
                  for x in (err2, ref2))
    return (err2 / ref2.clamp_min(1e-30)).sqrt().max().item()


def check_flash_kernels(torch, fa) -> None:
    """K1-K3 against the plain versions on the same inputs; the backward
    kernels take the plain forward's ``o`` and ``lse``, so each kernel is
    held on its own.  Each kernel runs before the plain version of its
    output, so no cached block can hand it the reference's values.  bf16
    outputs are also held to BF16_TILE_REL_ERR by :func:`tile_rel_err`.
    The t = 96 case runs through the public op (128 blocks clamped to 96)
    and its autograd backward as well."""
    fp32 = dict(atol=2e-5, rtol=2e-5)
    tol_fwd = {torch.float32: fp32,
               torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    tol_grad = {torch.float32: dict(atol=1e-4, rtol=1e-4),
                torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    failures = []
    seed = 0
    for cname, (b, t, h, dh) in FLASH_CASES.items():
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                seed += 1
                qkv, q, k, v, do = projection_views(torch, b, t, h, dh,
                                                    dtype, seed)
                got = dict(zip(("o", "lse"),
                               fa.flash_fwd(q, k, v, causal=causal)))
                o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, causal)
                delta = fa._delta(o_ref, do)
                got["dq"] = fa.flash_dq(q, k, v, do, lse_ref, delta,
                                        causal=causal)
                got["dk"], got["dv"] = fa.flash_dkv(q, k, v, do, lse_ref,
                                                    delta, causal=causal)
                ref = {"o": o_ref, "lse": lse_ref,
                       "dq": fa._dq_plain(q, k, v, do, lse_ref, delta,
                                          causal)}
                ref["dk"], ref["dv"] = fa._dkv_plain(q, k, v, do, lse_ref,
                                                     delta, causal)
                tols = {"o": tol_fwd[dtype], "lse": fp32,
                        "dq": tol_grad[dtype], "dk": tol_grad[dtype],
                        "dv": tol_grad[dtype]}
                if cname == "t96-clamped":
                    qkv.requires_grad_(True)
                    q, k, v = (z.reshape(b, t, h, dh)
                               for z in qkv.chunk(3, dim=-1))
                    o = fa.flash_attention(q, k, v, causal=causal)
                    got["public o"] = o
                    grads = torch.autograd.grad(o, (q, k, v), do)
                    for key, g in zip(("dq", "dk", "dv"), grads):
                        got[f"autograd {key}"] = g
                    ref["public o"] = ref["o"]
                    bwd = fa._flash_bwd_plain(q.detach(), k.detach(),
                                              v.detach(), o_ref, lse_ref,
                                              do, causal)
                    for key, r in zip(("dq", "dk", "dv"), bwd):
                        ref[f"autograd {key}"] = r
                        tols[f"autograd {key}"] = tol_grad[dtype]
                    tols["public o"] = tol_fwd[dtype]
                torch.cuda.synchronize()
                name = (f"{cname} {'causal' if causal else 'full'} "
                        f"{str(dtype)[6:]}")
                parts = []
                for key, want in ref.items():
                    err, ok = compare(torch, got[key], want, tols[key])
                    part = f"{key}={err:.3e}"
                    if dtype == torch.bfloat16 and key != "lse":
                        rel = tile_rel_err(torch, got[key], want)
                        ok = ok and rel <= BF16_TILE_REL_ERR
                        part += f" (tile rel {rel:.2e})"
                    parts.append(part + ("" if ok else " MISS"))
                    if not ok:
                        failures.append(f"{name} {key}")
                print(f"flash-check {name}: " + " ".join(parts), flush=True)
    if failures:
        raise SmokeFailure(f"flash kernels disagree with the plain version: "
                           f"{failures}")


# -- phase 6: the training main path --------------------------------------


def step_split_ms(torch, F, model, optimizer, x, y) -> dict:
    """One training step taken piece by piece between CUDA events — the
    body of ``make_train_step`` at ``grad_accum=1`` with no clipping:
    ms of forward plus loss, of backward, of the optimizer update."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    optimizer.zero_grad(set_to_none=True)
    ev[0].record()
    logits = model(x, train=True)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1))
    ev[1].record()
    loss.backward()
    ev[2].record()
    optimizer.step()
    ev[3].record()
    ev[3].synchronize()
    return {part: a.elapsed_time(b) for part, a, b in
            zip(("forward", "backward", "optimizer"), ev, ev[1:])}


def kernel_category(name: str) -> str:
    if "tpudp::" in name:
        return name.split("tpudp::")[1].split("<")[0]  # the port's kernels
    low = name.lower()
    if any(tag in low for tag in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def profile_call(torch, fn, categorize=kernel_category,
                 cpu_top: int = 0) -> dict | None:
    """Device time of one call of ``fn`` by kernel category (ms), the
    largest kernels outside the port's own and the matmuls, the number
    of device kernels and the device's busy share of the call's wall
    time, from ``torch.profiler``; None when the profiler saw no device
    kernel.  ``cpu_top``: also the host operators of the most self CPU
    time (ms), that many."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # Device activity only: GPU-timeline annotations such as
    # "Optimizer.step#SGD.step" span kernels and would count them twice.
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return None
    by_cat: dict[str, float] = {}
    counts: dict[str, int] = {}
    other: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in kernels:
        cat = categorize(e.name)
        ms = e.time_range.elapsed_us() / 1e3
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        counts[cat] = counts.get(cat, 0) + 1
        by_name[e.name[:70]] = by_name.get(e.name[:70], 0.0) + ms
        if cat == "other":
            other[e.name[:70]] = other.get(e.name[:70], 0.0) + ms
    busy_us, edge = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in kernels):
        busy_us += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    top_cpu = {}
    if cpu_top:
        ops = sorted(prof.key_averages(),
                     key=lambda e: -e.self_cpu_time_total)[:cpu_top]
        top_cpu = {e.key[:50]: round(e.self_cpu_time_total / 1e3, 3)
                   for e in ops}
    return {"wall_ms": wall_us / 1e3, "busy_share": busy_us / wall_us,
            "kernels": len(kernels), "counts": counts,
            "top_cpu_ms": top_cpu,
            "device_ms": {k: round(v, 3) for k, v in sorted(
                by_cat.items(), key=lambda kv: -kv[1])},
            "top_other_ms": {k: round(v, 3) for k, v in sorted(
                other.items(), key=lambda kv: -kv[1])[:4]},
            "top_ms": {k: round(v, 3) for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:8]}}


def profile_decode_step(torch, Engine, model, prompts, label, **kw):
    """One scheduler step with all 8 requests decoding (96 new tokens
    each, so none has finished when the last prefill chunk lands), under
    ``torch.profiler``; prints and returns :func:`profile_call`'s dict."""
    eng = Engine(model, device="cuda", num_slots=8, prefill_chunk=16,
                 kv_pages=512, **kw)
    for p in prompts:
        eng.submit(p, 3 * NEW_TOKENS)
    while eng._next_prefill_slot() is not None or eng.queue_depth:
        eng.step()
    eng.step()  # one plain decode step off the clock
    prof = profile_call(torch, eng.step)
    eng.close()
    print(f"{label} decode-step profile (8 slots decoding): "
          + ("profiler saw no device kernel: device time not measured"
             if prof is None else
             f"{prof['wall_ms']:.2f} ms wall, {prof['kernels']} device "
             f"kernels, device busy {100 * prof['busy_share']:.1f}%, device "
             f"ms by kernel {prof['device_ms']}, largest other kernels "
             f"{prof['top_other_ms']}"), flush=True)
    return prof


def train_run(torch, train, gpt2, cfg, seed, batches, kernels) -> dict:
    """Train a fresh ``build(cfg, seed)`` on ``batches``: TRAIN_WARMUP
    steps, then the timed rest; the kernels' launch counts are read right
    after.  Then one step split into forward / backward / optimizer and
    one profiled step, which add launches and updates of their own.
    Returns the per-step losses, the timed steps' wall seconds, the
    run's peak device memory, the counts and the two breakdowns."""
    import torch.nn.functional as F

    model = gpt2.build(cfg, seed, "cuda")
    spec = train.make_optimizer(learning_rate=0.01)
    state = train.init_state(model, spec)
    step = train.make_train_step(model, spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i, (x, y) in enumerate(batches):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, loss = step(state, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    out = {"wall": time.perf_counter() - t0,
           "peak": torch.cuda.max_memory_allocated(),
           "launches": {name: fn.launches for name, fn in kernels.items()},
           "losses": torch.stack(losses).tolist()}
    out["split"] = step_split_ms(torch, F, model, state.optimizer, x, y)
    out["profile"] = profile_call(torch, lambda: step(state, x, y))
    del model, state, step
    torch.cuda.empty_cache()
    return out


def report_run(label: str, run: dict) -> None:
    n_tok = TRAIN_STEPS * TRAIN_BATCH * TRAIN_T
    print(f"main-path {label} training: {TRAIN_WARMUP + TRAIN_STEPS} steps, "
          f"losses {[round(x, 4) for x in run['losses']]}, "
          f"{n_tok / run['wall']:.1f} tokens/s, "
          f"{1e3 * run['wall'] / TRAIN_STEPS:.1f} ms/step, peak "
          f"{run['peak'] / 2**30:.2f} GiB", flush=True)
    split = ", ".join(f"{k} {v:.2f} ms" for k, v in run["split"].items())
    prof = run["profile"]
    prof_text = ("profiler saw no device kernel: device time not measured"
                 if prof is None else
                 f"profiled step {prof['wall_ms']:.1f} ms wall, device busy "
                 f"{100 * prof['busy_share']:.1f}%, device ms by kernel "
                 f"{prof['device_ms']}, largest other kernels "
                 f"{prof['top_other_ms']}")
    print(f"main-path {label} breakdown: {split}; {prof_text}", flush=True)


def train_main_path(torch, np, fa, seed: int) -> dict:
    from tpudp_torch import train
    from tpudp_torch.models import gpt2

    cfg = gpt2.GPT2Config(max_seq_len=TRAIN_T, dtype=torch.bfloat16,
                          attn_impl="flash")  # GPT-2 small widths
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, size=(n_steps, TRAIN_BATCH, TRAIN_T + 1)),
        device="cuda")
    batches = [(tok[:, :-1], tok[:, 1:]) for tok in tokens]

    from tpudp_torch.ops import attention

    for fn in fa.KERNELS.values():
        fn.launches = 0
    routes = attention.dense_routes
    flash = train_run(torch, train, gpt2, cfg, seed, batches, fa.KERNELS)
    launches = flash["launches"]
    if attention.dense_routes != routes:
        raise SmokeFailure(f"{attention.dense_routes - routes} flash calls "
                           f"of the training path went to the dense math")
    for name, n in launches.items():
        if n != cfg.num_layers * n_steps:
            raise SmokeFailure(f"kernel {name} launched {n} times in "
                               f"{n_steps} training steps of "
                               f"{cfg.num_layers} layers")
    report_run("flash", flash)
    print(f"main-path flash launches {launches}", flush=True)
    from tpudp_torch.utils import flops as F

    mfu_line(torch, "6 GPT-2 small flash bf16 train step, b "
             f"{TRAIN_BATCH} x {TRAIN_T}", F.train_step_flops(
                 F.gpt2_fwd_flops(TRAIN_BATCH, TRAIN_T)),
             flash["wall"] / TRAIN_STEPS)

    dense_cfg = gpt2.GPT2Config(max_seq_len=TRAIN_T, dtype=torch.bfloat16,
                                attn_impl="dense")
    for fn in fa.KERNELS.values():
        fn.launches = 0
    dense = train_run(torch, train, gpt2, dense_cfg, seed, batches,
                      fa.KERNELS)
    if any(dense["launches"].values()) or any(
            fn.launches for fn in fa.KERNELS.values()):
        raise SmokeFailure("the dense-attention run launched a flash kernel")
    report_run("dense", dense)
    if not all(np.isfinite(flash["losses"] + dense["losses"])):
        raise SmokeFailure("a training loss is not finite")
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(flash["losses"], dense["losses"]))
    if rel > 2e-2:
        raise SmokeFailure(f"flash and dense training losses differ by "
                           f"{rel:.3e} (rtol 2e-2)")
    print(f"main-path training losses agree with dense attention (max "
          f"relative difference {rel:.3e}, rtol 2e-2)", flush=True)
    return launches


# -- phase 7: the data-parallel VGG-11 ladder -----------------------------


def vgg_forward_macs(cfg, size=32, channels=3, classes=10) -> int:
    """Multiply-adds of one image's forward pass through the VGG of
    ``cfg``, from its layer shapes (3x3 convolutions, then the head)."""
    macs = 0
    for v in cfg:
        if v == "M":
            size //= 2
        else:
            macs += size * size * 9 * channels * int(v)
            channels = int(v)
    return macs + channels * size * size * classes


def vgg_category(name: str) -> str:
    """A device kernel of the VGG step by what it does (by its name)."""
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    # BatchNorm first: cuDNN's own BatchNorm kernels carry "cudnn" too.
    if any(tag in low for tag in ("batch_norm", "batchnorm", "welford",
                                  "bn_")):
        return "batchnorm"
    if any(tag in low for tag in ("conv", "gemm", "xmma", "cutlass", "nvjet",
                                  "dgrad", "wgrad", "fprop", "winograd",
                                  "cudnn")):
        return "conv+matmul"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer"
    if "pool" in low:
        return "maxpool"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def run_quiet(fn):
    """Call ``fn`` with its standard output captured: ``(result, text)``;
    the text is printed if ``fn`` raises."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
    except BaseException:
        print(buf.getvalue(), flush=True)
        raise
    return out, buf.getvalue()


def check_reference_lines(text: str, label: str, windows: int) -> None:
    """The reference's lines, as a Part prints them for one epoch of
    ``windows`` log windows and its eval."""
    wanted = [f"Training loss after {20 * (i + 1)} iterations is "
              for i in range(windows)]
    wanted += [f"Average Pass time in iter {20 * (i + 1)} is "
               for i in range(1, windows)]
    wanted += ["Training time after 1 epoch is ", "Test set: Average loss: "]
    lines = text.splitlines()
    for prefix in wanted:
        if not any(line.startswith(prefix) for line in lines):
            raise SmokeFailure(f"{label}: no line {prefix!r} in its output")


def ef_trainer(argv):
    """The int8 error-feedback rung: the port's Trainer with
    ``compress='int8_ef'`` and ``sync='none'`` over the Parts' data and
    model (the JAX CLI has no compress flag; its Trainer takes one)."""
    from tpudp_torch import cli
    from tpudp_torch.mesh import initialize_distributed, make_mesh
    from tpudp_torch.models import vgg
    from tpudp_torch.trainer import Trainer

    args = cli.build_parser("int8_ef").parse_args(argv)
    initialize_distributed(args.device)  # world size 1 (NCCL on the card)
    train_loader, test_loader = cli.make_loaders(args, 0, 1)
    if train_loader.loader.backend != "native":
        raise SmokeFailure(f"int8_ef: the loader resolved to "
                           f"{train_loader.loader.backend}, not native")
    model = vgg.build(vgg.CONFIGS["VGG11"], args.seed, args.device)
    trainer = Trainer(model, make_mesh(), "none",
                      compress="int8_ef")
    try:
        trainer.fit(train_loader, test_loader)
    finally:
        train_loader.close()
        test_loader.close()
    return trainer


def plain_ef_loss(torch) -> float:
    """The int8 error-feedback rung's loss after 20 iterations from a
    plain loop at world size 1 on the batches, model and SGD of
    ``ef_trainer``: each step's gradients plus the residual, rounded onto
    127 ticks of their largest magnitude, and the residual set to what
    the rounding dropped."""
    import torch.nn.functional as F

    from tpudp_torch import cli
    from tpudp_torch.data import device_place
    from tpudp_torch.models import vgg

    args = cli.build_parser("plain_ef").parse_args(
        vgg_argv(VGG_TRAIN) + ["--prefetch", "0"])
    loader, _ = cli.make_loaders(args, 0, 1, log=lambda line: None)
    place = device_place("cuda")
    model = vgg.build(vgg.CONFIGS["VGG11"], args.seed, "cuda").train()
    params = list(model.parameters())
    opt = torch.optim.SGD(params, lr=0.1, momentum=0.9, weight_decay=1e-4)
    residual = [torch.zeros_like(p) for p in params]
    total = torch.zeros((), device="cuda")
    loader.set_epoch(0)
    for batch in loader:
        images, labels, _ = place(batch)
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(images, train=True), labels.long())
        loss.backward()
        wanted = [p.grad + e for p, e in zip(params, residual)]
        unit = torch.cat([w.reshape(-1) for w in wanted]).abs().max() / 127
        for p, w, e in zip(params, wanted, residual):
            sent = torch.round(w / unit).clamp(-127, 127) * unit
            p.grad.copy_(sent)
            e.copy_(w - sent)
        opt.step()
        total += loss.detach()
    return float(total) / len(loader)


def vgg_ladder():
    """name -> a call of the port's entry point for that rung."""
    from tpudp_torch import cli
    from tpudp_torch.parts import part1, part2a, part2b, part3

    def rung(sync):
        return lambda a: cli.run_part(sync, sync, argv=a)

    return {
        "part1 (none)": part1.main,
        "part2a (coordinator)": part2a.main,
        "part2b (allreduce)": part2b.main,
        "part2b --ring": lambda a: part2b.main(a + ["--ring"]),
        "part2b --bf16-grads": lambda a: part2b.main(a + ["--bf16-grads"]),
        "part2b --int8-grads": lambda a: part2b.main(a + ["--int8-grads"]),
        "part3 (auto, DDP)": part3.main,
        "ring_bidir": rung("ring_bidir"),
        "allreduce_hd": rung("allreduce_hd"),
        "allreduce_a2a": rung("allreduce_a2a"),
        "int8_ef": ef_trainer,
    }


def vgg_argv(train_size: int, dtype: str = "float32") -> list[str]:
    return ["--synthetic-train-size", str(train_size),
            "--synthetic-test-size", str(VGG_TEST), "--dtype", dtype]


def vgg_ladder_path(torch, np) -> dict:
    """7a: every rung once through its entry point at world size 1 over
    NCCL; each window loss finite, the reference's lines printed, and
    every rung but bf16's and int8 error feedback's at Part 1's loss
    after 20 iterations, int8 error feedback at a plain loop's.  Part 1
    runs three times first with cuDNN's default algorithms, which print
    their run-to-run spread; the ladder then runs with deterministic
    cuDNN, so that its gate holds the rungs' own differences."""
    from tpudp_torch.parts import part1

    repeats = []
    for _ in range(3):
        trainer, _ = run_quiet(lambda: part1.main(vgg_argv(VGG_TRAIN)))
        repeats.append(trainer.records[0]["loss"])
    spread = (max(repeats) - min(repeats)) / min(repeats)
    print(f"vgg-ladder part1 x3, cuDNN's default algorithms: losses after "
          f"20 iterations {[repr(x) for x in repeats]} (spread "
          f"{spread:.3e})", flush=True)
    torch.backends.cudnn.deterministic = True
    try:
        return ladder_losses(np)
    finally:
        torch.backends.cudnn.deterministic = False


def ladder_losses(np) -> dict:
    import torch

    t0 = time.perf_counter()
    plain_ef = plain_ef_loss(torch)
    print(f"vgg-ladder plain int8 error feedback: loss after 20 iterations "
          f"{plain_ef!r}, {time.perf_counter() - t0:.1f} s", flush=True)
    losses = {}
    for label, main in vgg_ladder().items():
        t0 = time.perf_counter()
        trainer, text = run_quiet(lambda: main(vgg_argv(VGG_TRAIN)))
        check_reference_lines(text, label, windows=1)
        if label != "int8_ef":  # its Trainer prints no banner
            check_native_banner(text, f"vgg-ladder {label}")
        windows = [r for r in trainer.records if r["kind"] == "train_window"]
        ev = trainer.records[-1]
        if len(windows) != 1 or not all(np.isfinite(
                [r["loss"] for r in windows] + [ev["avg_loss"]])):
            raise SmokeFailure(f"vgg-ladder {label}: windows {windows}, "
                               f"eval {ev}")
        losses[label] = windows[0]["loss"]
        base = losses["part1 (none)"]
        rel = abs(losses[label] - base) / abs(base)
        want, name = ((plain_ef, "the plain loop's") if label == "int8_ef"
                      else (base, "part 1's"))
        err = abs(losses[label] - want) / abs(want)
        print(f"vgg-ladder {label}: loss after 20 iterations "
              f"{losses[label]!r} (part 1 {base!r}, relative difference "
              f"{rel:.3e}"
              + (f"; plain loop {plain_ef!r}, relative difference {err:.3e}"
                 if label == "int8_ef" else "")
              + f"), eval loss {ev['avg_loss']:.4f} accuracy "
              f"{ev['accuracy']:.4f}, {time.perf_counter() - t0:.1f} s",
              flush=True)
        del trainer
        if label != "part2b --bf16-grads" and err > VGG_LOSS_RTOL:
            raise SmokeFailure(f"vgg-ladder {label}: loss after 20 "
                               f"iterations {losses[label]!r} differs from "
                               f"{name} {want!r} by {err:.3e} (rtol "
                               f"{VGG_LOSS_RTOL})")
    return losses


def loader_ms(torch, loader) -> float:
    """ms a batch of ``loader`` alone on this thread (its crop, flip and
    normalize of a batch, then the copy to the card through pinned
    memory), over every batch but the first."""
    from tpudp_torch.data import device_place

    place = device_place("cuda")
    it = iter(loader)
    place(next(it))  # the first batch off the clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for batch in it:
        place(batch)
        n += 1
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def vgg_loaders(backend: str, batches: int):
    """The Parts' train and test loaders on ``backend`` (no prefetch)
    over ``batches`` global batches of train images."""
    from tpudp_torch import cli

    args = cli.build_parser("loader").parse_args(
        vgg_argv(batches * VGG_BATCH)
        + ["--prefetch", "0", "--data-backend", backend])
    return cli.make_loaders(args, 0, 1, log=lambda line: None)


def check_native_batches(np) -> None:
    """7b: the native backend's first 4 train batches and first eval
    batch equal the numpy backend's, byte for byte."""
    pairs = [vgg_loaders(b, 4) for b in ("native", "numpy")]
    if pairs[0][0].backend != "native":
        raise SmokeFailure(f"the native backend resolved to "
                           f"{pairs[0][0].backend}")
    compared = 0
    for (native_ld, numpy_ld), n in zip(zip(*pairs), (4, 1)):
        for got, want, _ in zip(native_ld, numpy_ld, range(n)):
            for a, b in zip(got, want):
                if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                    raise SmokeFailure("a native batch differs from the "
                                       "numpy backend's")
            compared += 1
    print(f"vgg-bench native batches byte-equal to numpy's: {compared} "
          f"(4 train, 1 eval)", flush=True)


def check_native_banner(text: str, label: str) -> None:
    """A Part's banner must say ``'auto'`` resolved to the native backend:
    no quiet numpy run on the card."""
    if "data=native+prefetch" not in text:
        banner = [line for line in text.splitlines() if "data=" in line]
        raise SmokeFailure(f"{label}: the loader did not resolve to the "
                           f"native backend: {banner}")


def vgg_bench_path(torch, np) -> list[dict]:
    """7b: images/s over the steady windows (the warm-up window left out),
    ms per step, peak memory and a profiled step of Parts 1, 2b
    (allreduce, ring) and 3 in float32, and of Part 1 in bfloat16 (7a
    runs every rung's path; the other rungs' bf16 runs measured nothing
    Part 1's does not)."""
    from tpudp_torch.models.vgg import CONFIGS
    from tpudp_torch.parts import part1, part2b, part3

    flop = 6 * vgg_forward_macs(CONFIGS["VGG11"])  # fwd + bwd, 2 a MAC
    for backend in ("numpy", "native"):
        ms = loader_ms(torch, vgg_loaders(backend, 20)[0])
        print(f"vgg-bench loader alone ({backend} augment of {VGG_BATCH} "
              f"32x32 images, then pinned copy to the card): {ms:.3f} ms a "
              f"batch", flush=True)
    check_native_batches(np)
    runs = {"part1": part1.main, "part2b allreduce": part2b.main,
            "part2b ring": lambda a: part2b.main(a + ["--ring"]),
            "part3 ddp": part3.main}
    out = []
    for dtype, peak in (("float32", FP32_FLOP_PER_S),
                        ("bfloat16", BF16_FLOP_PER_S)):
        for label, main in runs.items():
            if dtype == "bfloat16" and label != "part1":
                continue
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trainer, text = run_quiet(lambda: main(vgg_argv(VGG_BENCH_TRAIN,
                                                            dtype)))
            check_reference_lines(text, label, windows=VGG_BENCH_WINDOWS)
            check_native_banner(text, f"vgg-bench {label} {dtype}")
            steady = [r for r in trainer.records
                      if r["kind"] == "train_window" and not r["warmup_window"]]
            if len(steady) != VGG_BENCH_WINDOWS - 1 or not all(
                    np.isfinite([r["loss"] for r in steady])):
                raise SmokeFailure(f"vgg-bench {label} {dtype}: steady "
                                   f"windows {steady}")
            secs = sum(r["sec_per_iter"] for r in steady)
            images_s = len(steady) * VGG_BATCH / secs
            rec = {"run": label, "dtype": dtype, "images_s": images_s,
                   "ms_per_step": 1e3 * secs / len(steady),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "share_of_peak": images_s * flop / peak}
            if label in ("part1", "part3 ddp"):
                rng = np.random.default_rng(0)
                x = torch.as_tensor(rng.normal(size=(VGG_BATCH, 32, 32, 3))
                                    .astype(np.float32), device="cuda")
                y = torch.as_tensor(rng.integers(0, 10, VGG_BATCH),
                                    device="cuda")
                trainer.train_step(trainer.state, x, y)  # off the clock
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    trainer.train_step(trainer.state, x, y)
                torch.cuda.synchronize()
                rec["step_alone_ms"] = 1e3 * (time.perf_counter() - t0) / 20
                rec["profile"] = profile_call(
                    torch, lambda: trainer.train_step(trainer.state, x, y),
                    vgg_category)
            out.append(rec)
            if label == "part1":
                from tpudp_torch.utils import flops as F

                mfu_line(torch, f"7b VGG-11 Part 1 {dtype} train step, "
                         f"batch {VGG_BATCH}", F.train_step_flops(
                             F.vgg_fwd_flops(VGG_BATCH)),
                         rec["ms_per_step"] / 1e3)
            prof = rec.get("profile")
            print(f"vgg-bench {label} {dtype}: {images_s:.1f} images/s over "
                  f"{len(steady)} steady windows of 20 steps at batch "
                  f"{VGG_BATCH}, {rec['ms_per_step']:.3f} ms/step, peak "
                  f"{rec['peak_gib']:.3f} GiB, "
                  f"{100 * rec['share_of_peak']:.2f}% of the {dtype} peak "
                  f"({flop / 1e9:.4f} GFLOP a trained image)"
                  + ("" if "step_alone_ms" not in rec else
                     f"; the step alone on one device batch "
                     f"{rec['step_alone_ms']:.3f} ms")
                  + ("" if prof is None else
                     f"; profiled step {prof['wall_ms']:.2f} ms wall, device "
                     f"busy {100 * prof['busy_share']:.1f}%, host gaps "
                     f"{prof['wall_ms'] * (1 - prof['busy_share']):.2f} ms, "
                     f"{prof['kernels']} device kernels, device ms by kind "
                     f"{prof['device_ms']}, largest other kernels "
                     f"{prof['top_other_ms']}"), flush=True)
            del trainer
            torch.cuda.empty_cache()
    return out


def vgg_backend_ab(np) -> None:
    """7b: Part 1 on the numpy and the native loader in turns (numpy,
    native) in float32 and bfloat16: images/s over the
    steady windows of each run, so that the loader's effect end to end is
    read within one run of this script."""
    from tpudp_torch.parts import part1

    for dtype in ("float32", "bfloat16"):
        rates = {"numpy": [], "native": []}
        for backend in ("numpy", "native"):
            trainer, text = run_quiet(lambda: part1.main(
                vgg_argv(VGG_BENCH_TRAIN, dtype)
                + ["--data-backend", backend]))
            if f"data={backend}+prefetch" not in text:
                raise SmokeFailure(f"vgg-ab part1 {dtype}: no {backend} "
                                   f"banner")
            steady = [r for r in trainer.records if r["kind"] ==
                      "train_window" and not r["warmup_window"]]
            if not all(np.isfinite([r["loss"] for r in steady])):
                raise SmokeFailure(f"vgg-ab part1 {dtype} {backend}: "
                                   f"steady windows {steady}")
            rates[backend].append(len(steady) * VGG_BATCH / sum(
                r["sec_per_iter"] for r in steady))
            del trainer
        print(f"vgg-ab part1 {dtype}, loader backends in turns (numpy, "
              f"native): images/s numpy "
              f"{[round(x, 1) for x in rates['numpy']]}, native "
              f"{[round(x, 1) for x in rates['native']]}; native / numpy "
              f"{sum(rates['native']) / sum(rates['numpy']):.3f}",
              flush=True)


def gloo_batches(np) -> list:
    """7c's GLOO_STEPS global batches ``(images, labels)`` as numpy
    arrays; rank r takes rows ``[r * half, (r + 1) * half)``."""
    rng = np.random.default_rng(1)
    return [(rng.normal(size=(VGG_BATCH, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, VGG_BATCH)) for _ in range(GLOO_STEPS)]


def state_hash(torch, model) -> str:
    """sha256 of a model's parameters and buffers (float32 bytes)."""
    import hashlib

    flat = torch.cat([t.detach().reshape(-1).float() for t in
                      list(model.parameters())
                      + list(model.buffers())]).cpu().numpy()
    return hashlib.sha256(flat.tobytes()).hexdigest()


def one_rank_first_loss(torch, np) -> float:
    """7c's reference: the first loss of VGG-11 (seed 0) trained by one
    rank on the whole first global batch, under deterministic cuDNN —
    what SyncBN's ranks must reproduce (tests/test_sync_bn.py)."""
    from tpudp_torch import train
    from tpudp_torch.models import vgg

    torch.backends.cudnn.deterministic = True
    try:
        model = vgg.build(vgg.CONFIGS["VGG11"], 0, "cuda")
        spec = train.make_optimizer()
        step = train.make_train_step(model, spec)
        x, y = gloo_batches(np)[0]
        _, loss = step(train.init_state(model, spec),
                       torch.as_tensor(x, device="cuda"),
                       torch.as_tensor(y, device="cuda"))
        return float(loss)
    finally:
        torch.backends.cudnn.deterministic = False


def gloo_rank(rank: int, world: int, init_method: str, results) -> None:
    """7c: one of two ranks on the one card, over gloo with CUDA tensors:
    each rung's 4 steps at global batch 256, then the hash of the rank's
    parameters and buffers, its ms per step and the wall ms of each
    step's gradient reduction as the rung runs it (gloo, staged through
    the host): the all-reduce rung's sync call inside the step, timed
    from the end of the backward pass; DDP's bucket all-reduces from the
    first bucket's hook call to the last bucket's completion, overlapping
    the backward pass."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    sys.path.insert(0, ROOT)
    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.models import vgg
    from tpudp_torch.parallel.sync import sync_allreduce

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    out = {"rank": rank}
    comm = []  # (start, end) of each gradient reduction of the step

    def timed_sync(grads, group):
        torch.cuda.synchronize()  # the backward pass's end
        t0 = time.perf_counter()
        reduced = sync_allreduce(grads, group)
        torch.cuda.synchronize()
        comm.append((t0, time.perf_counter()))
        return reduced

    def timed_bucket(state, bucket):
        t0 = time.perf_counter()

        def done(fut):
            comm.append((t0, time.perf_counter()))
            return fut.value()

        return default_hooks.allreduce_hook(state, bucket).then(done)

    try:
        mesh = make_mesh()
        half = VGG_BATCH // world
        batches = [(torch.as_tensor(x[rank * half:(rank + 1) * half],
                                    device="cuda"),
                    torch.as_tensor(y[rank * half:(rank + 1) * half],
                                    device="cuda"))
                   for x, y in gloo_batches(np)]
        for sync in ("allreduce", "auto"):
            model = vgg.build(vgg.CONFIGS["VGG11"], 0, "cuda")
            spec = train.make_optimizer()
            state = train.init_state(model, spec, mesh)
            step = train.make_train_step(
                model, spec, mesh, timed_sync if sync == "allreduce" else sync)
            if sync == "auto":
                step.ddp.register_comm_hook(None, timed_bucket)
            step_ms, losses, comm_ms, buckets = [], [], [], []
            for x, y in batches:
                comm.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, x, y)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                losses.append(float(loss))
                comm_ms.append(1e3 * (max(e for _, e in comm)
                                      - min(b for b, _ in comm)))
                buckets.append(len(comm))
            out[sync] = {"hash": state_hash(torch, model),
                         "losses": losses, "step_ms": step_ms,
                         "comm_ms": comm_ms, "reductions": buckets}
        # Part 2b --sync-bn (the all-reduce rung over a model with
        # cross-rank BatchNorm) and Part 3 --spmd-mode gspmd (DDP with
        # global-batch BatchNorm), under deterministic cuDNN.
        torch.backends.cudnn.deterministic = True
        for case, (sync, mode, axis) in GLOO_BN_CASES.items():
            model = vgg.build(vgg.CONFIGS["VGG11"], 0, "cuda", bn_axis=axis)
            spec = train.make_optimizer()
            state = train.init_state(model, spec, mesh)
            step = train.make_train_step(model, spec, mesh, sync,
                                         spmd_mode=mode)
            losses, step_ms = [], []
            for x, y in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, x, y)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                losses.append(float(loss))
            out[case] = {"hash": state_hash(torch, model), "losses": losses,
                         "step_ms": step_ms}
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        results.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target, args: tuple, limit: float, label: str,
              world: int = 2) -> list:
    """``world`` spawned ranks of ``target(rank, world, init_method,
    *args, results)``; their reports by rank.  Fails when a rank dies,
    reports an error or outlives ``limit`` seconds."""
    import multiprocessing

    from tpudp_torch.mesh import free_port

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=target, args=(r, world, init, *args,
                                              results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = [], time.monotonic() + limit
    try:
        while len(got) < len(procs):
            try:
                got.append(results.get(timeout=1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead or time.monotonic() > deadline:
                    raise SmokeFailure(
                        f"{label}: {len(got)} of {len(procs)} ranks "
                        f"reported (exit codes {dead}, limit {limit} s)"
                    ) from None
        got.sort(key=lambda r: r["rank"])
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    for r in got:
        if "error" in r:
            raise SmokeFailure(f"{label} rank {r['rank']} failed:\n"
                               f"{r['error']}")
    return got


def gloo_two_rank_path(torch, np) -> None:
    """7c: two ranks on the one card over gloo, CUDA tensors: both end
    each rung with bit-equal parameters and buffers, and the BatchNorm
    cases' first loss is one rank's at the global batch."""
    got = run_ranks(gloo_rank, (), GLOO_TIMEOUT, "vgg-gloo")
    what = {"allreduce": ("the all-reduce rung's sync call in the step, "
                          "one all-reduce a gradient", "sync call"),
            "auto": ("DDP's bucket all-reduces, first hook call to last "
                     "completion, overlapping the backward pass", "bucket")}
    for sync in ("allreduce", "auto"):
        a, b = got[0][sync], got[1][sync]
        same = a["hash"] == b["hash"] and a["losses"] == b["losses"]
        steady = sorted(a["comm_ms"][1:])[len(a["comm_ms"][1:]) // 2]
        print(f"vgg-gloo {sync}: 2 ranks on one card over gloo (CUDA "
              f"tensors), {GLOO_STEPS} steps at batch {VGG_BATCH}: losses "
              f"{[round(x, 4) for x in a['losses']]}, ms per step "
              f"{[round(x, 1) for x in a['step_ms']]}, grad all-reduce wall "
              f"ms a step {[round(x, 2) for x in a['comm_ms']]} (rank 1 "
              f"{[round(x, 2) for x in b['comm_ms']]}; median after the "
              f"first step {steady:.2f}; {what[sync][0]}, "
              f"{a['reductions'][-1]} {what[sync][1]}(s) a step; gloo, staged "
              f"through the host), parameters and buffers bit-equal across "
              f"ranks: {same}", flush=True)
        if not same:
            raise SmokeFailure(f"vgg-gloo {sync}: the ranks' parameters or "
                               f"buffers differ after {GLOO_STEPS} steps")
    want = one_rank_first_loss(torch, np)
    for case in GLOO_BN_CASES:
        a, b = got[0][case], got[1][case]
        same = a["hash"] == b["hash"] and a["losses"] == b["losses"]
        err = abs(a["losses"][0] - want) / abs(want)
        print(f"vgg-gloo {case}: 2 ranks on one card over gloo, "
              f"deterministic cuDNN, {GLOO_STEPS} steps at batch "
              f"{VGG_BATCH}: losses {[repr(x) for x in a['losses']]}, ms "
              f"per step {[round(x, 1) for x in a['step_ms']]}; step 1 "
              f"against one rank at the global batch {want!r}: relative "
              f"difference {err:.3e} (rtol {SYNC_BN_RTOL}); parameters and "
              f"buffers bit-equal across ranks: {same}", flush=True)
        if not same:
            raise SmokeFailure(f"vgg-gloo {case}: the ranks' parameters or "
                               f"buffers differ after {GLOO_STEPS} steps")
        if err > SYNC_BN_RTOL:
            raise SmokeFailure(f"vgg-gloo {case}: step 1's loss "
                               f"{a['losses'][0]!r} is {err:.3e} from one "
                               f"rank's at the global batch {want!r}")


def vgg_path(torch, np) -> dict:
    """Phase 7: the ladder (7a), throughput (7b), two gloo ranks (7c)."""
    import torch.distributed as dist

    try:
        losses = vgg_ladder_path(torch, np)
        bench = vgg_bench_path(torch, np)
        vgg_backend_ab(np)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    gloo_two_rank_path(torch, np)
    return {"losses": losses, "bench": bench}


# -- phase 9: ResNet at ImageNet geometry ---------------------------------


def resnet_forward_macs(stage_sizes, size=224, width=64,
                        classes=1000) -> int:
    """Multiply-adds of one image's forward pass through the ResNet of
    ``stage_sizes``, from its layer shapes: the 7x7/2 stem, the 3x3/2
    max-pool's downsampling, each block's three convolutions (the stride
    on the 3x3) and its projection, then the head."""
    size = (size + 2 * 3 - 7) // 2 + 1  # stem, 7x7/2, padding 3
    macs = size * size * 7 * 7 * 3 * width
    size = (size + 2 * 1 - 3) // 2 + 1  # max-pool, 3x3/2, padding 1
    channels = width
    for stage, n in enumerate(stage_sizes):
        features = width * 2 ** stage
        out = 4 * features
        for block in range(n):
            stride = 2 if stage > 0 and block == 0 else 1
            macs += size * size * channels * features  # 1x1
            size_out = (size - 1) // stride + 1
            macs += size_out * size_out * 9 * features * features  # 3x3
            macs += size_out * size_out * features * out  # 1x1
            if block == 0:  # the projection, 1x1 at the stride
                macs += size_out * size_out * channels * out
            size, channels = size_out, out
    return macs + channels * classes


def resnet_category(name: str) -> str:
    """A device kernel of the ResNet step by what it does: as VGG's, with
    the other reductions (the statistics of the BatchNorm's running
    update, the global pool) apart."""
    kind = vgg_category(name)
    return "reduction" if kind == "other" and "reduce" in name.lower() \
        else kind


def resnet_argv(depth: int, dtype: str, batch: int, steps: int,
                train_size: int, log_every: int) -> list[str]:
    return ["--depth", str(depth), "--dtype", dtype, "--batch-size",
            str(batch), "--steps", str(steps), "--train-size",
            str(train_size), "--log-every", str(log_every)]


def resnet_run(torch, np, argv, label: str) -> dict:
    """``train_resnet.main(argv)`` with its output captured: every loss
    finite, the example's lines printed, the loader on the native
    backend; adds the run's peak device memory."""
    from tpudp_torch import train_resnet

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run, text = run_quiet(lambda: train_resnet.main(argv))
    run["peak"] = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in run["records"]]
    lines = [line for line in text.splitlines()
             if line.startswith("step ") and "images/s" in line]
    if not losses or len(lines) != len(losses) or not all(
            np.isfinite(losses)):
        raise SmokeFailure(f"resnet {label}: losses {losses}, lines "
                           f"{lines}")
    if "data=native" not in text:
        raise SmokeFailure(f"resnet {label}: the loader did not resolve to "
                           f"the native backend")
    return run


def resnet_loader_ms(torch, np) -> None:
    """9: the trainer's loader alone at 224x224, batch 256, both backends
    (numpy over a few batches only)."""
    from tpudp_torch import train_resnet
    from tpudp_torch.data.loader import DataLoader

    for backend, batches in (("numpy", RESNET_NUMPY_BATCHES),
                             ("native", RESNET_NATIVE_BATCHES)):
        ds = train_resnet.synthetic_set(batches * RESNET_BATCH,
                                        RESNET_SIZE, 1000)
        ld = DataLoader(ds, RESNET_BATCH, train=True, seed=0,
                        backend=backend,
                        mean=np.asarray(train_resnet.IMAGENET_MEAN,
                                        np.float32),
                        std=np.asarray(train_resnet.IMAGENET_STD,
                                       np.float32))
        ms = loader_ms(torch, ld)
        print(f"resnet loader alone ({backend} augment of {RESNET_BATCH} "
              f"{RESNET_SIZE}x{RESNET_SIZE} images, then pinned copy to the "
              f"card; {batches - 1} batches timed): {ms:.3f} ms a batch",
              flush=True)


def resnet_against_cpu(torch, np, seed: int) -> None:
    """9: ResNet-50's train-mode logits at 224x224 (flax's init, each
    block's last BatchNorm scale zero) on the card in bfloat16 and in
    float32 against the CPU's float32 logits of the same weights."""
    from tpudp_torch.models import resnet

    x = torch.as_tensor(np.random.default_rng(seed + 1).normal(
        size=(RESNET_CHECK_BATCH, RESNET_SIZE, RESNET_SIZE, 3)).astype(
            np.float32))
    errs = {}
    with torch.no_grad():
        want = resnet.build(50, seed, "cpu")(x, train=True)
        for name, dtype in (("bfloat16", torch.bfloat16),
                            ("float32", torch.float32)):
            model = resnet.build(50, seed, "cuda", dtype=dtype)
            got = model(x.cuda(), train=True).cpu()
            errs[name] = float((got - want).norm() / want.norm())
            del model
    print(f"resnet-50 against the CPU (train-mode logits, batch "
          f"{RESNET_CHECK_BATCH}, {RESNET_SIZE}x{RESNET_SIZE}, flax's init; "
          f"relative error norm against the CPU's float32): {errs}, limits "
          f"{RESNET_RTOL}", flush=True)
    for name, err in errs.items():
        if not err <= RESNET_RTOL[name]:
            raise SmokeFailure(f"resnet-50 {name} logits on the card part "
                               f"from the CPU's by {err}")


def resnet_path(torch, np, seed: int) -> None:
    """Phase 9: its runs in this process, then the world-size-1 process
    group they joined is left."""
    import torch.distributed as dist

    try:
        resnet_runs(torch, np, seed)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.cuda.empty_cache()


def resnet_runs(torch, np, seed: int) -> None:
    """9: ResNet-50 at full width, 224x224, 1000 classes, global batch
    256 through ``train_resnet.main`` in bfloat16 and float32 (images/s
    over the steady windows, ms a step, peak memory, share of the peak,
    the step alone, a profiled step); then ResNet-101 and ResNet-152 for
    a few bf16 steps at batch 64."""
    from tpudp_torch.models import resnet

    resnet_loader_ms(torch, np)
    resnet_against_cpu(torch, np, seed)
    flop = 6 * resnet_forward_macs(resnet.STAGES[50])  # fwd + bwd
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(RESNET_BATCH, RESNET_SIZE,
                                         RESNET_SIZE, 3)).astype(np.float32),
                        device="cuda")
    y = torch.as_tensor(rng.integers(0, 1000, RESNET_BATCH), device="cuda")
    for dtype, peak in (("bfloat16", BF16_FLOP_PER_S),
                        ("float32", FP32_FLOP_PER_S)):
        t0 = time.perf_counter()
        run = resnet_run(torch, np, resnet_argv(
            50, dtype, RESNET_BATCH, RESNET_STEPS[dtype], RESNET_TRAIN,
            RESNET_LOG_EVERY) + ["--seed", str(seed)], f"resnet50 {dtype}")
        wall = time.perf_counter() - t0
        steady = run["records"][1:]  # the warm-up window left out
        secs = sum(r["seconds"] for r in steady)
        steps = RESNET_LOG_EVERY * len(steady)
        images_s = steps * RESNET_BATCH / secs
        step, state = run["step"], run["state"]
        step(state, x, y)  # off the clock
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(RESNET_ALONE_STEPS):
            step(state, x, y)
        torch.cuda.synchronize()
        alone_ms = 1e3 * (time.perf_counter() - t1) / RESNET_ALONE_STEPS
        prof = profile_call(torch, lambda: step(state, x, y),
                            resnet_category)
        print(f"resnet-50 {dtype}: {RESNET_STEPS[dtype]} steps at batch "
              f"{RESNET_BATCH}, {RESNET_SIZE}x{RESNET_SIZE}, 1000 classes, "
              f"window losses {[round(r['loss'], 4) for r in run['records']]}"
              f", {images_s:.1f} images/s over {len(steady)} steady windows "
              f"of {RESNET_LOG_EVERY} steps, {1e3 * secs / steps:.3f} "
              f"ms/step, peak {run['peak'] / 2**30:.3f} GiB, "
              f"{100 * images_s * flop / peak:.2f}% of the {dtype} peak "
              f"({flop / 1e9:.4f} GFLOP a trained image); the step alone on "
              f"one device batch {alone_ms:.3f} ms; "
              + ("profiler saw no device kernel: device time not measured"
                 if prof is None else
                 f"profiled step {prof['wall_ms']:.2f} ms wall, device busy "
                 f"{100 * prof['busy_share']:.1f}%, {prof['kernels']} device "
                 f"kernels, device ms by kind {prof['device_ms']}, largest "
                 f"kernels {prof['top_ms']}")
              + f"; run wall {wall:.1f} s", flush=True)
        del run, step, state
        torch.cuda.empty_cache()
    for depth in (101, 152):
        run = resnet_run(torch, np, resnet_argv(
            depth, "bfloat16", RESNET_DEEP_BATCH, RESNET_DEEP_STEPS,
            RESNET_DEEP_BATCH * RESNET_DEEP_STEPS, 1)
            + ["--seed", str(seed)], f"resnet{depth}")
        ms = sorted(1e3 * r["seconds"] for r in run["records"][1:])
        step, state = run["step"], run["state"]
        xs, ys = x[:RESNET_DEEP_BATCH], y[:RESNET_DEEP_BATCH]
        step(state, xs, ys)  # off the clock
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(RESNET_ALONE_STEPS):
            step(state, xs, ys)
        torch.cuda.synchronize()
        alone_ms = 1e3 * (time.perf_counter() - t1) / RESNET_ALONE_STEPS
        prof = profile_call(torch, lambda: step(state, xs, ys),
                            resnet_category)
        print(f"resnet-{depth} bfloat16: {RESNET_DEEP_STEPS} steps at batch "
              f"{RESNET_DEEP_BATCH}, losses "
              f"{[round(r['loss'], 4) for r in run['records']]} (finite), "
              f"median {ms[len(ms) // 2]:.3f} ms/step after the first, peak "
              f"{run['peak'] / 2**30:.3f} GiB; the step alone on one device "
              f"batch {alone_ms:.3f} ms; "
              + ("profiler saw no device kernel: device time not measured"
                 if prof is None else
                 f"profiled step {prof['wall_ms']:.2f} ms wall, device busy "
                 f"{100 * prof['busy_share']:.1f}%, {prof['kernels']} device "
                 f"kernels, device ms by kind {prof['device_ms']}"),
              flush=True)
        del run, step, state
        torch.cuda.empty_cache()


# -- phase 10: checkpoints, resume, the supervisor, GPT-2 from its checkpoint


def ckpt_argv(root, *extra, train: int = CKPT_TRAIN) -> list[str]:
    """Part 1's flags at phase 10's size, checkpointing under ``root``."""
    return ["--synthetic-train-size", str(train), "--synthetic-test-size",
            str(CKPT_TEST), "--batch-size", str(VGG_BATCH),
            "--checkpoint-dir", str(root), *extra]


def eval_lines(text: str) -> list[str]:
    return [line for line in text.splitlines()
            if line.startswith("Test set:")]


def same_checkpoint(torch, path_a, path_b) -> bool:
    """Two checkpoints hold the same state, bit for bit: params, batch
    statistics, optimizer buffers, step and loss_sum."""
    from tpudp_torch.utils.checkpoint import _flatten, restore_checkpoint

    a = dict(_flatten(restore_checkpoint(path_a, verify=True)))
    b = dict(_flatten(restore_checkpoint(path_b, verify=True)))
    return a.keys() == b.keys() and all(
        torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])) for k in a)


def ckpt_child(argv, timeout: float, stall_call: int = 0):
    """Part 1 in a fresh process with phase 10's deterministic cuDNN (and
    TF32 off, as this script runs); ``stall_call`` stalls that device
    call for the watchdog."""
    code = ("import functools, sys\n"
            "import torch\n"
            "torch.backends.cudnn.deterministic = True\n"
            "torch.backends.cudnn.benchmark = False\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from tpudp_torch import cli\n"
            f"if {stall_call}:\n"
            "    from tpudp_torch.training_faults import StallingStep\n"
            "    cli.Trainer = functools.partial(cli.Trainer, step_fault_hook="
            f"StallingStep({{{stall_call}}}, 600.0))\n"
            "cli.run_part('none', 'Part 1', single_device=True, "
            "argv=sys.argv[1:])\n")
    return subprocess.run([sys.executable, "-c", code] + list(argv),
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def resume_path(torch, tmp: str):
    """10a: Part 1 (VGG-11 at full width) through ``cli.run_part`` under
    deterministic cuDNN.  Run A trains 2 epochs with ``--checkpoint-async
    --keep-checkpoints 1``, which must leave one step_N.  Run B trains 1
    epoch with ``--checkpoint-dir``; a fresh process resumes it from
    step_1 under ``--step-timeout`` and stalls a step of epoch 2, so its
    watchdog dumps the state and it exits 42; the relaunch fast-forwards
    from the dump and must end with A's step_2 bit for bit and A's
    ``Test set:`` line, as must ``--eval-only`` on B's directory.
    Returns run A's Trainer."""
    from tpudp_torch.parts import part1
    from tpudp_torch.utils.checkpoint import read_emergency_sentinel

    t0 = time.perf_counter()
    marks = []

    def mark(label):
        marks.append(f"{label} {time.perf_counter() - t0:.1f}s")

    a, text_a = run_quiet(lambda: part1.main(ckpt_argv(
        f"{tmp}/a", "--epochs", "2", "--checkpoint-async",
        "--keep-checkpoints", "1")))
    mark("A")
    want = eval_lines(text_a)[-1]
    steps = sorted(d for d in os.listdir(f"{tmp}/a") if d.startswith(
        "step_") and not d.endswith(".json"))
    if steps != ["step_2"]:
        raise SmokeFailure(f"ckpt-resume --checkpoint-async "
                           f"--keep-checkpoints 1 left {steps}")
    print("ckpt-resume run A (--checkpoint-async --keep-checkpoints 1) "
          f"leaves ['step_2']: {want.strip()}", flush=True)
    run_quiet(lambda: part1.main(ckpt_argv(f"{tmp}/b")))
    mark("B epoch 1")
    hung = ckpt_child(ckpt_argv(f"{tmp}/b", "--epochs", "2",
                                "--step-timeout", str(CKPT_STEP_TIMEOUT)),
                      300, stall_call=CKPT_STALL_CALL)
    mark("B epoch 2 (child, stalled)")
    resumed = (f"resumed from {tmp}/b/step_1" in hung.stdout
               and "resuming at epoch 1" in hung.stdout)
    sentinel = read_emergency_sentinel(f"{tmp}/b") or {}
    if not resumed or hung.returncode != 42 or \
            "emergency checkpoint saved" not in hung.stdout:
        raise SmokeFailure(f"ckpt-resume: the resumed, stalled process "
                           f"exited {hung.returncode} (resumed from step_1: "
                           f"{resumed}):\n{hung.stdout[-2000:]}"
                           f"{hung.stderr[-2000:]}")
    _, text = run_quiet(lambda: part1.main(ckpt_argv(f"{tmp}/b",
                                                     "--epochs", "2")))
    mark("B relaunch")
    per_epoch = CKPT_TRAIN // VGG_BATCH
    skip = sentinel.get("step", -1) % per_epoch
    line = (f"fast-forwarded {skip} already-trained batches of epoch 1 "
            "(mid-epoch resume)")
    if not skip or line not in text:
        raise SmokeFailure(f"ckpt-resume: no fast-forward after the dump "
                           f"(sentinel {sentinel})")
    if not same_checkpoint(torch, f"{tmp}/a/step_2", f"{tmp}/b/step_2"):
        raise SmokeFailure("ckpt-resume: run B's step_2 differs from run "
                           "A's (parameters, buffers or momentum)")
    if eval_lines(text)[-1] != want:
        raise SmokeFailure(f"ckpt-resume: run B printed "
                           f"{eval_lines(text)[-1]!r}, run A {want!r}")
    print(f"ckpt-resume run B: 1 epoch; a fresh process resumed step_1, "
          f"stalled at its device call {CKPT_STALL_CALL}: watchdog dump at "
          f"step {sentinel['step']}, exit 42; the relaunch printed "
          f"'[tpudp] {line}' and ends bit-equal to run A (parameters, "
          "buffers, momentum, Test set line)", flush=True)
    _, text = run_quiet(lambda: part1.main(ckpt_argv(f"{tmp}/b",
                                                     "--eval-only")))
    if "Training time" in text or eval_lines(text) != [want]:
        raise SmokeFailure(f"ckpt-resume --eval-only printed "
                           f"{eval_lines(text)}, not [{want!r}]")
    mark("eval-only")
    print(f"ckpt-resume --eval-only on run B's directory prints the same "
          f"line and trains nothing ({time.perf_counter() - t0:.1f}s for "
          f"10a; at {marks})", flush=True)
    return a


def model_state(torch, trainer) -> dict:
    """Parameters, buffers and momentum by name."""
    out = {k: v.detach().clone()
           for k, v in trainer.model.state_dict().items()}
    opt = trainer.state.optimizer
    for name, p in trainer.model.named_parameters():
        buf = opt.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out["momentum:" + name] = buf.detach().clone()
    return out


def supervisor_path(torch, tmp: str) -> None:
    """10b: Part 1's Trainer under ``fit(resilience=)`` on the card, with
    a NaN batch, a raising step and a raising loader (one run each):
    every run ends bit-equal to an uninterrupted one, and each counter
    reads one."""
    from tpudp_torch.data import (DataLoader, Prefetcher, ShardedSampler,
                                  device_place, load_cifar10)
    from tpudp_torch.models import vgg
    from tpudp_torch.resilience import ResiliencePolicy
    from tpudp_torch.trainer import Trainer
    from tpudp_torch.training_faults import (CorruptingLoader,
                                             RaisingLoader, RaisingStep)

    train_set, test_set, _ = load_cifar10(
        f"{tmp}/no-data", synthetic_train_size=CKPT_TRAIN,
        synthetic_test_size=CKPT_TEST)

    def run(root, nan_at=(), loader_fail=(), hook=None, supervised=True):
        ld = DataLoader(train_set, VGG_BATCH, sampler=ShardedSampler(
            CKPT_TRAIN, 1, 0, shuffle=True, seed=0), train=True, seed=0)
        if nan_at:
            ld = CorruptingLoader(ld, nan_at=nan_at)
        if loader_fail:
            ld = RaisingLoader(ld, fail_at=loader_fail)
        place = device_place("cuda")
        ld = Prefetcher(ld, depth=2, place=place)
        test = Prefetcher(DataLoader(test_set, VGG_BATCH,
                                     sampler=ShardedSampler(
                                         CKPT_TEST, 1, 0, shuffle=False),
                                     train=False), depth=2, place=place)
        tr = Trainer(vgg.build(vgg.CONFIGS["VGG11"], 0, "cuda"),
                     log_fn=lambda line: None, step_fault_hook=hook)
        try:
            tr.fit(ld, test, CKPT_EPOCHS, resilience=ResiliencePolicy(
                checkpoint_dir=root) if supervised else None)
        finally:
            ld.close()
            test.close()
        return tr

    t0 = time.perf_counter()
    clean = model_state(torch, run(f"{tmp}/sup-clean", supervised=False))
    per_epoch = CKPT_TRAIN // VGG_BATCH  # draws of epoch 1 start here
    cases = {"rollbacks": dict(nan_at={per_epoch + 2}),
             "step_retries": dict(hook=RaisingStep(fail_at={3})),
             "loader_restarts": dict(loader_fail={per_epoch + 1})}
    for counter, kw in cases.items():
        tr = run(f"{tmp}/sup-{counter}", **kw)
        got = model_state(torch, tr)
        counts = {k: tr.stats[k] for k in cases}
        if counts != {k: int(k == counter) for k in cases}:
            raise SmokeFailure(f"ckpt-supervisor {counter}: counters "
                               f"{counts}")
        if got.keys() != clean.keys() or not all(
                torch.equal(got[k], clean[k]) for k in clean):
            raise SmokeFailure(f"ckpt-supervisor {counter}: the recovered "
                               "run differs from the uninterrupted one")
        print(f"ckpt-supervisor {counter}: counters {counts}, events "
              f"{[e['kind'] for e in tr.stats['events']]}; final "
              "parameters, buffers and momentum bit-equal to the "
              "uninterrupted run", flush=True)
    print(f"ckpt-supervisor: {time.perf_counter() - t0:.1f}s for 10b",
          flush=True)


GPT2_SERVE_FLAGS = ["--layers", "12", "--d-model", "768", "--heads", "12",
                    "--vocab", "50257", "--seq-len", str(GPT2_CKPT_T)]


def gpt2_checkpoint_path(torch, np, pa, fa, tmp: str, seed: int):
    """10c: ``train_cli --attn flash --dtype bfloat16 --save-checkpoint``
    trains GPT-2 small through K1-K3 (held against their plain versions
    at this shape in phase 5) and saves it; ``serve_cli
    --checkpoint-dir`` serves it through K4 and K5.  The restored weights
    equal the trained ones bit for bit and serve_cli's tokens agree with
    an engine of the trained model held in memory; serve_cli's tokens,
    and those of phase 4's prompts on a kernel engine of the restored
    model, agree with the plain engine's on the restored model; a
    ``--layers`` that does not match exits with its ``error:`` line.
    Returns the trained state and the launch counts."""
    from tpudp_torch import serve_cli, train_cli
    from tpudp_torch.models import gpt2
    from tpudp_torch.serve import Engine

    root = f"{tmp}/gpt2"
    t0 = time.perf_counter()
    for fn in fa.KERNELS.values():
        fn.launches = 0
    run, text = run_quiet(lambda: train_cli.train(train_cli.parse_args(
        GPT2_SERVE_FLAGS + [
            "--batch-size", str(GPT2_CKPT_BATCH), "--steps",
            str(GPT2_CKPT_STEPS), "--log-every", "10", "--attn", "flash",
            "--dtype", "bfloat16", "--seed", str(seed),
            "--save-checkpoint", root])))
    launches = {name: fn.launches for name, fn in fa.KERNELS.items()}
    want = 12 * GPT2_CKPT_STEPS
    if any(n != want for n in launches.values()):
        raise SmokeFailure(f"ckpt-gpt2: flash launches {launches}, not "
                           f"{want} each")
    if not all(np.isfinite(run["losses"])) or run["checkpoint"] is None:
        raise SmokeFailure(f"ckpt-gpt2: training failed:\n{text}")
    print(f"ckpt-gpt2 train_cli --attn flash: {GPT2_CKPT_STEPS} steps at "
          f"{GPT2_CKPT_BATCH} x {GPT2_CKPT_T}, window losses "
          f"{[round(x, 4) for x in run['losses']]}, saved "
          f"{run['checkpoint']}; launches {launches}", flush=True)

    serve_argv = GPT2_SERVE_FLAGS + [
        "--paged", "512", "--requests", "8", "--max-new-tokens", "16",
        "--checkpoint-dir", root]
    for fn in pa.KERNELS.values():
        fn.launches = 0
    out, text = run_quiet(lambda: serve_cli.main(serve_argv))
    served = {name: fn.launches for name, fn in pa.KERNELS.items()}
    if not served["paged_decode"] or not served["paged_window"]:
        raise SmokeFailure(f"ckpt-gpt2: serve_cli launched {served}")
    if f"restored params from {root}/step_{GPT2_CKPT_STEPS}" not in text:
        raise SmokeFailure(f"ckpt-gpt2: serve_cli did not restore:\n{text}")
    launches.update({k: v for k, v in served.items() if v})
    # serve_cli's model: the trained widths in float32, dense attention
    held = gpt2.GPT2(dataclasses.replace(run["model"].config,
                                         dtype=torch.float32,
                                         attn_impl="dense"))
    held.load_state_dict({k: v.float() for k, v in
                          run["model"].state_dict().items()})
    held = held.to("cuda")
    restored, _ = serve_cli.build_model(serve_cli.parse_args(serve_argv),
                                        torch.device("cuda"))
    # Checkpoint fidelity: the restored weights are the trained ones, and
    # serve_cli's tokens equal an engine's of the trained model.
    mine, theirs = held.state_dict(), restored.state_dict()
    if mine.keys() != theirs.keys() or not all(
            torch.equal(mine[k], theirs[k]) for k in mine):
        raise SmokeFailure("ckpt-gpt2: the restored weights differ from the "
                           "trained model's")
    cli_tokens = [SimpleNamespace(tokens=t) for t in out["tokens"]]

    def engine_tokens(model, paged_attn):
        eng = Engine(model, device="cuda", num_slots=3, prefill_chunk=16,
                     kv_pages=512, paged_attn=paged_attn)
        handles = [eng.submit(p, 16) for p in out["prompts"]]
        eng.run_until_complete()
        return handles

    agree_with_plain(torch, np, held, out["prompts"], cli_tokens,
                     engine_tokens(held, None), "ckpt-gpt2 serve_cli",
                     against="the in-memory model's engine")
    # The kernels: K4/K5 on the trained weights against the plain engine
    # (no kernel) on the restored model, for serve_cli's requests and
    # phase 4's prompts.
    counts = {name: fn.launches for name, fn in pa.KERNELS.items()}
    agree_with_plain(torch, np, restored, out["prompts"], cli_tokens,
                     engine_tokens(restored, "einsum"),
                     "ckpt-gpt2 serve_cli")
    prompts = make_prompts(np, seed, 50_257)
    _, ref, _, _ = serve(torch, Engine, restored, prompts, "einsum")
    if any(fn.launches != counts[n] for n, fn in pa.KERNELS.items()):
        raise SmokeFailure("ckpt-gpt2: the plain engine launched a kernel")
    _, got, _, _ = serve(torch, Engine, restored, prompts, None)
    agree_with_plain(torch, np, restored, prompts, got, ref,
                     "ckpt-gpt2 phase-4 prompts on the restored model")
    try:
        run_quiet(lambda: serve_cli.main(
            ["--layers", "11"] + serve_argv[2:]))
    except SystemExit as e:
        if not str(e).startswith(f"error: checkpoint {root}/step_"):
            raise SmokeFailure(f"ckpt-gpt2: --layers 11 exited with {e}")
        print(f"ckpt-gpt2 serve_cli --layers 11: {e}", flush=True)
    else:
        raise SmokeFailure("ckpt-gpt2: serve_cli --layers 11 served a "
                           "12-layer checkpoint")
    print(f"ckpt-gpt2 serve_cli launches {served}; "
          f"{time.perf_counter() - t0:.1f}s for 10c", flush=True)
    del held, restored
    return run["state"], launches


def resnet50_state(torch, np, seed: int):
    """ResNet-50's training state at ImageNet geometry, one SGD step in
    (momentum allocated), as phase 9 trains it."""
    from tpudp_torch import train
    from tpudp_torch.models import resnet

    model = resnet.build(50, seed, "cuda", dtype=torch.bfloat16)
    spec = train.make_optimizer(learning_rate=0.1)
    state = train.init_state(model, spec)
    step = train.make_train_step(model, spec)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(8, RESNET_SIZE, RESNET_SIZE, 3))
                        .astype(np.float32), device="cuda")
    y = torch.as_tensor(rng.integers(0, 1000, 8), device="cuda")
    state, _ = step(state, x, y)
    return state


def checkpoint_costs(torch, np, tmp: str, states: dict) -> None:
    """10d: for each state, the blocking ms of a synchronous
    ``save_checkpoint``, of ``AsyncCheckpointWriter.save`` (cold: its
    pinned buffers allocated; warm: reused) and its background write,
    ``restore_checkpoint`` without and with ``verify``, and the bytes on
    disk; then a VGG-11 epoch of 50,000 images with no save, an epoch-end
    synchronous save and an asynchronous one."""
    from tpudp_torch.utils.checkpoint import (STATE_FILE,
                                              AsyncCheckpointWriter,
                                              restore_checkpoint,
                                              save_checkpoint,
                                              verify_restored)

    def ms(fn, host_only=False):
        """ms until ``fn`` returns (``host_only``), or until the device
        work it queued is done too."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if not host_only:
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    for label, state in states.items():
        root = f"{tmp}/cost-{label}"
        n_params = sum(p.numel() for p in state.model.parameters())
        sync_ms = ms(lambda: save_checkpoint(f"{root}/step_1", state))
        size = os.path.getsize(f"{root}/step_1/{STATE_FILE}")
        writer = AsyncCheckpointWriter()
        cold = ms(lambda: writer.save(f"{root}/step_2", state), True)
        writer.wait()
        cold_bg = 1e3 * writer.last_write_s
        warm = ms(lambda: writer.save(f"{root}/step_3", state), True)
        writer.wait()
        warm_bg = 1e3 * writer.last_write_s
        copies = ms(lambda: writer.save(f"{root}/step_4", state))
        writer.close()
        load = ms(lambda: restore_checkpoint(f"{root}/step_1", state))
        verified = ms(lambda: restore_checkpoint(f"{root}/step_1", state,
                                                 verify=True))
        tree = restore_checkpoint(f"{root}/step_1")
        crc = ms(lambda: verify_restored(f"{root}/step_1", tree), True)
        print(f"ckpt-cost {label}: {n_params / 1e6:.2f}M params, "
              f"{size} bytes on disk; sync save {sync_ms:.1f} ms; async "
              f"save returns in {warm:.1f} ms (first {cold:.1f} ms, pinned "
              f"buffers allocated), its copies to the host done "
              f"{copies:.1f} ms after the call, background write "
              f"{warm_bg:.1f} ms (first {cold_bg:.1f} ms); restore "
              f"{load:.1f} ms, restore with verify {verified:.1f} ms "
              f"(the checksums alone {crc:.1f} ms)", flush=True)
        shutil.rmtree(root, ignore_errors=True)
    vgg_epoch_costs(torch, tmp)


def vgg_epoch_costs(torch, tmp: str) -> None:
    """VGG-11 (Part 1's Trainer, float32) over 50,000 images, 2 epochs a
    mode: no save, an epoch-end synchronous save, an epoch-end
    asynchronous save (its last write joined outside the timing and
    printed apart), in turns (none, sync, async).  Per mode: the
    fit's wall time, its epochs' own times and the time outside them
    (the saves' blocking time); then each save's blocking ms an epoch,
    and the mean epoch beside the no-save runs' (what a background write
    costs the next epoch)."""
    from tpudp_torch.data import (DataLoader, Prefetcher, ShardedSampler,
                                  device_place, load_cifar10)
    from tpudp_torch.models import vgg
    from tpudp_torch.trainer import Trainer
    from tpudp_torch.utils.checkpoint import (AsyncCheckpointWriter,
                                              save_checkpoint)

    train_set, _, _ = load_cifar10(f"{tmp}/no-data",
                                   synthetic_train_size=EPOCH_IMAGES,
                                   synthetic_test_size=16)
    outside: dict[str, list[float]] = {}
    epoch_s: dict[str, list[float]] = {}
    for mode in ("none", "sync", "async"):
        ld = Prefetcher(DataLoader(train_set, VGG_BATCH, sampler=
                                   ShardedSampler(EPOCH_IMAGES, 1, 0,
                                                  shuffle=True, seed=0),
                                   train=True, seed=0), depth=2,
                        place=device_place("cuda"))
        tr = Trainer(vgg.build(vgg.CONFIGS["VGG11"], 0, "cuda"),
                     log_fn=lambda line: None)
        writer = AsyncCheckpointWriter() if mode == "async" else None
        root = f"{tmp}/epoch-{mode}"

        def save(epoch, tr=tr, writer=writer, root=root):
            path = f"{root}/step_{epoch + 1}"
            if writer is not None:
                writer.save(path, tr.state)
            elif mode == "sync":
                save_checkpoint(path, tr.state)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.fit(ld, None, 2, epoch_end_fn=save)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tail = ""
        if writer is not None:
            t1 = time.perf_counter()
            writer.close()
            joined = 1e3 * (time.perf_counter() - t1)
            tail = f", last write joined {joined:.1f} ms after the fit"
        ld.close()
        epochs = [r["seconds"] for r in tr.records if r["kind"] == "epoch"]
        outside.setdefault(mode, []).append(
            (wall - sum(epochs)) / len(epochs))
        epoch_s.setdefault(mode, []).extend(epochs)
        print(f"ckpt-cost vgg11 epoch ({EPOCH_IMAGES} images, save "
              f"{mode}): fit of 2 epochs {wall:.3f} s, epoch times "
              f"{[round(s, 3) for s in epochs]} s, "
              f"{1e3 * outside[mode][-1]:.1f} ms an epoch outside them"
              f"{tail}", flush=True)
        shutil.rmtree(root, ignore_errors=True)
        del tr
    def mean(xs):
        return sum(xs) / len(xs)

    base = mean(epoch_s["none"])
    for mode in ("sync", "async"):
        blocks = mean(outside[mode]) - mean(outside["none"])
        print(f"ckpt-cost vgg11 epoch-end {mode} save: blocks "
              f"{1e3 * blocks:.1f} ms an epoch ({100 * blocks / base:.2f}% "
              f"of the no-save runs' mean epoch, {base:.3f} s); its epochs "
              f"{mean(epoch_s[mode]):.3f} s (no-save epochs "
              f"{[round(x, 3) for x in epoch_s['none']]} s)", flush=True)


def checkpoint_path(torch, np, pa, fa, seed: int) -> dict:
    """Phase 10 (10a-10d) in a temporary directory outside the checkout;
    returns 10c's kernel launches."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="tpudp-ckpt-")
    torch.backends.cudnn.deterministic = True
    try:
        vgg_trainer = resume_path(torch, tmp)
        supervisor_path(torch, tmp)
    finally:
        torch.backends.cudnn.deterministic = False
    try:
        gpt2_state, launches = gpt2_checkpoint_path(torch, np, pa, fa, tmp,
                                                    seed)
        checkpoint_costs(torch, np, tmp, {
            "resnet50": resnet50_state(torch, np, seed),
            "vgg11": vgg_trainer.state, "gpt2": gpt2_state})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# -- phase 11: the parallel strategies at GPT-2 small's width -------------
#    (and phase 12b's LLaMA-GQA rungs, by the same functions)

def strategy_config(torch, overrides: dict, family: str = "gpt2"):
    """GPT-2 small (or, ``family='llama'``, LLaMA-GQA), float32, flash
    attention unless ``overrides`` say otherwise."""
    from tpudp_torch.models import gpt2, llama

    if family == "llama":
        cfg = dict(LLAMA_GQA, max_seq_len=STRATEGY_T, dtype=torch.float32,
                   attn_impl="flash")
        cfg.update(overrides)
        return llama.LlamaConfig(**cfg)
    cfg = dict(vocab_size=50_257, max_seq_len=STRATEGY_T, num_layers=12,
               num_heads=12, d_model=768, dtype=torch.float32,
               attn_impl="flash")
    cfg.update(overrides)
    return gpt2.GPT2Config(**cfg)


def strategy_batches(np, vocab: int = 50_257, batch: int = STRATEGY_BATCH,
                     seed: int = 11) -> list:
    """Numpy-seeded global batches of ``batch`` x STRATEGY_T tokens and
    their next-token targets, STRATEGY_STEPS of them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(STRATEGY_STEPS, batch,
                                        STRATEGY_T + 1))
    return [(t[:, :-1], t[:, 1:]) for t in toks]


def strategy_model(torch, overrides: dict, seed: int, family: str = "gpt2"):
    """The rung's (or the reference's) model built on the card, its
    weights drawn there from ``seed`` in parameter order (normal(0, 0.02),
    LayerNorm and RMSNorm scales 1 + normal(0, 0.1)): the same on every
    process."""
    from tpudp_torch.models import gpt2, llama

    cfg = strategy_config(torch, overrides, family)
    with torch.device("cuda"):
        model = (llama.Llama(cfg) if family == "llama" else gpt2.GPT2(cfg))
    gen = torch.Generator("cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = name.endswith(("ln_1.weight", "ln_2.weight",
                                   "ln_f.weight", ".scale"))
            p.normal_(1.0 if scale else 0.0, 0.1 if scale else 0.02,
                      generator=gen)
    return model


def one_rank_run(torch, train, model, batches, save_to=None,
                 **step_kw) -> dict:
    """The one-rank step on ``batches`` (global batches on the card):
    losses, ms a step, the state bytes after it and the peak memory of
    its first step; ``save_to``: a file that then holds the parameters
    after the steps, by name, on the host."""
    from tpudp_torch.parallel.sharded import state_nbytes

    spec = train.make_optimizer(learning_rate=0.01, momentum=0.9,
                                weight_decay=1e-4)
    state = train.init_state(model, spec)
    step = train.make_train_step(model, spec, aux_loss_coef=0.0, **step_kw)
    losses, ms, peak = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for x, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, torch.as_tensor(x, device="cuda"),
                           torch.as_tensor(y, device="cuda"))
        losses.append(float(loss))
        ms.append(1e3 * (time.perf_counter() - t0))
        if peak is None:
            peak = torch.cuda.max_memory_allocated()
    out = {"losses": losses, "ms": ms, "bytes": state_nbytes(state),
           "peak": peak}
    if save_to is not None:
        torch.save({n: p.detach().cpu()
                    for n, p in state.model.named_parameters()}, save_to)
    del state, step
    return out


def strategy_references(torch, np, seed: int, family: str = "gpt2") -> dict:
    """The one-rank step's losses and state bytes on the phase's batches:
    ``flash`` (tp, fsdp, zero1, pp), ``moe`` (ep: the dense MoE model, no
    balance loss; GPT-2 only) and ``dense`` (sp: dense attention)."""
    from tpudp_torch import train

    cases = {"flash": {}, "dense": {"attn_impl": "dense"}}
    if family == "gpt2":
        cases["moe"] = {k: v for k, v in STRATEGY_MOE.items()
                        if k != "expert_axis"}
    out = {}
    for name, overrides in cases.items():
        model = strategy_model(torch, overrides, seed, family)
        out[name] = one_rank_run(torch, train, model,
                                 strategy_batches(np, RUNG_VOCAB[family]))
        del model
        torch.cuda.empty_cache()
    return out


def replicated_hash(torch, strategy: str, state) -> str:
    """sha256 of the rung's replicated parameters on this rank: every
    leaf no group shards (and zero1's whole parameters)."""
    import hashlib

    if state.layout is None:
        tensors = list(state.model.parameters())
    else:
        tensors = [lf.local for lf in state.layout.leaves
                   if lf.group is None]
        if strategy == "zero1":
            tensors += list(state.model.parameters())
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def timed_steps(torch, built, batches) -> dict:
    """``built``'s steps on this rank's block of each global batch, with
    the flash launches and ``attention.dense_routes`` set to 0 just
    before and read just after: losses, ms, the collectives' wall ms and
    ``(calls, staged)`` a step, the peak memory, the state bytes."""
    from tpudp_torch.ops import attention
    from tpudp_torch.ops import flash_attention as fa
    from tpudp_torch.parallel import collectives
    from tpudp_torch.parallel.sharded import state_nbytes

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in fa.KERNELS.values():
        fn.launches = 0
    routes = attention.dense_routes
    st, losses, ms, comm, calls = built.state, [], [], [], []
    for x, y in batches:
        xs, ys = (torch.as_tensor(built.shard_for(a), device="cuda")
                  for a in (x, y))
        collectives.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collectives.timing():
            st, loss = built.train_step(st, xs, ys)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
        comm.append(1e3 * collectives.STATS["seconds"])
        calls.append((collectives.STATS["calls"],
                      collectives.STATS["staged"]))
    return {"losses": losses, "ms": ms, "comm_ms": comm, "calls": calls,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "bytes": state_nbytes(st),
            "launches": {k: fn.launches for k, fn in fa.KERNELS.items()},
            "dense_routes": attention.dense_routes - routes}


def strategy_rank(rank: int, world: int, init_method: str, seed: int,
                  family: str, results) -> None:
    """Phase 11 (``family='gpt2'``, STRATEGY_RUNGS) or 12b ('llama',
    LLAMA_RUNGS): one of two ranks on the one card over gloo.  Each rung:
    build it from a fresh one-rank state, run its steps on this rank's
    block of each global batch (:func:`timed_steps`), and report beside
    the build time and the replicated parameters' hash."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh_nd
    from tpudp_torch.parallel.tensor import gpt2_tp_rules, llama_tp_rules
    from tpudp_torch.strategy import build_strategy

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    out = {"rank": rank}
    try:
        batches = strategy_batches(np, RUNG_VOCAB[family])
        rules = llama_tp_rules() if family == "llama" else gpt2_tp_rules()
        for name, (strategy, shape, options, overrides) in \
                RUNG_TABLES[family].items():
            t_build = time.perf_counter()
            model = strategy_model(torch, overrides, seed, family)
            spec = train.make_optimizer(learning_rate=0.01, momentum=0.9,
                                        weight_decay=1e-4)
            options = dict(options)
            if strategy == "tp":
                options["rules"] = rules
            built = build_strategy(strategy, model, spec,
                                   make_mesh_nd(shape),
                                   train.init_state(model, spec), **options)
            if built.state.model is not model:
                del model  # the rung keeps its own module
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t_build
            out[name] = timed_steps(torch, built, batches)
            out[name].update(
                build_s=build_s,
                hash=replicated_hash(torch, strategy, built.state),
                peak_stash=getattr(built.train_step, "peak_stash", None))
            del built
            torch.cuda.empty_cache()
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        results.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def strategy_path(torch, np, seed: int, family: str = "gpt2") -> dict:
    """Phase 11 (see the module docstring), or 12b's rungs with
    ``family='llama'``: returns the flash launches of each rung on rank
    0."""
    label = "strategy" if family == "gpt2" else "llama-strategy"
    what = "GPT-2 small" if family == "gpt2" else "LLaMA-GQA"
    t0 = time.perf_counter()
    refs = strategy_references(torch, np, seed, family)
    ref_s = time.perf_counter() - t0
    for name, r in refs.items():
        print(f"{label} reference {name}: one rank, {what}, global batch "
              f"{STRATEGY_BATCH} x {STRATEGY_T}, float32: losses "
              f"{[repr(x) for x in r['losses']]}, ms a step "
              f"{[round(x, 1) for x in r['ms']]}, state bytes params "
              f"{r['bytes']['params']:,} optimizer "
              f"{r['bytes']['opt_state']:,}", flush=True)
    got = run_ranks(strategy_rank, (seed, family), STRATEGY_TIMEOUT, label)
    failures, launches = [], {}
    for name, (strategy, shape, _, overrides) in RUNG_TABLES[family].items():
        a, b = got[0][name], got[1][name]
        ref = refs["moe" if strategy == "ep" else
                   "dense" if strategy == "sp" else "flash"]
        rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                      ref["losses"]))
        same = a["hash"] == b["hash"] and a["losses"] == b["losses"]
        one = ref["bytes"]
        ratio = {k: a["bytes"][k] / one[k] for k in one}
        flash = {k: (a["launches"][k], b["launches"][k])
                 for k in a["launches"]}
        launches[name] = a["launches"]
        steady = sum(a["ms"][1:]) / len(a["ms"][1:])
        share = sum(a["comm_ms"][1:]) / sum(a["ms"][1:])
        print(f"{label} {name}: mesh {shape}, 2 gloo ranks on one card, "
              f"{what} float32 {'ring' if strategy == 'sp' else 'flash'}"
              f" attention{', 4 experts' if strategy == 'ep' else ''}, "
              f"global batch {STRATEGY_BATCH} x {STRATEGY_T}: losses "
              f"{[repr(x) for x in a['losses']]}, one rank "
              f"{[repr(x) for x in ref['losses']]}: max relative difference "
              f"{rel:.3e} (rtol {STRATEGY_RTOL}); replicated parameters "
              f"bit-equal across ranks: {same}; ms a step "
              f"{[round(x, 1) for x in a['ms']]} (rank 1 "
              f"{[round(x, 1) for x in b['ms']]}; mean after the first "
              f"{steady:.1f}); collectives wall ms a step "
              f"{[round(x, 1) for x in a['comm_ms']]} (rank 1 "
              f"{[round(x, 1) for x in b['comm_ms']]}; {100 * share:.0f}% "
              f"of the steps after the first; gloo, staged through the "
              f"host: (calls, staged) a step {a['calls'][-1]}); peak "
              f"memory GiB {a['peak_gib']:.2f} / {b['peak_gib']:.2f}; state "
              f"bytes params {a['bytes']['params']:,} optimizer "
              f"{a['bytes']['opt_state']:,} (rank 1 "
              f"{b['bytes']['params']:,} / {b['bytes']['opt_state']:,}; "
              f"one rank {one['params']:,} / {one['opt_state']:,}: "
              f"{ratio['params']:.3f} / {ratio['opt_state']:.3f}); flash "
              f"launches (rank 0, rank 1) {flash}"
              + (f"; 1f1b stash peak {a['peak_stash']} / {b['peak_stash']}"
                 if name == "pp-1f1b" else "")
              + f"; build {a['build_s']:.1f}s", flush=True)
        if rel > STRATEGY_RTOL:
            failures.append(f"{name} losses {rel:.3e} from one rank's")
        if not same:
            failures.append(f"{name} replicated parameters differ")
        if strategy != "sp" and not all(min(v) > 0 for v in flash.values()):
            failures.append(f"{name} launched no flash kernel: {flash}")
        if strategy == "sp" and any(max(v) for v in flash.values()):
            failures.append(f"{name} (ring attention) launched {flash}")
        if a["dense_routes"] or b["dense_routes"]:
            failures.append(f"{name} sent flash calls to the dense math")
        if strategy == "fsdp" and not all(0.45 < r < 0.55
                                          for r in ratio.values()):
            failures.append(f"fsdp state is {ratio} of one rank's")
        if strategy == "zero1" and not 0.45 < ratio["opt_state"] < 0.55:
            failures.append(f"zero1 momentum is {ratio['opt_state']:.3f} "
                            "of one rank's")
    print(f"{label}: {time.perf_counter() - t0:.1f}s (one-rank references "
          f"{ref_s:.1f}s)", flush=True)
    if failures:
        raise SmokeFailure(f"{label}: {failures}")
    return launches


# -- phase 12: the MPMD pipeline, LLaMA-GQA training, the chunked loss ----

def mpmd_rank(rank: int, world: int, init_method: str, seed: int,
              name: str, ref_path: str, results) -> None:
    """12a: one of ``world`` ranks on the one card over gloo, GPT-2 small
    under ``schedule='1f1b_mpmd'`` on MPMD_RUNS[name]'s mesh: the steps
    (:func:`timed_steps`), the stage's coordinates and parameter hash,
    the largest difference of its parameters from the one-rank step's
    (saved at ``ref_path``), the bubble fraction and the shared
    parameters' bytes."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh_nd
    from tpudp_torch.strategy import build_strategy

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    out = {"rank": rank}
    try:
        _, shape, interleave = MPMD_RUNS[name]
        mesh = make_mesh_nd(shape)
        model = strategy_model(torch, {}, seed)
        spec = train.make_optimizer(learning_rate=0.01, momentum=0.9,
                                    weight_decay=1e-4)
        built = build_strategy(
            "pp", model, spec, mesh, train.init_state(model, spec),
            n_microbatches=MPMD_MICRO, schedule="1f1b_mpmd",
            interleave=interleave, shard_optimizer=True)
        del model
        out.update(timed_steps(torch, built, strategy_batches(
            np, batch=MPMD_BATCH, seed=12)))
        stage = built.state.model
        flat = torch.cat([p.detach().reshape(-1)
                          for p in stage.parameters()])
        part = built.train_step.partition
        ref = torch.load(ref_path, mmap=True, weights_only=True)
        names = built.state.layout.stage.global_name
        out["param_diff"] = max(
            float((p.detach() - ref[names(n)].to(p.device)).abs().max())
            for n, p in stage.named_parameters())
        del ref
        out.update(
            coords=dict(mesh.coords), peak_stash=built.train_step.peak_stash,
            hash=hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest(),
            bubble=part.bubble_fraction(MPMD_MICRO),
            layers=list(part.stage_layers(mesh.coords["pipe"])),
            shared_bytes=sum(p.numel() * p.element_size()
                             for n, p in stage.named_parameters()
                             if not n.startswith("h.")))
        del built
        torch.cuda.empty_cache()
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        results.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def mpmd_references(torch, np, seed: int, tmp: str) -> dict:
    """The one-rank step on 12a's global batches (it is also 12c's plain
    step, whose peak is its first step's; its parameters after the steps
    saved under ``tmp``), then 12c's ``loss_chunk`` step from the same
    weights on the first batch."""
    from tpudp_torch import train

    batches = strategy_batches(np, batch=MPMD_BATCH, seed=12)
    path = os.path.join(tmp, "one-rank.pt")
    out = {"plain": one_rank_run(torch, train, strategy_model(torch, {},
                                                               seed),
                                 batches, save_to=path)}
    out["plain"]["params_path"] = path
    torch.cuda.empty_cache()
    out["chunk"] = one_rank_run(torch, train, strategy_model(torch, {}, seed),
                                batches[:1], loss_chunk=LOSS_CHUNK)
    torch.cuda.empty_cache()
    return out


def mpmd_path(torch, np, seed: int, refs: dict) -> dict:
    """12a (see the module docstring): returns the flash launches of each
    run's rank 0."""
    ref = refs["plain"]
    one_opt = ref["bytes"]["opt_state"]
    failures, launches = [], {}
    for name, (world, shape, interleave) in MPMD_RUNS.items():
        t0 = time.perf_counter()
        got = run_ranks(mpmd_rank, (seed, name, ref["params_path"]),
                        MPMD_TIMEOUT, f"mpmd {name}", world=world)
        wall = time.perf_counter() - t0
        pp, dp = shape["pipe"], shape["data"]
        launches[name] = got[0]["launches"]
        for r in got:
            rel = max(abs(x - y) / abs(y)
                      for x, y in zip(r["losses"], ref["losses"]))
            blocks = one_opt - r["shared_bytes"]
            share = (r["bytes"]["opt_state"] - r["shared_bytes"] / dp) / blocks
            steady = sum(r["ms"][1:]) / len(r["ms"][1:])
            comm = sum(r["comm_ms"][1:]) / sum(r["ms"][1:])
            twins = [o for o in got if o["coords"]["pipe"] ==
                     r["coords"]["pipe"]]
            same = all(o["hash"] == r["hash"] and o["losses"] == r["losses"]
                       for o in twins)
            print(f"mpmd {name} rank {r['rank']} {r['coords']}: GPT-2 small "
                  f"float32 flash, {world} gloo ranks on one card, "
                  f"interleave {interleave} (layers {r['layers']}), "
                  f"{MPMD_MICRO} microbatches of "
                  f"{MPMD_BATCH // dp // MPMD_MICRO} x {STRATEGY_T}, "
                  f"shard_optimizer: losses "
                  f"{[repr(x) for x in r['losses']]}, one rank "
                  f"{[repr(x) for x in ref['losses']]}: max relative "
                  f"difference {rel:.3e} (rtol {MPMD_RTOL}); parameters "
                  f"after the steps within {r['param_diff']:.3e} of one "
                  f"rank's (atol {MPMD_ATOL}), "
                  f"bit-equal across the {dp} data replicas: {same}; ms a "
                  f"step {[round(x, 1) for x in r['ms']]} (mean after the "
                  f"first {steady:.1f}; one rank "
                  f"{sum(ref['ms'][1:]) / len(ref['ms'][1:]):.1f}); bubble "
                  f"fraction {r['bubble']:.4f}; collectives wall ms a step "
                  f"{[round(x, 1) for x in r['comm_ms']]} ({100 * comm:.0f}% "
                  f"of the steps after the first; (calls, staged) "
                  f"{r['calls'][-1]}); peak memory {r['peak_gib']:.2f} GiB; "
                  f"momentum bytes {r['bytes']['opt_state']:,} (one rank "
                  f"{one_opt:,}; blocks' share {share:.4f}, 1/(PP*DP) "
                  f"{1 / (pp * dp):.4f}); stash peak {r['peak_stash']}; "
                  f"flash launches {r['launches']}", flush=True)
            if rel > MPMD_RTOL:
                failures.append(f"{name} rank {r['rank']} losses {rel:.3e} "
                                "from one rank's")
            if not r["param_diff"] <= MPMD_ATOL:
                failures.append(f"{name} rank {r['rank']} parameters "
                                f"{r['param_diff']:.3e} from one rank's")
            if not same:
                failures.append(f"{name} rank {r['rank']}: its data "
                                "replicas hold other parameters")
            if not all(r["launches"].values()):
                failures.append(f"{name} rank {r['rank']} launched "
                                f"{r['launches']}")
            if r["dense_routes"]:
                failures.append(f"{name} sent flash calls to the dense math")
            if abs(share * pp * dp - 1) > 0.01:
                failures.append(f"{name} rank {r['rank']} holds {share:.4f} "
                                "of the blocks' momentum")
        print(f"mpmd {name}: {wall:.1f}s", flush=True)
    if failures:
        raise SmokeFailure(f"mpmd: {failures}")
    return launches


def llama_cli_path(torch, np, fa) -> dict:
    """12b's one rank: ``train_cli --family llama --kv-heads 3`` with
    flash attention (K1-K3, launch counts set to 0 just before and read
    just after) and with dense attention; returns the flash run's
    launches."""
    from tpudp_torch import train_cli
    from tpudp_torch.ops import attention

    argv = ["--family", "llama", "--kv-heads", "3", "--layers", "12",
            "--d-model", "768", "--heads", "12", "--vocab", "32000",
            "--seq-len", str(STRATEGY_T), "--batch-size", "4", "--steps",
            str(LLAMA_CLI_STEPS), "--log-every", "2"]
    runs = {}
    for attn in ("flash", "dense"):
        for fn in fa.KERNELS.values():
            fn.launches = 0
        routes = attention.dense_routes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses, text = run_quiet(lambda: train_cli.main(
            argv + ["--attn", attn]))
        runs[attn] = {"losses": losses, "wall": time.perf_counter() - t0,
                      "peak": torch.cuda.max_memory_allocated() / 2**30,
                      "launches": {k: fn.launches
                                   for k, fn in fa.KERNELS.items()},
                      "routes": attention.dense_routes - routes,
                      "text": text}
        torch.cuda.empty_cache()
    flash, dense = runs["flash"], runs["dense"]
    for attn, r in runs.items():
        rates = [float(x.replace(",", "")) for x in
                 re.findall(r"\(([\d,.]+) tok/s\)", r["text"])]
        ms = [round(4e3 * STRATEGY_T / x, 1) for x in rates]
        print(f"llama-cli {attn}: {r['text'].splitlines()[0]}; window "
              f"losses {[round(x, 5) for x in r['losses']]}; tokens/s a "
              f"window {rates} (ms a step {ms}; the first window holds "
              f"the warm-up); {r['wall']:.1f}s for {LLAMA_CLI_STEPS} "
              f"steps; peak {r['peak']:.2f} GiB; flash launches "
              f"{r['launches']}", flush=True)
    want = LLAMA_GQA["num_layers"] * LLAMA_CLI_STEPS
    if any(n != want for n in flash["launches"].values()):
        raise SmokeFailure(f"llama-cli: flash launches {flash['launches']}"
                           f" (want {want} each)")
    if any(dense["launches"].values()) or flash["routes"]:
        raise SmokeFailure("llama-cli: a flash kernel in the dense run, or "
                           "a flash call sent to the dense math")
    if not np.isfinite(flash["losses"] + dense["losses"]).all():
        raise SmokeFailure("llama-cli: a loss is not finite")
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(flash["losses"], dense["losses"]))
    if rel > 2e-2:
        raise SmokeFailure(f"llama-cli: flash and dense losses differ by "
                           f"{rel:.3e} (rtol 2e-2)")
    print(f"llama-cli: flash losses agree with dense attention (max "
          f"relative difference {rel:.3e}, rtol 2e-2)", flush=True)
    return flash["launches"]


def chunk_path(refs: dict) -> None:
    """12c: the plain step's first step against the ``loss_chunk`` step
    on the same weights and batch."""
    plain, chunk = refs["plain"], refs["chunk"]
    a, b = plain["losses"][0], chunk["losses"][0]
    rel = abs(a - b) / abs(a)
    gib = 2**30
    print(f"chunk-loss: GPT-2 small float32 flash, batch {MPMD_BATCH} x "
          f"{STRATEGY_T}, one step: loss {a!r}, loss_chunk={LOSS_CHUNK} "
          f"{b!r} (relative difference {rel:.3e}, rtol 1e-5); peak memory "
          f"{plain['peak'] / gib:.3f} GiB, chunked {chunk['peak'] / gib:.3f} "
          f"GiB ({(plain['peak'] - chunk['peak']) / gib:.3f} GiB less; the "
          f"float32 logits alone are "
          f"{MPMD_BATCH * STRATEGY_T * 50_257 * 4 / gib:.3f} GiB); ms "
          f"{plain['ms'][0]:.1f} / {chunk['ms'][0]:.1f}", flush=True)
    if rel > 1e-5:
        raise SmokeFailure(f"chunk-loss: losses differ by {rel:.3e}")
    if chunk["peak"] >= plain["peak"]:
        raise SmokeFailure("chunk-loss: the chunked step's peak is not "
                           "below the plain step's")


def phase12_path(torch, np, fa, seed: int) -> dict:
    """Phase 12 (see the module docstring): 12a, 12c's measurements
    (taken with 12a's one-rank reference), 12b; returns the flash
    launches of each path."""
    from tpudp_torch.ops import attention

    import tempfile

    t0 = time.perf_counter()
    routes = attention.dense_routes
    tmp = tempfile.mkdtemp(prefix="tpudp-mpmd-")
    try:
        refs = mpmd_references(torch, np, seed, tmp)
        launches = mpmd_path(torch, np, seed, refs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    chunk_path(refs)
    t1 = time.perf_counter()
    launches["llama-cli"] = llama_cli_path(torch, np, fa)
    t2 = time.perf_counter()
    launches.update(strategy_path(torch, np, seed, family="llama"))
    if attention.dense_routes != routes:
        raise SmokeFailure(f"phase 12 sent {attention.dense_routes - routes}"
                           " flash calls to the dense math")
    print(f"phase 12: {time.perf_counter() - t0:.1f}s (12a and 12c "
          f"{t1 - t0:.1f}s, llama-cli {t2 - t1:.1f}s, llama rungs "
          f"{time.perf_counter() - t2:.1f}s)", flush=True)
    return launches


# -- phase 13: ViT-B/14 through the flash kernels, VGG-11 under tp -------

FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def vit_argv(attn: str, seed: int) -> list[str]:
    """``train_vit``'s flags for ViT-B/14 at 224, the example's ImageNet
    line (AdamW, bfloat16), at phase 13a's steps."""
    return ["--variant", "base", "--image-size", "224", "--patch-size",
            "14", "--num-classes", "1000", "--attn", attn, "--batch-size",
            str(VIT_BATCH), "--steps", str(VIT_STEPS), "--train-size",
            str(VIT_TRAIN), "--log-every", str(VIT_LOG_EVERY), "--dtype",
            "bfloat16", "--seed", str(seed)]


def flash_counts(prof: dict | None) -> dict:
    """The profiled launches of K1, K2 and K3 (their kernels' names:
    ``tpudp::...flash_fwd...``, ``flash_dq``, ``flash_dkv``)."""
    counts = {} if prof is None else prof["counts"]
    return {k: sum(n for cat, n in counts.items() if k + "_" in cat)
            for k in FLASH_KERNELS}


def vit_run(torch, np, fa, attn: str, seed: int) -> dict:
    """``train_vit.main`` on phase 13a's flags with its output captured,
    the flash launches and ``attention.dense_routes`` set to 0 just
    before and read just after; then one more step on a device batch
    under ``torch.profiler``.  Every loss must be finite and printed."""
    from tpudp_torch import train_vit
    from tpudp_torch.ops import attention

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in fa.KERNELS.values():
        fn.launches = 0
    routes = attention.dense_routes
    run, text = run_quiet(lambda: train_vit.main(vit_argv(attn, seed)))
    run["launches"] = {k: fn.launches for k, fn in fa.KERNELS.items()}
    run["dense_routes"] = attention.dense_routes - routes
    run["peak"] = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in run["records"]]
    lines = [line for line in text.splitlines()
             if line.startswith("step ") and "images/s" in line]
    if not losses or len(lines) != len(losses) or not all(
            np.isfinite(losses)):
        raise SmokeFailure(f"vit {attn}: losses {losses}, lines {lines}")
    run["banner"] = text.splitlines()[0]
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn((VIT_BATCH, 224, 224, 3), generator=g, device="cuda")
    y = torch.randint(0, 1000, (VIT_BATCH,), generator=g, device="cuda")
    before = {k: fn.launches for k, fn in fa.KERNELS.items()}
    run["profile"] = profile_call(torch, lambda: run["step"](run["state"],
                                                             x, y),
                                  cpu_top=8)
    run["profiled_launches"] = {k: fn.launches - before[k]
                                for k, fn in fa.KERNELS.items()}
    for key in ("model", "state", "step"):
        run.pop(key)
    torch.cuda.empty_cache()
    return run


def vit_logits_check(torch, np, seed: int) -> float:
    """ViT-B/14's logits, flash against dense, from the same
    ``random_params(seed)`` on one batch: the relative error norm."""
    from tpudp_torch.models import vit

    g = torch.Generator("cuda").manual_seed(seed + 1)
    x = torch.randn((VIT_CHECK_BATCH, 224, 224, 3), generator=g,
                    device="cuda")
    out = {}
    for attn in ("flash", "dense"):
        model = vit.build(vit.ViTConfig(
            image_size=224, patch_size=14, num_classes=1000, num_layers=12,
            num_heads=12, d_model=768, dtype=torch.bfloat16,
            attn_impl=attn), seed, "cuda")
        with torch.no_grad():
            out[attn] = model(x).float()
        del model
    if not all(torch.isfinite(v).all() for v in out.values()):
        raise SmokeFailure("vit logits are not finite")
    return ((out["flash"] - out["dense"]).norm()
            / out["dense"].norm()).item()


def vit_path(torch, np, fa, seed: int, card: str) -> dict:
    """13a: ViT-B/14 at 224, bf16, trained through ``train_vit`` with
    flash attention (K1-K3, non-causal, 256 tokens) and with dense
    attention from the same weights and batches; returns the flash run's
    launches."""
    t0 = time.perf_counter()
    runs = {attn: vit_run(torch, np, fa, attn, seed)
            for attn in ("flash", "dense")}
    rel_logits = vit_logits_check(torch, np, seed)
    flash, dense = runs["flash"], runs["dense"]
    failures = []
    for attn, run in runs.items():
        steady = run["records"][1:]
        ms = 1e3 * sum(r["seconds"] for r in steady) / (
            VIT_LOG_EVERY * len(steady))
        ips = sum(r["images_s"] for r in steady) / len(steady)
        prof = run["profile"]
        counts = flash_counts(prof)
        if prof is None:
            prof_text = ("profiler saw no device kernel: device time not "
                         "measured")
            share = None
        else:
            total = sum(prof["device_ms"].values())
            flash_ms = sum(v for cat, v in prof["device_ms"].items()
                           if any(k + "_" in cat for k in FLASH_KERNELS))
            share = flash_ms / total
            prof_text = (f"profiled step {prof['wall_ms']:.1f} ms wall, "
                         f"device busy {100 * prof['busy_share']:.1f}%, "
                         f"K1-K3 {flash_ms:.3f} of {total:.3f} device ms "
                         f"({100 * share:.2f}%), K1-K3 launches in it "
                         f"{run['profiled_launches']} (the profiler "
                         f"recorded {counts}), device ms by kernel "
                         f"{prof['device_ms']}, largest other kernels "
                         f"{prof['top_other_ms']}, host operators by self "
                         f"CPU ms {prof['top_cpu_ms']}")
        print(f"vit {attn}: {run['banner']}; {card}; losses "
              f"{[round(r['loss'], 4) for r in run['records']]} (windows "
              f"of {VIT_LOG_EVERY} steps); {ips:,.1f} images/s and "
              f"{ms:.1f} ms a step over the windows after the first; peak "
              f"{run['peak'] / 2**30:.2f} GiB; flash launches "
              f"{run['launches']}; {prof_text}", flush=True)
        # The wrappers count each launch; the profiler shows the kernels
        # on the device, but can drop some of a step's ~1,500 records
        # (a full run on an H100 recorded 10 of the 12 K1 launches its
        # wrapper counted): it must record each kernel, and never more.
        launched = run["profiled_launches"]
        if attn == "flash":
            if any(n != 12 for n in launched.values()) or prof is None \
                    or not all(1 <= n <= 12 for n in counts.values()):
                failures.append(f"the profiled flash step launched "
                                f"{launched} (12 each expected), the "
                                f"profiler recorded {counts}")
        elif any(launched.values()) or any(counts.values()):
            failures.append(f"the dense profiled step launched {launched}, "
                            f"the profiler recorded {counts}")
    want = 12 * VIT_STEPS
    if any(flash["launches"][k] != want for k in FLASH_KERNELS):
        failures.append(f"flash run launched {flash['launches']} in "
                        f"{VIT_STEPS} steps of 12 layers ({want} each)")
    if any(dense["launches"].values()):
        failures.append(f"dense run launched {dense['launches']}")
    if flash["dense_routes"]:
        failures.append(f"{flash['dense_routes']} flash calls went to the "
                        "dense math")
    rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
              for a, b in zip(flash["records"], dense["records"]))
    print(f"vit: flash and dense from the same weights: logits relative "
          f"error norm {rel_logits:.3e} (limit {VIT_LOGIT_REL}), losses max "
          f"relative difference {rel:.3e} (rtol {VIT_LOSS_RTOL}); phase "
          f"13a {time.perf_counter() - t0:.1f}s", flush=True)
    if rel_logits > VIT_LOGIT_REL:
        failures.append(f"logits {rel_logits:.3e}")
    if rel > VIT_LOSS_RTOL:
        failures.append(f"losses {rel:.3e}")
    if failures:
        raise SmokeFailure(f"vit: {failures}")
    return flash["launches"]


def vgg_tp_batches(np, seed: int = 13) -> list:
    """Numpy-seeded CIFAR-shaped global batches (NHWC float32) and
    labels, VGG_TP_STEPS of them."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(VGG_TP_BATCH, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, size=VGG_TP_BATCH).astype(np.int64))
            for _ in range(VGG_TP_STEPS)]


def vgg_tp_model(torch, seed: int, deterministic: bool = True):
    from tpudp_torch.models import vgg

    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = not deterministic
    return vgg.build(vgg.CONFIGS["VGG11"], seed, "cuda")


def resnet_tp_model(torch, seed: int):
    from tpudp_torch.models import resnet

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return resnet.build(50, seed, "cuda")


def vit_tp_model(torch, seed: int):
    from tpudp_torch.models import vit

    return vit.build(vit.ViTConfig(
        image_size=224, patch_size=14, num_classes=1000, num_layers=12,
        num_heads=12, d_model=768, dtype=torch.bfloat16,
        attn_impl="flash"), seed, "cuda")


def image_batches(np, batch: int, steps: int, seed: int) -> list:
    """Numpy-seeded ImageNet-shaped global batches (NHWC float32) and
    labels of 1,000 classes."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(batch, 224, 224, 3)).astype(np.float32),
             rng.integers(0, 1000, size=batch).astype(np.int64))
            for _ in range(steps)]


#: 13c-13e: name -> (model, rules, global batches), each (torch or np,
#: seed) -> ...; every run takes 13b's SGD.
TP_MORE = {
    "resnet": (resnet_tp_model, "vgg_tp_rules",
               lambda np: image_batches(np, RESNET_TP_BATCH,
                                        RESNET_TP_STEPS, 17)),
    "vit": (vit_tp_model, "gpt2_tp_rules",
            lambda np: image_batches(np, VIT_TP_BATCH, VIT_TP_STEPS, 19)),
    "replicated": (lambda torch, seed: strategy_model(torch, {}, seed),
                   "vgg_tp_rules", lambda np: strategy_batches(np)[:1]),
}
TP_SGD = dict(learning_rate=0.01, momentum=0.9, weight_decay=1e-4)


def host_tree(tree):
    """A nested dict of tensors as numpy arrays (they cross the results
    queue by value)."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def tp_more_rank(torch, np, seed: int, world: int, rank: int) -> dict:
    """13c-13e on this rank: each TP_MORE model under its rules at data
    1 x model ``world``, its steps timed as phase 11's rungs; rank 0
    adds 13c's state after its first step in JAX's global layout."""
    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh_nd
    from tpudp_torch.parallel import tensor
    from tpudp_torch.strategy import build_strategy

    out = {}
    for name, (make, rules, batches_of) in TP_MORE.items():
        t0 = time.perf_counter()
        model = make(torch, seed)
        spec = train.make_optimizer(**TP_SGD)
        built = build_strategy("tp", model, spec,
                               make_mesh_nd({"data": 1, "model": world}),
                               train.init_state(model, spec),
                               rules=getattr(tensor, rules)())
        del model
        batches = batches_of(np)
        runs = [timed_steps(torch, built, batches[:1])]
        if name == "resnet":  # every rank gathers
            tree = train.state_to_jax(built.state)
            if rank == 0:
                out["resnet_tree"] = {k: host_tree(tree[k])
                                      for k in ("params", "batch_stats")}
            del tree
        if len(batches) > 1:
            runs.append(timed_steps(torch, built, batches[1:]))
        out[name] = {
            "module": type(built.state.model).__name__,
            "losses": sum((r["losses"] for r in runs), []),
            "ms": sum((r["ms"] for r in runs), []),
            "comm_ms": sum((r["comm_ms"] for r in runs), []),
            "calls": runs[-1]["calls"][-1],
            "peak_gib": max(r["peak_gib"] for r in runs),
            "launches": {k: sum(r["launches"][k] for r in runs)
                         for k in runs[0]["launches"]},
            "dense_routes": sum(r["dense_routes"] for r in runs),
            "wall_s": time.perf_counter() - t0}
        del built
        torch.cuda.empty_cache()
    return out


def vgg_tp_rank(rank: int, world: int, init_method: str, seed: int,
                results) -> None:
    """13b: one of two ranks on the card over gloo: VGG-11 under
    ``vgg_tp_rules`` at data 1 x model 2, its steps timed as phase 11's
    rungs (:func:`timed_steps`), and its state after the first step in
    JAX's global layout (the checkpoint tree)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh_nd
    from tpudp_torch.parallel.tensor import vgg_tp_rules
    from tpudp_torch.strategy import build_strategy

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    out = {"rank": rank}
    try:
        model = vgg_tp_model(torch, seed)
        spec = train.make_optimizer(learning_rate=0.01, momentum=0.9,
                                    weight_decay=1e-4)
        built = build_strategy("tp", model, spec,
                               make_mesh_nd({"data": 1, "model": world}),
                               train.init_state(model, spec),
                               rules=vgg_tp_rules())
        del model
        batches = vgg_tp_batches(np)
        first = timed_steps(torch, built, batches[:1])
        tree = train.state_to_jax(built.state)  # every rank gathers
        rest = timed_steps(torch, built, batches[1:])
        out.update(rest)
        for key in ("losses", "ms", "comm_ms", "calls"):
            out[key] = first[key] + rest[key]
        out["peak_gib"] = max(first["peak_gib"], rest["peak_gib"])
        out["launches"] = {k: first["launches"][k] + v
                           for k, v in rest["launches"].items()}
        out["local_shapes"] = {
            k: tuple(v.shape) for k, v in
            built.state.model.state_dict().items()
            if k in ("convs.0.weight", "fc.weight")}
        if rank == 0:
            # numpy crosses the queue by value (a tensor would be shared
            # by a descriptor this process closes when it exits)
            out["tree"] = {k: {n: {f: t.cpu().numpy() for f, t in
                                   leaf.items()}
                               for n, leaf in tree[k].items()}
                           for k in ("params", "batch_stats")}
        del built, tree
        torch.cuda.empty_cache()
        out["more"] = tp_more_rank(torch, np, seed, world, rank)
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        results.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def vgg_tp_reference(torch, np, seed: int,
                     deterministic: bool = True) -> dict:
    """The one-rank step on 13b's global batches: losses, ms a step,
    peak memory, and the state dict before and after the first step
    (``deterministic=False``: cuDNN's benchmark-mode algorithms)."""
    from tpudp_torch import train

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        model = vgg_tp_model(torch, seed, deterministic)
        spec = train.make_optimizer(learning_rate=0.01, momentum=0.9,
                                    weight_decay=1e-4)
        state = train.init_state(model, spec)
        step = train.make_train_step(model, spec)
        out = {"losses": [], "ms": [],
               "init": {k: v.detach().cpu().clone()
                        for k, v in model.state_dict().items()}}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for x, y in vgg_tp_batches(np):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, torch.as_tensor(x, device="cuda"),
                               torch.as_tensor(y, device="cuda"))
            out["losses"].append(float(loss))
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            if "first" not in out:
                out["first"] = {k: v.detach().cpu().clone()
                                for k, v in model.state_dict().items()}
        out["peak"] = torch.cuda.max_memory_allocated()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    del model, state, step
    torch.cuda.empty_cache()
    return out


def tp_more_references(torch, np, seed: int) -> dict:
    """The one-rank step of each TP_MORE model on its global batches:
    losses, ms a step, and for 13c the state before and after the first
    step."""
    from tpudp_torch import train

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    out = {}
    try:
        for name, (make, _, batches_of) in TP_MORE.items():
            model = make(torch, seed)
            spec = train.make_optimizer(**TP_SGD)
            state = train.init_state(model, spec)
            step = train.make_train_step(model, spec)

            def snapshot():
                return {k: v.detach().cpu().clone()
                        for k, v in model.state_dict().items()}

            ref = {"losses": [], "ms": []}
            if name == "resnet":
                ref["init"] = snapshot()
            for x, y in batches_of(np):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, torch.as_tensor(x, device="cuda"),
                                   torch.as_tensor(y, device="cuda"))
                ref["losses"].append(float(loss))
                ref["ms"].append(1e3 * (time.perf_counter() - t0))
                if name == "resnet" and "first" not in ref:
                    ref["first"] = snapshot()
            out[name] = ref
            del model, state, step
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    return out


def tp_more_checks(torch, got: list, refs: dict, card: str) -> dict:
    """13c-13e against their one-rank steps; returns rank 0's K1-K3
    launches of 13d and 13e."""
    from tpudp_torch.models import resnet

    a, b = (r["more"] for r in got)
    failures = []

    def rels(name):
        return [abs(x - y) / abs(y) for x, y in zip(a[name]["losses"],
                                                    refs[name]["losses"])]

    def line(name, label, extra):
        run = a[name]
        print(f"{label}: {card}; module {run['module']}; losses "
              f"{[repr(x) for x in run['losses']]}, one rank "
              f"{[repr(x) for x in refs[name]['losses']]}: relative "
              f"differences {['%.3e' % r for r in rels(name)]}; {extra}; ms "
              f"a step {[round(x, 1) for x in run['ms']]} (rank 1 "
              f"{[round(x, 1) for x in b[name]['ms']]}; one rank "
              f"{[round(x, 1) for x in refs[name]['ms']]}); collectives "
              f"wall ms a step {[round(x, 1) for x in run['comm_ms']]} "
              f"(gloo, (calls, staged) a step {run['calls']}); peak GiB "
              f"{run['peak_gib']:.2f} / {b[name]['peak_gib']:.2f}; flash "
              f"launches {run['launches']} / {b[name]['launches']}; "
              f"{run['wall_s']:.1f}s on rank 0", flush=True)

    # 13c: the first update over every parameter and running statistic
    ref = refs["resnet"]
    tree = a["resnet_tree"]
    state = resnet.params_from_jax(tree["params"], tree["batch_stats"])
    names = [k for k, v in ref["first"].items() if v.is_floating_point()]
    diff = torch.cat([(state[k] - ref["first"][k]).reshape(-1)
                      for k in names])
    upd = torch.cat([(ref["first"][k] - ref["init"][k]).reshape(-1)
                     for k in names])
    update_rel = (diff.norm() / upd.norm()).item()
    r = rels("resnet")
    line("resnet", "13c resnet-tp: ResNet-50 at 224 under vgg_tp_rules, "
         f"data 1 x model 2, 2 gloo ranks, float32, TF32 off, global batch "
         f"{RESNET_TP_BATCH}",
         f"the first update against one rank's {update_rel:.3e} (limit "
         f"{RESNET_TP_UPDATE_REL}); rtol {RESNET_TP_RTOL} at the first "
         f"step, {RESNET_TP_TRAJ_RTOL} after")
    if a["resnet"]["module"] != "TPResNet":
        failures.append(f"13c ran {a['resnet']['module']}")
    if r[0] > RESNET_TP_RTOL or max(r) > RESNET_TP_TRAJ_RTOL:
        failures.append(f"13c losses {r}")
    if update_rel > RESNET_TP_UPDATE_REL:
        failures.append(f"13c first update {update_rel:.3e}")
    for run in (a, b):
        if any(run["resnet"]["launches"].values()):
            failures.append(f"13c launched {run['resnet']['launches']}")
    # 13d: K1-K3 12 a step on each rank, the losses at VIT_LOSS_RTOL
    r = rels("vit")
    line("vit", "13d vit-tp: ViT-B/14 at 224 under gpt2_tp_rules, 6 heads "
         f"a rank, bf16, flash, global batch {VIT_TP_BATCH}",
         f"rtol {VIT_LOSS_RTOL}; K1-K3 launches expected {12 * VIT_TP_STEPS} "
         f"each a rank ({VIT_TP_STEPS} steps of 12 layers)")
    if a["vit"]["module"] != "TPViT" or max(r) > VIT_LOSS_RTOL:
        failures.append(f"13d {a['vit']['module']} losses {r}")
    for run in (a, b):
        if any(n != 12 * VIT_TP_STEPS
               for n in run["vit"]["launches"].values()) \
                or run["vit"]["dense_routes"]:
            failures.append(f"13d launched {run['vit']['launches']} "
                            f"({run['vit']['dense_routes']} dense routes)")
    # 13e: the replicated step
    r = rels("replicated")
    line("replicated", "13e replicated-tp: GPT-2 small under vgg_tp_rules "
         "(nothing split), data 1 x model 2, float32, flash, b "
         f"{STRATEGY_BATCH} x {STRATEGY_T}", f"rtol {STRATEGY_RTOL}")
    if a["replicated"]["module"] != "GPT2" or max(r) > STRATEGY_RTOL \
            or a["replicated"]["losses"] != b["replicated"]["losses"]:
        failures.append(f"13e {a['replicated']['module']} losses {r}, "
                        f"rank 1 {b['replicated']['losses']}")
    if failures:
        raise SmokeFailure(f"tp: {failures}")
    return {k: a["vit"]["launches"][k] + a["replicated"]["launches"][k]
            for k in FLASH_KERNELS}


def vgg_tp_path(torch, np, seed: int, card: str) -> dict:
    """13b: VGG-11 under tp on two gloo ranks of the card against the
    one-rank step on the same global batches; then 13c-13e in the same
    ranks.  Returns rank 0's K1-K3 launches of 13d and 13e."""
    from tpudp_torch.models import vgg

    t0 = time.perf_counter()
    ref = vgg_tp_reference(torch, np, seed)
    alt = vgg_tp_reference(torch, np, seed, deterministic=False)
    more_refs = tp_more_references(torch, np, seed)
    got = run_ranks(vgg_tp_rank, (seed,), VGG_TP_TIMEOUT, "vgg-tp")
    a, b = got
    tp = vgg.params_from_jax(a["tree"]["params"], a["tree"]["batch_stats"])
    names = [k for k, v in ref["first"].items() if v.is_floating_point()]
    # a convolution's bias has no gradient through its BatchNorm
    bias = [k for k in names if k.startswith("convs.")
            and k.endswith(".bias")]
    held = [k for k in names if k not in bias]

    def update_errors(state):
        """The first update's relative error against one rank's: over
        every held tensor, tensor by tensor (the three largest), and the
        convolutions' biases' largest absolute difference."""
        diff = {k: state[k] - ref["first"][k] for k in names}
        step = {k: ref["first"][k] - ref["init"][k] for k in held}
        per = {k: (diff[k].norm() / step[k].norm().clamp_min(1e-30)).item()
               for k in held}
        total = (torch.cat([diff[k].reshape(-1) for k in held]).norm()
                 / torch.cat([step[k].reshape(-1) for k in held]).norm())
        top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:3])
        return (total.item(), top,
                max(diff[k].abs().max().item() for k in bias))

    total, top, bias_err = update_errors(tp)
    a_total, a_top, a_bias = update_errors(alt["first"])
    rels = [abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                ref["losses"])]
    steady = sum(a["ms"][1:]) / len(a["ms"][1:])
    share = sum(a["comm_ms"][1:]) / sum(a["ms"][1:])

    def fmt(errors: dict) -> dict:
        return {k: "%.3e" % v for k, v in errors.items()}

    print(f"vgg-tp: VGG-11 under vgg_tp_rules, mesh data 1 x model 2, 2 "
          f"gloo ranks on one card, float32, TF32 off, global batch "
          f"{VGG_TP_BATCH}; {card}; local shapes {a['local_shapes']}; "
          f"losses {[repr(x) for x in a['losses']]}, one rank "
          f"{[repr(x) for x in ref['losses']]}: relative differences "
          f"{['%.3e' % r for r in rels]} (rtol {VGG_TP_RTOL} at the first "
          f"step, {VGG_TP_TRAJ_RTOL} after); the first update against one "
          f"rank's: {total:.3e} over every parameter and running "
          f"statistic (limit {VGG_TP_UPDATE_REL}), the largest tensors "
          f"{fmt(top)} (limit {VGG_TP_TENSOR_REL}), the convolutions' "
          f"biases {bias_err:.3e} (atol {VGG_TP_BIAS_ATOL}); one rank on "
          f"cuDNN's benchmark-mode algorithms: {a_total:.3e}, "
          f"{fmt(a_top)}, {a_bias:.3e}, losses "
          f"{[repr(x) for x in alt['losses']]}; ms a step "
          f"{[round(x, 1) for x in a['ms']]} (rank 1 "
          f"{[round(x, 1) for x in b['ms']]}; mean after the first "
          f"{steady:.1f}; one rank {[round(x, 1) for x in ref['ms']]}); "
          f"collectives wall ms a step {[round(x, 1) for x in a['comm_ms']]}"
          f" ({100 * share:.0f}% of the steps after the first; gloo, "
          f"(calls, staged) a step {a['calls'][-1]}); peak memory GiB "
          f"{a['peak_gib']:.2f} / {b['peak_gib']:.2f} (one rank "
          f"{ref['peak'] / 2**30:.2f}); flash launches {a['launches']}; "
          f"phase 13b {time.perf_counter() - t0:.1f}s", flush=True)
    failures = []
    if rels[0] > VGG_TP_RTOL:
        failures.append(f"first loss {rels[0]:.3e} from one rank's")
    if max(rels) > VGG_TP_TRAJ_RTOL:
        failures.append(f"losses {max(rels):.3e} from one rank's")
    if total > VGG_TP_UPDATE_REL:
        failures.append(f"the first update {total:.3e} from one rank's")
    if max(top.values()) > VGG_TP_TENSOR_REL:
        failures.append(f"the first update of {fmt(top)} from one rank's")
    if bias_err > VGG_TP_BIAS_ATOL:
        failures.append(f"a convolution's bias {bias_err:.3e} from one "
                        "rank's")
    if a["losses"] != b["losses"]:
        failures.append("the ranks' losses differ")
    if any(a["launches"].values()) or any(b["launches"].values()):
        failures.append(f"the VGG rung launched a port kernel: "
                        f"{a['launches']}")
    if a["local_shapes"]["convs.0.weight"][0] != 32:
        failures.append(f"the first conv is not split: {a['local_shapes']}")
    if failures:
        raise SmokeFailure(f"vgg-tp: {failures}")
    t1 = time.perf_counter()
    launches = tp_more_checks(torch, got, more_refs, card)
    print(f"phase 13b-13e {time.perf_counter() - t0:.1f}s (checks "
          f"{time.perf_counter() - t1:.1f}s)", flush=True)
    return launches


# -- phase 14: the decode remainder, tenancy and the dense prefix cache ----


def agree_by_model(torch, np, groups, label) -> None:
    """:func:`agree_with_plain` for each ``(name, model, prompts,
    handles, reference handles)`` group, the near-tie gaps read on the
    group's own model."""
    for name, model, prompts, handles, ref in groups:
        agree_with_plain(torch, np, model, prompts, handles, ref,
                         f"{label} {name}")


def tokens_of(tokens) -> SimpleNamespace:
    """A token list in the shape of a request handle."""
    return SimpleNamespace(tokens=tokens)


def train_sample_path(torch, np, fa, seed: int) -> dict:
    """14a: ``train_cli`` at GPT-2 small, flash attention in bf16, a few
    steps, then ``--sample``: K1-K3 launch (counts zeroed just before,
    read just after the run), and the sample equals ``generate()`` on the
    trained weights through a freshly built dense-attention model."""
    from tpudp_torch import train_cli
    from tpudp_torch.models import gpt2
    from tpudp_torch.models.generate import generate

    argv = ["--layers", "12", "--d-model", "768", "--heads", "12",
            "--vocab", "50257", "--seq-len", "1024", "--batch-size", "4",
            "--steps", str(P14_TRAIN_STEPS), "--log-every", "2", "--attn",
            "flash", "--dtype", "bfloat16", "--sample", str(P14_SAMPLE),
            "--seed", str(seed)]
    for fn in fa.KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    run, text = run_quiet(lambda: train_cli.train(train_cli.parse_args(
        argv)))
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fa.KERNELS.items()}
    want = 12 * P14_TRAIN_STEPS
    if any(launches[k] != want for k in FLASH_KERNELS):
        raise SmokeFailure(f"14a: flash launches {launches} (want {want} "
                           f"each)")
    if not np.isfinite(run["losses"]).all():
        raise SmokeFailure(f"14a: losses {run['losses']}")
    line = next((x for x in text.splitlines()
                 if x.startswith("[gpt2] greedy sample (prompt 16 tokens): ")),
                None)
    if line is None or not line.endswith(f" {run['sample']}"):
        raise SmokeFailure(f"14a: no sample line for {run['sample']}")
    cfg = dataclasses.replace(run["model"].config, attn_impl="dense")
    twin = gpt2.GPT2(cfg).to("cuda")
    twin.load_state_dict(run["model"].state_dict())
    corpus = train_cli.load_corpus(train_cli.parse_args(argv))
    prompt = torch.as_tensor(corpus[:16][None], device="cuda")
    with torch.no_grad():
        ref = generate(twin, prompt, P14_SAMPLE)[0, 16:].tolist()
    agree_by_model(torch, np, [("GPT-2 small", twin, [corpus[:16]],
                                [tokens_of(run["sample"])],
                                [tokens_of(ref)])], "14a sample")
    print(f"14a train_cli: {P14_TRAIN_STEPS} steps in {wall:.1f}s, window "
          f"losses {[round(x, 4) for x in run['losses']]}, flash launches "
          f"{launches}; sample {run['sample'][:8]}...", flush=True)
    return launches


def generate_path(torch, np, seed: int):
    """14b: ``generate_cli`` at GPT-2 medium, float32: ``--beam``, greedy
    and ``--concurrent`` through the entry point.  Width 1 equals greedy
    ``generate()``; the best beam's score equals the sum of its tokens'
    log-probabilities under one full forward; every concurrent copy
    equals the greedy tokens.  Returns the medium model."""
    from tpudp_torch import generate_cli
    from tpudp_torch.models.generate import beam_search

    argv = ["--layers", "24", "--d-model", "1024", "--heads", "16",
            "--vocab", "50257", "--seq-len", "1024", "--max-new-tokens",
            str(P14_NEW), "--seed", str(seed)]
    beam, text = run_quiet(lambda: generate_cli.main(
        argv + ["--beam", str(P14_BEAM)]))
    model = beam["model"]
    ids = beam["prompt"]
    n = len(ids)
    greedy, _ = run_quiet(lambda: generate_cli.main(argv))
    conc, conc_text = run_quiet(lambda: generate_cli.main(
        argv + ["--concurrent", str(P14_CONCURRENT)]))
    prompt = torch.as_tensor([ids], device="cuda")
    with torch.no_grad():
        seq1, _ = beam_search(model, prompt, P14_NEW, beam_width=1)
        seq = torch.as_tensor([ids + beam["tokens"]], device="cuda")
        logp = torch.log_softmax(model(seq).float(), dim=-1)
    if seq1[0, n:].tolist() != greedy["tokens"]:
        raise SmokeFailure(f"14b: beam width 1 {seq1[0, n:].tolist()} is "
                           f"not greedy {greedy['tokens']}")
    score = float(torch.gather(logp[0, n - 1:-1], 1,
                               seq[0, n:, None]).sum())
    err = abs(score - beam["score"])
    if err > P14_SCORE_ATOL:
        raise SmokeFailure(f"14b: beam score {beam['score']} against the "
                           f"full forward's {score} (atol {P14_SCORE_ATOL})")
    agree_by_model(torch, np, [("GPT-2 medium", model,
                                [np.asarray(ids)] * P14_CONCURRENT,
                                [tokens_of(t) for t in conc["tokens"]],
                                [tokens_of(greedy["tokens"])]
                                * P14_CONCURRENT)], "14b concurrent")
    rate = re.search(r"aggregate ([\d.]+) tokens/s", conc_text).group(1)
    print(f"14b generate_cli GPT-2 medium float32: beam {P14_BEAM} "
          f"logprob {beam['score']:.4f} (one full forward {score:.4f}, "
          f"|diff| {err:.2e}, atol {P14_SCORE_ATOL}), "
          f"{beam['ms_per_token']:.3f} ms a new token; greedy "
          f"{greedy['ms_per_token']:.3f} ms a new token; beam width 1 "
          f"equals greedy; --concurrent {P14_CONCURRENT} {rate} tokens/s "
          f"({conc['ms_per_token']:.3f} ms a new token of one copy)",
          flush=True)
    return model


def tenancy_engine(torch, Engine, TenantClass, models, paged_attn, fuse):
    """14c's engine: GPT-2 small as the default model, a second small
    (``twin``, sharing its pool) and GPT-2 medium (``medium``, its own
    pool) behind the ``high`` tier and three low-tier classes, one a
    model."""
    tenants = {"high": TenantClass(priority=1), "low": TenantClass(),
               "low-twin": TenantClass(model="twin"),
               "low-medium": TenantClass(model="medium")}
    return Engine(models[None], device="cuda", num_slots=P14_SLOTS,
                  prefill_chunk=16, kv_pages=P14_PAGES,
                  paged_attn=paged_attn, decode_fuse=fuse, tenants=tenants,
                  models={k: m for k, m in models.items() if k})


def tenancy_run(torch, np, eng, pa, prompts, storm_prompts, seed: int):
    """Low-tier traffic over the three models, then a ``PreemptionStorm``
    into ``high``; ``check_paged`` after every step and the kernel counts
    zeroed just before, read just after.  Returns the handles, storm
    handles, wall seconds and counts."""
    from tpudp_torch.serve.faults import PreemptionStorm

    classes = ("low", "low-twin", "low-medium")
    for fn in pa.KERNELS.values():
        fn.launches = 0
    storm = PreemptionStorm("high", storm_prompts, at_steps=P14_STORM_AT,
                            max_new=P14_STORM_NEW, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(p, P14_LOW_NEW, tenant=classes[i % 3])
               for i, p in enumerate(prompts)]
    steps = 0
    while eng.queue_depth or eng.slots_in_use or not storm.done:
        eng.step()
        eng.check_paged()
        storm.tick(eng, steps)
        steps += 1
        if steps > 5000:
            raise SmokeFailure("14c: the engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in pa.KERNELS.items()}
    return handles, storm.handles, wall, launches


def tenancy_path(torch, np, pa, small, medium, seed: int) -> dict:
    """14c: one paged kernel engine with ``decode_fuse`` over two KV
    geometries and a preemption storm, against the same traffic on the
    einsum path (single steps): every request's greedy tokens agree,
    preemptions happen, K4 and K5 launch, the pools and indexes check
    clean, and the two small models share one ``PagePool``.  Returns
    the kernel run's counts."""
    from tpudp_torch.models import gpt2
    from tpudp_torch.serve import Engine, TenantClass

    models = {None: small, "twin": gpt2.build(small.config, seed + 1,
                                              "cuda"),
              "medium": medium}
    vocab = small.config.vocab_size
    rng = np.random.default_rng(seed + 14)
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32)
               for n in rng.integers(17, 300, size=P14_LOW)]
    storm_prompts = [rng.integers(0, vocab, size=n).astype(np.int32)
                     for n in (20, 45, 9, 70)]
    runs = {}
    for impl, fuse in (("kernel", P14_FUSE), ("einsum", 1)):
        eng = tenancy_engine(torch, Engine, TenantClass, models, impl, fuse)
        runs[impl] = (eng, *tenancy_run(torch, np, eng, pa, prompts,
                                        storm_prompts, seed))
    eng, handles, storm, wall, launches = runs["kernel"]
    _, ref, ref_storm, ref_wall, ref_launches = runs["einsum"]
    ms = eng._mstates
    if ms["twin"].pool is not ms[None].pool or ms["medium"].pool is \
            ms[None].pool:
        raise SmokeFailure("14c: the small models do not share one pool, "
                           "or the medium model shares it")
    for m in ms.values():
        m.pool.check()
        m.index.check()
    eng.check_paged()
    if not eng.stats["preempted"]:
        raise SmokeFailure(f"14c: no preemption: {dict(eng.stats)}")
    if not (launches["paged_decode"] and launches["paged_window"]):
        raise SmokeFailure(f"14c: K4/K5 did not launch: {launches}")
    if any(ref_launches.values()):
        raise SmokeFailure(f"14c: the einsum engine launched {ref_launches}")
    if None in storm or not all(h.ok for h in handles + storm):
        raise SmokeFailure("14c: a request did not complete")
    route = {"low": None, "low-twin": "twin", "low-medium": "medium",
             "high": None}
    allp, both = prompts + [h.prompt for h in storm], handles + storm
    groups = []
    for name in (None, "twin", "medium"):
        pick = [i for i, h in enumerate(both) if route[h.tenant] == name]
        groups.append((name or "default", models[name],
                       [allp[i] for i in pick], [both[i] for i in pick],
                       [(ref + ref_storm)[i] for i in pick]))
    agree_by_model(torch, np, groups, "14c tenancy")
    pools = eng.metrics()["page_pools"]
    print(f"14c tenancy engine (kernel, decode_fuse {P14_FUSE}): "
          f"{len(handles) + len(storm)} requests in {wall:.2f}s (einsum "
          f"single steps {ref_wall:.2f}s); preempted "
          f"{eng.stats['preempted']}, page-pressure vacates "
          f"{eng.stats['page_pressure_vacates']}, fused windows "
          f"{eng.stats['fused_windows']}; launches {launches}; pools "
          f"{[(p['num_pages'], p['page_bytes']) for p in pools]} (pages, "
          f"bytes a page; the small models share the first)", flush=True)
    for name, st in eng.tenant_stats.items():
        own = [h for h in handles + storm if h.tenant == name]
        ttft = sorted(h.token_times[0] - h.submit_time for h in own)
        print(f"14c tenant {name}: {st['tokens'] / wall:.1f} tokens/s, TTFT "
              f"p50 {1e3 * ttft[len(ttft) // 2]:.1f} ms, preempted "
              f"{st['preempted']}, readmitted {st['readmitted']}",
              flush=True)
    return launches


def prefix_cache_path(torch, np, small, seed: int) -> None:
    """14d: the dense engine with ``prefix_cache_blocks`` on
    shared-prefix traffic, one request at a time, against the engine
    without the cache: tokens agree, the cache hits, and the prefill ms
    saved (the requests' summed TTFT, cold minus cached) is printed."""
    from tpudp_torch.serve import Engine

    vocab = small.config.vocab_size
    rng = np.random.default_rng(seed + 15)
    shared = rng.integers(0, vocab, size=P14_PREFIX).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, size=n)
                               .astype(np.int32)])
               for n in rng.integers(5, 60, size=P14_TAILS)]
    runs = {}
    for blocks in (P14_BLOCKS, 0):
        eng = Engine(small, device="cuda", num_slots=1, prefill_chunk=16,
                     prefix_cache_blocks=blocks)
        handles = []
        for p in prompts:
            handles.append(eng.submit(p, P14_NEW))
            eng.run_until_complete()
        torch.cuda.synchronize()
        ttft = [1e3 * (h.token_times[0] - h.submit_time) for h in handles]
        runs[blocks] = (eng, handles, ttft)
    eng, handles, ttft = runs[P14_BLOCKS]
    _, ref, cold = runs[0]
    if eng.stats["prefix_hit_tokens"] <= 0:
        raise SmokeFailure(f"14d: no prefix hit: {dict(eng.stats)}")
    eng.prefix_cache.check()
    agree_by_model(torch, np, [("GPT-2 small", small, prompts, handles,
                                ref)], "14d prefix cache")
    saved = sum(cold[1:]) - sum(ttft[1:])
    print(f"14d dense prefix cache: hit tokens "
          f"{eng.stats['prefix_hit_tokens']}, published blocks "
          f"{eng.stats['prefix_published_blocks']}, prefill chunks "
          f"{eng.stats['prefill_chunks']} (no cache "
          f"{runs[0][0].stats['prefill_chunks']}); TTFT of the "
          f"{P14_TAILS - 1} warm requests {sum(ttft[1:]):.1f} ms against "
          f"{sum(cold[1:]):.1f} ms: prefill ms saved {saved:.1f}",
          flush=True)


def gather_path(torch, np, pa, small, prompts) -> None:
    """14e: ``paged_attn='gather'`` at GPT-2 small on phase 4's traffic
    against ``'einsum'``: tokens agree and no kernel launches."""
    from tpudp_torch.serve import Engine

    for fn in pa.KERNELS.values():
        fn.launches = 0
    eng, handles, wall, _ = serve(torch, Engine, small, prompts, "gather")
    _, ref, ref_wall, _ = serve(torch, Engine, small, prompts, "einsum")
    if any(fn.launches for fn in pa.KERNELS.values()):
        raise SmokeFailure("14e: the gather engine launched a kernel")
    if eng.metrics()["paged_attn"]["dispatch"]["decode_paged"] != "gather":
        raise SmokeFailure(f"14e: {eng.metrics()['paged_attn']}")
    agree_by_model(torch, np, [("GPT-2 small", small, prompts, handles,
                                ref)], "14e gather")
    print(f"14e gather engine: {serve_summary(handles, wall)} (einsum "
          f"{serve_summary(ref, ref_wall)})", flush=True)


def phase14_path(torch, np, pa, fa, small, prompts, seed: int):
    """Phase 14, 14a-14e; returns (14a's flash counts, 14c's paged
    counts)."""
    t0 = time.perf_counter()
    flash = train_sample_path(torch, np, fa, seed)
    torch.cuda.empty_cache()
    medium = generate_path(torch, np, seed)
    paged = tenancy_path(torch, np, pa, small, medium, seed)
    del medium
    torch.cuda.empty_cache()
    prefix_cache_path(torch, np, small, seed)
    gather_path(torch, np, pa, small, prompts)
    torch.cuda.empty_cache()
    print(f"phase 14 {time.perf_counter() - t0:.1f}s", flush=True)
    return flash, paged


# -- phase 15: disaggregated serving and the obs layer --------------------


class WireMeter:
    """A transfer tap on the faults' ``on_send`` seam: every blob passes
    unchanged and its bytes are counted."""

    def __init__(self):
        self.bytes = 0
        self.blobs = 0

    def on_send(self, rank, seq, blob):
        self.bytes += len(blob)
        self.blobs += bool(blob)
        return blob


class OneShot:
    """A transfer fault armed for the first blob it changes, then inert:
    one round of it."""

    def __init__(self, inner):
        self.inner = inner

    @property
    def fired(self):
        return self.inner.fired

    def on_send(self, rank, seq, blob):
        return blob if self.inner.fired else self.inner.on_send(rank, seq,
                                                                 blob)


def p15_engine(Engine, model, **kw):
    """Phase 4's paged kernel engine with phase 4e's window length."""
    return Engine(model, device="cuda", num_slots=8, prefill_chunk=16,
                  kv_pages=512, decode_fuse=FUSE, **kw)


def p15_prompts(np, seed: int, vocab: int) -> list:
    """Phase 4's eight prompts and four more of its lengths from the next
    seed: 17-300 tokens."""
    return (make_prompts(np, seed, vocab)
            + make_prompts(np, seed + 1, vocab)[:P15_REQUESTS - 8])


def p15_reference(torch, Engine, model, prompts, **kw):
    """One engine serving every prompt (P15_NEW tokens): its handles and
    tokens/s."""
    eng = p15_engine(Engine, model, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(p, P15_NEW) for p in prompts]
    eng.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.check_paged()
    if not all(h.ok and len(h.tokens) == P15_NEW for h in handles):
        raise SmokeFailure("15a: a reference request did not complete")
    return handles, sum(len(h.tokens) for h in handles) / wall


def tally_steps(pa, eng, tally: dict) -> None:
    """Count the paged kernels ``eng``'s own steps launch into ``tally``
    (the launch counters are process-wide)."""
    step = eng.step

    def counted():
        before = {n: fn.launches for n, fn in pa.KERNELS.items()}
        try:
            return step()
        finally:
            for n, fn in pa.KERNELS.items():
                tally[n] = tally.get(n, 0) + fn.launches - before[n]

    eng.step = counted


def timed_calls(obj, name: str, record: list, per=lambda a: 1) -> None:
    """Record ``(seconds, items)`` of every call of ``obj.name``."""
    fn = getattr(obj, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        record.append((time.perf_counter() - t0, per(args)))
        return out

    setattr(obj, name, timed)


def per_item_ms(record) -> float:
    """The median ms a ticket over ``(seconds, tickets)`` records."""
    return p50([1e3 * s / n for s, n in record if n]) if record else \
        float("nan")


def cluster_path(torch, np, pa, model, prompts) -> dict:
    """15a: a prefill engine and two decode engines in a DisaggCluster,
    through a dropped, a corrupt and a slow transfer, a rebalance, a kill
    of decode host 2 and a canary quarantine of decode host 1 that
    evacuates; every request against the colocated kernel engine and the
    einsum engine.  Returns the colocated handles (15c's reference)."""
    from tpudp_torch.serve import DisaggCluster, Engine
    from tpudp_torch.serve import disagg as dg
    from tpudp_torch.serve.faults import (BitFlipLogits, CorruptPagePayload,
                                          DroppedTransfer, SlowLink)

    colocated, colocated_tps = p15_reference(torch, Engine, model, prompts)
    einsum, _ = p15_reference(torch, Engine, model, prompts,
                              paged_attn="einsum")
    meter = WireMeter()
    drop = OneShot(DroppedTransfer(rank=0, at_seqs=range(10 ** 6)))
    corrupt = OneShot(CorruptPagePayload(rank=0, at_seqs=range(10 ** 6)))
    slow = SlowLink(delay_s=P15_SLOW_S, rank=1)
    engines = [p15_engine(Engine, model,
                          canary_new_tokens=P15_CANARY_TOKENS)
               for _ in range(3)]
    tallies = [{} for _ in engines]
    exports, admits, packs = [], [], []
    for eng, tally in zip(engines, tallies):
        tally_steps(pa, eng, tally)
        timed_calls(eng, "export_ticket", exports)
        timed_calls(eng, "admit_ticket", admits)
    # retries 3: the first ticket's first attempt is dropped and its
    # second corrupted, so its third lands (JAX's default 2 would fall
    # back locally).
    cl = DisaggCluster(engines, prefill=0, retries=3,
                       faults=(meter, drop, corrupt, slow))
    real_pack = dg.pack_batch
    timed_calls(dg, "pack_batch", packs, per=lambda a: len(a[0]))
    inj = BitFlipLogits([P15_FLIP], vocab=model.config.vocab_size,
                        canary_only=True)
    stage, moves, killed_at = "handoff", [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        creqs = [cl.submit(p, P15_NEW) for p in prompts]
        while any(not c.done for c in creqs):
            if cl.ticks > P15_MAX_TICKS:
                raise SmokeFailure(f"15a: the cluster wedged after "
                                   f"{cl.ticks} ticks")
            cl.tick()
            handed = sum(e["kind"] == "handoff" for e in cl.events)
            if stage == "handoff" and handed >= P15_HANDOFFS and any(
                    c.host in (1, 2) and not c.done
                    and c.handle._slot is not None for c in creqs):
                moves = cl.rebalance(free_page_frac=1.1, max_moves=1)
                stage, rebalanced_at = "rebalanced", cl.ticks
            elif (stage == "rebalanced" and cl.ticks > rebalanced_at
                  and any(c.host == 2 and c.tokens and not c.done
                          for c in creqs)):
                cl.kill_host(2)
                stage, killed_at = "killed", cl.ticks
            elif stage == "killed" and any(
                    e["kind"] == "handoff" and e["to"] == 1
                    and e["tick"] == cl.ticks for e in cl.events):
                # A request just landed on host 1: arm its canary, whose
                # second run is flipped, so host 1 condemns itself while
                # it still holds that request.
                engines[1].token_fault_hook = inj
                engines[1].canary_every_s = 0.0
                stage = "canary"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dg.pack_batch = real_pack
    cl.check()
    kinds = [e["kind"] for e in cl.events]
    counts = {k: kinds.count(k) for k in ("handoff", "rebalance",
                                          "failover", "evacuate")}
    stats = [dict(e.stats) for e in engines]
    quarantined = sum(s.get("quarantined_transfers", 0) for s in stats)
    ok_moves = [m for m in moves if m["ok"]]
    problems = []
    if not (drop.fired and corrupt.fired and slow.fired):
        problems.append(f"faults fired: dropped {drop.fired}, corrupt "
                        f"{corrupt.fired}, slow {slow.fired}")
    if not quarantined:
        problems.append("no corrupt transfer was quarantined")
    if not ok_moves:
        problems.append(f"the rebalance moved nothing: {moves}")
    if cl.dead != {2} or not counts["failover"]:
        problems.append(f"the kill of host 2 failed over nothing "
                        f"(dead {cl.dead}, {counts})")
    if cl.quarantined != {1} or not counts["evacuate"]:
        problems.append(f"the canary quarantine evacuated nothing "
                        f"(quarantined {cl.quarantined}, {counts}, stage "
                        f"{stage})")
    if not all(c.ok and len(c.tokens) == P15_NEW for c in creqs):
        problems.append("a request did not complete")
    for k in (1, 2):
        if not (tallies[k].get("paged_decode") and
                tallies[k].get("paged_window")):
            problems.append(f"decode host {k} launched {tallies[k]}")
    if problems:
        raise SmokeFailure("15a: " + "; ".join(problems))
    handles = [tokens_of(c.tokens) for c in creqs]
    agree_with_plain(torch, np, model, prompts, handles, colocated,
                     "15a cluster", against="the colocated kernel engine")
    agree_with_plain(torch, np, model, prompts, handles, einsum,
                     "15a cluster", against="the einsum engine")
    tickets = sum(s.get("migrated_out", 0) for s in stats)
    pages = sum(s.get("migrated_in_pages", 0) for s in stats)
    n_tok = sum(len(c.tokens) for c in creqs)
    print(f"15a cluster: {len(creqs)} requests, {cl.ticks} ticks, events "
          f"{counts} (rebalance moves {moves}), faults fired: dropped "
          f"{drop.fired}, corrupt {corrupt.fired}, slow "
          f"{len(slow.fired)} transfers; quarantined transfers "
          f"{quarantined}, migration retries "
          f"{sum(s.get('migration_retries', 0) for s in stats)}, failed "
          f"{sum(s.get('migration_failed', 0) for s in stats)}; "
          f"check() clean", flush=True)
    print(f"15a cluster: {tickets} tickets, {pages} pages, "
          f"{meter.bytes / 1e6:.3f} MB moved in {meter.blobs} transfers; "
          f"ms a ticket (median): export {per_item_ms(exports):.3f}, pack "
          f"{per_item_ms(packs):.3f}, admit {per_item_ms(admits):.3f}; "
          f"{n_tok} tokens in {wall:.3f}s = {n_tok / wall:.1f} tokens/s "
          f"(colocated kernel engine {colocated_tps:.1f})", flush=True)
    print(f"15a cluster: paged kernel launches by host (0 prefill, 1 and 2 "
          f"decode: every request there was adopted, host 1's canaries "
          f"aside) {tallies}", flush=True)
    return colocated


def int8_migration_path(torch, np, pa, seed: int) -> None:
    """15b: LLaMA-GQA over int8 pools at phase 4c's geometry: a request
    exported mid-stream, over the wire format, admitted on a second
    engine, against its unmigrated run."""
    from tpudp_torch.models import llama
    from tpudp_torch.serve import Engine
    from tpudp_torch.serve.disagg import pack_batch, unpack_batch

    cfg = llama.LlamaConfig(**LLAMA_GQA)
    model = llama.build(cfg, seed, "cuda")
    prompt = make_prompts(np, seed, cfg.vocab_size)[0]
    kw = dict(device="cuda", num_slots=8, prefill_chunk=16, kv_pages=512,
              kv_dtype="int8")
    ref = Engine(model, **kw)
    want = ref.submit(prompt, P15_INT8_NEW)
    ref.run_until_complete()
    src, dst = Engine(model, **kw), Engine(model, **kw)
    h = src.submit(prompt, P15_INT8_NEW)
    for _ in range(P15_INT8_STEPS):
        src.step()
    if not h.tokens or h.done:
        raise SmokeFailure(f"15b: the request is not mid-stream after "
                           f"{P15_INT8_STEPS} steps ({len(h.tokens)} tokens)")
    t = src.export_ticket(h)
    blob = pack_batch([(1, t)], seq=0, src=0)
    (_, ticket), = unpack_batch(blob)[2]
    before = {n: fn.launches for n, fn in pa.KERNELS.items()}
    h2 = dst.admit_ticket(ticket)
    dst.run_until_complete()
    launches = {n: fn.launches - before[n] for n, fn in pa.KERNELS.items()}
    src.run_until_complete()
    src.check_paged()
    dst.check_paged()
    fields = {k: (str(v.dtype), v.shape) for k, v in t.pages[0].items()}
    if not (h2.ok and launches["paged_decode_int8"]
            and launches["paged_window_int8"] and not launches["paged_decode"]
            and not launches["paged_window"]):
        raise SmokeFailure(f"15b: the receiver launched {launches} "
                           f"(ok {h2.ok})")
    if dst.stats["prefix_hit_tokens"] < 16 * len(t.pages) or \
            set(fields) != {"k", "v", "k_scale", "v_scale"}:
        raise SmokeFailure(f"15b: pages {fields} were not adopted: "
                           f"{dict(dst.stats)}")
    print(f"15b int8: LLaMA-GQA request of {prompt.size} prompt tokens "
          f"exported after {len(t.tokens)} tokens with {len(t.pages)} int8 "
          f"pages {fields} ({len(blob)} bytes on the wire), admitted: "
          f"prefix hit {dst.stats['prefix_hit_tokens']} tokens; receiver "
          f"launches {launches}", flush=True)
    agree_with_plain(torch, np, model, [prompt], [h2], [want], "15b int8",
                     "int8", against="the unmigrated engine")
    del model, ref, src, dst
    torch.cuda.empty_cache()


def disagg_rank(rank: int, world: int, init_method: str, seed: int,
                flight: str, results) -> None:
    """15c: one of two gloo ranks on the card, each a paged kernel engine
    at GPT-2 small: rank 0 prefills 15a's first P15_RANK_PROMPTS prompts
    and stages each request after its first token, rank 1 decodes; both
    run ``DisaggHost.round`` until the joint done.  Rank 0's first
    non-empty transfer is bit-flipped on the wire."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    out = {"rank": rank}
    try:
        from tpudp_torch.models import gpt2
        from tpudp_torch.serve import Engine
        from tpudp_torch.serve.disagg import DisaggHost
        from tpudp_torch.serve.faults import CorruptPagePayload

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world, rank=rank)
        cfg = gpt2.GPT2Config()
        model = gpt2.build(cfg, seed, "cuda")
        eng = p15_engine(Engine, model,
                         flight_dir=os.path.join(flight, f"rank{rank}"))
        corrupt = OneShot(CorruptPagePayload(rank=0, at_seqs=range(10 ** 6)))
        host = DisaggHost(eng, rank=rank, n_hosts=world,
                          role="prefill" if rank == 0 else "decode",
                          faults=(corrupt,) if rank == 0 else ())
        admitted = []
        host.on_admit = lambda src, t, r: admitted.append(r)
        prompts = p15_prompts(np, seed, cfg.vocab_size)[:P15_RANK_PROMPTS]
        handles = [eng.submit(p, P15_NEW) for p in prompts] if rank == 0 \
            else []
        staged = set()
        t0 = time.perf_counter()
        for rounds in range(1, P15_MAX_TICKS + 1):
            eng.step()
            for h in handles:
                if (h.id not in staged and h.tokens and not h.done
                        and h._nfill == h._fill.size and h._slot is not None):
                    host.stage(1, h)
                    staged.add(h.id)
            done = (eng.slots_in_use == 0 and eng.queue_depth == 0
                    and host.pending == 0
                    and (rank != 0 or len(staged) == len(prompts)))
            if host.round(done=done):
                break
        else:
            raise RuntimeError("the rounds never reached a joint done")
        eng.check_paged()
        out.update(rounds=rounds, wall=time.perf_counter() - t0,
                   stats=dict(eng.stats),
                   spans=sorted(eng.metrics()["spans"]),
                   flight_dumps=eng.flight.dumps,
                   fired=list(corrupt.fired),
                   tokens={int(r.id): (r.prompt.tolist(), list(r.tokens),
                                       r.ok) for r in admitted})
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        results.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def two_process_path(torch, np, model, prompts, colocated, seed: int):
    """15c: ``DisaggHost.round`` over two gloo processes sharing the card;
    the corrupt transfer quarantined on the receiver with a flight
    record; the migrated tokens against 15a's colocated engine."""
    import tempfile

    flight = tempfile.mkdtemp(prefix="tpudp-p15-flight-")
    try:
        t0 = time.perf_counter()
        r0, r1 = run_ranks(disagg_rank, (seed, flight), P15_RANK_LIMIT,
                           "15c two-process")
        wall = time.perf_counter() - t0
        dumps = sorted(os.listdir(os.path.join(flight, "rank1"))) \
            if os.path.isdir(os.path.join(flight, "rank1")) else []
    finally:
        shutil.rmtree(flight, ignore_errors=True)
    got = [r1["tokens"][k] for k in sorted(r1["tokens"])]
    by_prompt = {tuple(p): (tokens, ok) for p, tokens, ok in got}
    problems = []
    if len(got) != P15_RANK_PROMPTS or not all(ok for _, _, ok in got):
        problems.append(f"rank 1 admitted {len(got)} requests")
    if not r0["fired"] or not r1["stats"].get("quarantined_transfers"):
        problems.append(f"the corrupt transfer was not quarantined "
                        f"(fired {r0['fired']}, rank 1 {r1['stats']})")
    if not any("transfer_quarantined" in n for n in dumps):
        problems.append(f"rank 1 left no transfer_quarantined flight "
                        f"record: {dumps}")
    if not {"migrate_offer_phase", "migrate_transfer",
            "migrate_adopt"} <= set(r1["spans"]):
        problems.append(f"rank 1's spans {r1['spans']}")
    if problems:
        raise SmokeFailure("15c: " + "; ".join(problems))
    handles = [tokens_of(by_prompt[tuple(p.tolist())][0])
               for p in prompts[:P15_RANK_PROMPTS]]
    agree_with_plain(torch, np, model, prompts[:P15_RANK_PROMPTS], handles,
                     colocated[:P15_RANK_PROMPTS], "15c two-process",
                     against="15a's colocated kernel engine")
    print(f"15c two-process: 2 gloo ranks on one card, {r0['rounds']} "
          f"rounds in {r0['wall']:.2f}s (the call {wall:.1f}s); rank 0 "
          f"migrated_out {r0['stats'].get('migrated_out')}, retries "
          f"{r0['stats'].get('migration_retries')}; rank 1 migrated_in "
          f"{r1['stats'].get('migrated_in')}, quarantined transfers "
          f"{r1['stats'].get('quarantined_transfers')}, flight records "
          f"{dumps}", flush=True)


@contextlib.contextmanager
def counters_off():
    """The engine's device counters stubbed out: ``add_counts`` a no-op in
    the step functions and in the windows an engine captures inside the
    block (15d's arm without them, a timing arm only)."""
    from tpudp_torch.serve import engine, fused

    real = fused.add_counts
    engine.add_counts = fused.add_counts = lambda *args, **kwargs: None
    try:
        yield
    finally:
        engine.add_counts = fused.add_counts = real


def counters_cost(torch) -> tuple[float, float]:
    """The device counters' own cost at 15d's eight slots: device ms of
    one fused window iteration's ``add_counts`` captured alone in a CUDA
    graph, and wall ms of the eager decode step's call (its launches
    submitted, then one synchronize over ``n`` calls)."""
    from tpudp_torch.serve.fused import add_counts
    from tpudp_torch.serve.engine import OBS_DEVICE_COUNTERS

    counts = torch.zeros(len(OBS_DEVICE_COUNTERS), dtype=torch.float32,
                         device="cuda")
    running = torch.ones(8, dtype=torch.bool, device="cuda")
    toks = torch.arange(8, device="cuda")
    eos = torch.full((8,), -1, device="cuda")

    def window_row():
        add_counts(counts, running.any(), running, running,
                   eos_exits=running & (toks == eos))

    graph_ms = graph_device_ms(torch, window_row)
    n = 200
    for _ in range(10):
        add_counts(counts, running.any(), running, running)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        add_counts(counts, running.any(), running, running)
    torch.cuda.synchronize()
    return graph_ms, 1e3 * (time.perf_counter() - t0) / n


def obs_path(torch, np, pa, model, prompts) -> dict:
    """15d: phase 4e's greedy traffic in three arms, in turns (A B C C B
    A): ``obs=True``, ``obs=False`` (the device counters run in both, as
    in JAX) and ``obs=False`` with the counters stubbed out; the device
    counters against the host stats; the counters' own device and host
    cost; a contained fault's flight record; the Chrome trace and the
    Prometheus text read back.  Returns the K4 launches of the runs."""
    import tempfile

    from tpudp_torch import obs
    from tpudp_torch.serve import Engine
    from tpudp_torch.serve.faults import InjectedFault

    arms = ("on", "off", "bare")
    runs, launched = {arm: [] for arm in arms}, {}
    for arm in arms + arms[::-1]:
        with (counters_off() if arm == "bare" else contextlib.nullcontext()):
            run = serve_fused(torch, Engine, model, prompts, pa, FUSE,
                              obs=arm == "on")
        for name, n in run[3].items():
            launched[name] = launched.get(name, 0) + n
        runs[arm].append(run)
    base = [h.tokens for h in runs["on"][0][1]]
    for arm in arms:
        for eng, handles, wall, launches, _, _ in runs[arm]:
            if [h.tokens for h in handles] != base:
                raise SmokeFailure(f"15d: the {arm} arm changed the tokens")
    for eng, *_ in runs["bare"]:
        if any(eng.metrics()["device_counters"].values()):
            raise SmokeFailure("15d: the counters were not stubbed out")
    eng, handles, _, launches, _, _ = runs["on"][0]
    check_fused_run(eng, handles, launches, "paged_decode", "15d obs=True")
    m, st = eng.metrics(), eng.stats
    dev = m["device_counters"]
    want = {"steps": st["decode_steps"] + st["fused_steps"],
            "tokens": st["tokens"] - len(handles),
            "slot_steps": st["active_slot_steps"], "draft_accepted": 0,
            "eos_exits": 0}
    if dev != {k: float(v) for k, v in want.items()}:
        raise SmokeFailure(f"15d: device counters {dev}, host stats say "
                           f"{want}")

    def iter_ms(windows):
        iters = sum(r for _, r in windows)
        return sum(ms for ms, _ in windows) / iters if iters else float("nan")

    tps = {arm: [round(sum(len(h.tokens) for h in r[1]) / r[2], 1)
                 for r in rs] for arm, rs in runs.items()}
    ims = {arm: [round(iter_ms(r[5]), 3) for r in rs]
           for arm, rs in runs.items()}
    graph_ms, eager_ms = counters_cost(torch)
    print(f"15d obs: 8 requests x {FUSE_NEW_TOKENS} tokens, decode_fuse "
          f"{FUSE}, arms in turns on, off, bare, bare, off, on (on: "
          f"obs=True; off: obs=False, counters on; bare: obs=False, "
          f"counters stubbed out); tokens/s {tps}; wall ms per replayed "
          f"iteration {ims}; tokens identical; device counters {dev} = "
          f"host stats (fused steps {st['fused_steps']} over "
          f"{m['fused_window']['replays']} graph replays, single decode "
          f"steps {st['decode_steps']}); spans {m['spans']}", flush=True)
    print(f"15d counters: one window iteration's add_counts {graph_ms:.5f} "
          f"device ms (captured alone); an eager decode step's "
          f"{eager_ms:.5f} wall ms a call", flush=True)
    trace = json.loads(json.dumps(obs.to_chrome_trace(eng.obs)))
    back = obs.spans_from_chrome_trace(trace)
    snap = eng.obs.snapshot()
    if [(r["kind"], r["name"]) for r in back] != [
            (r["kind"], r["name"]) for r in snap]:
        raise SmokeFailure("15d: the Chrome trace does not read back")
    text = obs.prometheus_text(m)
    series = {}
    for line in text.splitlines():
        if not line.startswith("#"):
            name, value = line.split(" ")
            series[name] = float(value)
    if any(series.get(f"tpudp_device_counters_{k}") != v
           for k, v in dev.items()):
        raise SmokeFailure("15d: the Prometheus text does not read back")
    flight = tempfile.mkdtemp(prefix="tpudp-p15-obs-")
    fired = []

    def fault_once(kind, index):
        if kind == "fused_decode" and not fired:
            fired.append(index)
            raise InjectedFault(f"injected step fault at {kind} call "
                                f"{index}")

    try:
        f_eng = Engine(model, device="cuda", num_slots=8, prefill_chunk=16,
                       kv_pages=512, decode_fuse=FUSE,
                       step_fault_hook=fault_once, flight_dir=flight)
        fh = [f_eng.submit(p, FUSE_NEW_TOKENS) for p in prompts]
        f_eng.run_until_complete()
        f_eng.check_paged()
        names = os.listdir(flight)
        doc = json.load(open(os.path.join(flight, names[0]))) \
            if len(names) == 1 else {}
    finally:
        shutil.rmtree(flight, ignore_errors=True)
    spans = [s["name"] for s in doc.get("spans", [])]
    if not (fired and f_eng.stats["step_failures"] == 1
            and doc.get("reason") == "step_failure"
            and spans[-2:] == ["fused_decode", "containment"]):
        raise SmokeFailure(f"15d: the contained fault's flight record is "
                           f"{names}: {spans[-3:]}")
    print(f"15d obs: {len(trace['traceEvents'])} Chrome trace events and "
          f"{len(series)} Prometheus series read back; a fault at fused "
          f"window call {fired[0]} contained: flight record {names[0]} "
          f"(last spans {spans[-2:]}, {len(spans)} records)", flush=True)
    # The survivors re-prefill their tokens into the reset pool: the
    # near-tie rule, as for any prefill against decode.
    agree_with_plain(torch, np, model, prompts, fh, runs["on"][0][1],
                     "15d contained fault", against="the unfaulted run")
    return launched


def phase15_path(torch, np, pa, model, seed: int) -> dict:
    """Phase 15, 15a-15d; returns the paged kernels' launches of the
    phase in this process (15c's ranks count their own)."""
    from tpudp_torch.models import gpt2

    t0 = time.perf_counter()
    before = {n: fn.launches for n, fn in pa.KERNELS.items()}
    prompts = p15_prompts(np, seed, gpt2.GPT2Config().vocab_size)
    colocated = cluster_path(torch, np, pa, model, prompts)
    torch.cuda.empty_cache()
    int8_migration_path(torch, np, pa, seed)
    two_process_path(torch, np, model, prompts, colocated, seed)
    launches = {n: fn.launches - before[n] for n, fn in pa.KERNELS.items()}
    # 15d's runs zero the counters as phase 4e's do: their own counts.
    for name, n in obs_path(torch, np, pa, model, prompts[:8]).items():
        launches[name] += n
    torch.cuda.empty_cache()
    print(f"phase 15 paged kernel launches {launches}; phase 15 "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return launches


# -- phase 16: SDC defense, replica verification, skip_nonfinite under a
#    schedule, the elastic relaunch ---------------------------------------

_P16_WEIGHTS: dict = {}


def p16_model(torch, seed: int | None):
    """GPT-2 small at full width on the card: float32 parameters from
    ``random_params(seed)`` (drawn once a process; with ``seed=None``
    torch's own initialization, for a model a restore overwrites), bf16
    matmuls and flash attention (K1-K3)."""
    from tpudp_torch.models import gpt2

    cfg = gpt2.GPT2Config(max_seq_len=P16_T, dtype=torch.bfloat16,
                          attn_impl="flash")
    with torch.device("cuda"):
        model = gpt2.GPT2(cfg)
    if seed is None:
        return model
    if seed not in _P16_WEIGHTS:
        _P16_WEIGHTS[seed] = gpt2.params_from_jax(gpt2.random_params(cfg,
                                                                     seed))
    model.load_state_dict(_P16_WEIGHTS[seed])
    return model


class P16Tokens:
    """This rank's rows of the global batches of P16_BATCH x P16_T tokens
    over a synthetic set of P16_SEQS sequences, in the contiguous layout
    (``ShardedSampler(batch_contiguous=P16_BATCH)``): the same global
    batches at any number of ranks."""

    def __init__(self, np, rank: int, world: int, seed: int):
        from tpudp_torch.data import ShardedSampler

        rng = np.random.default_rng(seed + 16)
        self.tokens = rng.integers(0, 50_257, size=(P16_SEQS, P16_T + 1))
        self.sampler = ShardedSampler(P16_SEQS, world, rank, shuffle=True,
                                      seed=seed, batch_contiguous=P16_BATCH)
        self.per = P16_BATCH // world
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        import torch

        idx = self.sampler.indices(self.epoch)
        for b in range(len(self)):
            rows = self.tokens[idx[b * self.per:(b + 1) * self.per]]
            yield (torch.as_tensor(rows[:, :-1]),
                   torch.as_tensor(rows[:, 1:]),
                   torch.ones(self.per, dtype=torch.float32))

    def __len__(self):
        return len(self.sampler) // self.per


def p16_setup(torch, rank: int, world: int, init_method: str):
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)


def p16_timers():
    """Wall seconds of the supervisor's restores and SDC gathers and of
    the Trainer's replica checks in this process, and the time of each
    recorded event (patched in the ranks' processes only)."""
    from tpudp_torch import resilience
    from tpudp_torch.trainer import Trainer

    got = {"restore": [], "gather": [], "verify": [], "events": []}
    Sup = resilience.Supervisor

    def timed(name, fn):
        def wrapper(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **kw)
            finally:
                got[name].append(time.perf_counter() - t0)
        return wrapper

    record = Sup.record

    def stamped(self, kind, **fields):
        got["events"].append((kind, time.perf_counter()))
        return record(self, kind, **fields)

    Sup._restore_verified = timed("restore", Sup._restore_verified)
    Sup._sdc_gather = timed("gather", Sup._sdc_gather)
    Sup.record = stamped
    Trainer._verify_replicas = timed("verify", Trainer._verify_replicas)
    return got


def p16_digest(torch, model) -> str:
    """A hash of the parameters' bytes (on the host)."""
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def p16_sdc_rank(rank: int, world: int, init_method: str, seed: int,
                 tmp: str, results) -> None:
    """16a: one of three gloo ranks on the card.  The clean run, the
    one-shot flip, the desync and the persistent flip, each a fresh
    model and Trainer; a report a run (rank 1 leaves the persistent run
    with SDC_QUARANTINE_EXIT).  The first three check the replicas after
    each epoch (``verify_replicas``); the desync flips a bit with no SDC
    check, so that check raises."""
    import numpy as np
    import torch

    p16_setup(torch, rank, world, init_method)
    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.ops import flash_attention as fa
    from tpudp_torch.resilience import ResiliencePolicy
    from tpudp_torch.sdc import BitFlipParams, SdcPersistentError
    from tpudp_torch.trainer import Trainer
    from tpudp_torch.utils.consistency import ReplicaDivergenceError

    timers = p16_timers()
    injectors = {"clean": lambda: None,
                 "transient": lambda: BitFlipParams([P16_FLIP]),
                 "desync": lambda: BitFlipParams([P16_DESYNC]),
                 "persistent": lambda: BitFlipParams(
                     persist_from=P16_PERSIST[0], replica=P16_PERSIST[1],
                     bit=P16_PERSIST[2])}
    for case, make in injectors.items():
        out = {"rank": rank, "case": case}
        try:
            for k in timers:
                timers[k].clear()
            lines: list = []
            t = Trainer(p16_model(torch, seed), make_mesh(), "allreduce",
                        learning_rate=0.01, log_every=P16_LOG_EVERY,
                        log_fn=lines.append, track_sdc_fingerprint=True,
                        sdc_fault_hook=make(),
                        verify_replicas=case != "persistent")
            loader = P16Tokens(np, rank, world, seed)
            for fn in fa.KERNELS.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                if case == "desync":  # no SDC check: one epoch
                    t.fit(loader, epochs=1)
                else:
                    t.fit(loader, epochs=P16_EPOCHS,
                          resilience=ResiliencePolicy(
                              checkpoint_dir=os.path.join(tmp, case),
                              sdc_check_every=P16_CHECK_EVERY))
            except SdcPersistentError as e:
                out["error"] = (type(e).__name__, e.replica)
            except ReplicaDivergenceError as e:
                out["error"] = (type(e).__name__, str(e))
            torch.cuda.synchronize()
            out.update(
                verify_lines=[x for x in lines
                              if "replica consistency" in x],
                verify_s=list(timers["verify"]),
                seconds=time.perf_counter() - t0,
                launches={k: fn.launches for k, fn in fa.KERNELS.items()},
                stats={k: v for k, v in t.stats.items() if k != "events"},
                events=[{k: v for k, v in e.items()
                         if k in ("kind", "replicas", "step", "localized")}
                        for e in t.stats.get("events", [])
                        if e["kind"] != "vote"],
                losses=[r["loss"] for r in t.records
                        if r["kind"] == "train_window"],
                step_s=[r["sec_per_iter"] for r in t.records
                        if r["kind"] == "train_window"],
                fp=train.sdc_fingerprint(t.state).tolist(),
                digest=p16_digest(torch, t.state.model),
                restore_s=list(timers["restore"]),
                gather_ms=[1e3 * s for s in timers["gather"]],
                event_times=list(timers["events"]))
            if case == "clean" and rank == 0:
                out["fp_ms"] = p16_fingerprint_ms(torch, train, t.state)
                out["fp_bytes"] = sum(
                    x.numel() * x.element_size() if not isinstance(x, int)
                    else x * 4 for x in train.fingerprint_tensors(
                        t.state.optimizer, list(t.state.model.parameters())))
            del t
            torch.cuda.empty_cache()
        except Exception:
            out["error_trace"] = traceback.format_exc()
        results.put(out)
    # Rank 1 has left: no collective teardown; the queue is flushed first.
    results.close()
    results.join_thread()
    sys.stdout.flush()
    os._exit(0)


def p16_fingerprint_ms(torch, train, state) -> float:
    """Device ms of one in-step fingerprint over the parameters and the
    momentum (the median of 5, CUDA events)."""
    ms = []
    for _ in range(6):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        train.sdc_fingerprint(state)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return float(sorted(ms[1:])[2])


def p16_relaunch_rank(rank: int, world: int, init_method: str, seed: int,
                      root: str, results) -> None:
    """16b: one of two gloo ranks resuming the clean run's ``step_1``
    through ``restore_newest`` and training epoch 2 at 6 rows a rank."""
    import numpy as np
    import torch
    import torch.distributed as dist

    p16_setup(torch, rank, world, init_method)
    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.ops import flash_attention as fa
    from tpudp_torch.resilience import restore_newest
    from tpudp_torch.trainer import Trainer

    out = {"rank": rank}
    try:
        t = Trainer(p16_model(torch, None), make_mesh(), "allreduce",
                    learning_rate=0.01, log_every=P16_LOG_EVERY,
                    log_fn=lambda line: None)
        t0 = time.perf_counter()
        used, _ = restore_newest(t, root, log=lambda line: None)
        restore_s = time.perf_counter() - t0
        loader = P16Tokens(np, rank, world, seed)
        start = t.state.step // len(loader)
        for fn in fa.KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        t.fit(loader, epochs=P16_EPOCHS, start_epoch=start)
        torch.cuda.synchronize()
        out.update(used=os.path.basename(used), start=start,
                   restore_s=restore_s,
                   seconds=time.perf_counter() - t0,
                   launches={k: fn.launches for k, fn in fa.KERNELS.items()},
                   losses=[r["loss"] for r in t.records
                           if r["kind"] == "train_window"])
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        results.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def p16_start(target, args: tuple, world: int):
    """``world`` ranks of ``target`` started; what :func:`p16_collect`
    takes."""
    import multiprocessing

    from tpudp_torch.mesh import free_port

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=target, args=(r, world, init, *args,
                                              results))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, results


def p16_collect(procs, results, limit: float, label: str):
    """Every report the ranks put and their exit codes.  Fails when a
    rank outlives ``limit`` seconds."""
    got, deadline = [], time.monotonic() + limit
    try:
        while any(p.is_alive() for p in procs) or not results.empty():
            try:
                got.append(results.get(timeout=1.0))
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise SmokeFailure(f"{label}: ranks still running after "
                                       f"{limit} s") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return got, [p.exitcode for p in procs]


def p16_spawn(target, args: tuple, world: int, limit: float, label: str):
    """``world`` ranks of ``target``; every report put and the ranks' exit
    codes.  Fails when a rank outlives ``limit`` seconds."""
    return p16_collect(*p16_start(target, args, world), limit, label)


def sdc_path(torch, np, seed: int, tmp: str) -> tuple[dict, str]:
    """16a (the module docstring); returns rank 0's K1-K3 launches of the
    clean run and the clean run's checkpoint root."""
    import json

    from tpudp_torch.sdc import QUARANTINE_MARKER, SDC_QUARANTINE_EXIT

    got, codes = p16_spawn(p16_sdc_rank, (seed, tmp), P16_RANKS,
                           P16_SDC_TIMEOUT, "16a")
    runs: dict = {}
    for r in got:
        if "error_trace" in r:
            raise SmokeFailure(f"16a rank {r['rank']} {r['case']} failed:\n"
                               f"{r['error_trace']}")
        runs.setdefault(r["case"], {})[r["rank"]] = r
    want_codes = [SDC_QUARANTINE_EXIT if r == P16_PERSIST[1] else 0
                  for r in range(P16_RANKS)]
    failures = []
    if codes != want_codes:
        failures.append(f"exit codes {codes}, want {want_codes}")
    clean, flip = runs.get("clean", {}), runs.get("transient", {})
    if len(clean) != P16_RANKS or len(flip) != P16_RANKS:
        raise SmokeFailure(f"16a: reports {sorted(runs)} / {codes}")
    c0 = clean[0]
    for case, by_rank in (("clean", clean), ("transient", flip)):
        for r, res in sorted(by_rank.items()):
            det = [e for e in res["events"] if e["kind"] == "sdc_detected"]
            print(f"16a {case} rank {r}: GPT-2 small bf16 flash, "
                  f"{P16_RANKS} gloo ranks on one card, global batch "
                  f"{P16_BATCH} x {P16_T}, {P16_EPOCHS} epochs of "
                  f"{P16_SEQS // P16_BATCH} steps: window losses "
                  f"{[round(x, 5) for x in res['losses']]}; stats "
                  f"{res['stats']}; detections "
                  f"{[(e['step'], e['replicas']) for e in det]}; "
                  f"fingerprint {res['fp']}; s a step by window "
                  f"{[round(x, 2) for x in res['step_s']]}; "
                  f"{res['seconds']:.1f}s; flash launches "
                  f"{res['launches']}", flush=True)
    for case, by_rank in (("clean", clean), ("transient", flip)):
        for r, res in sorted(by_rank.items()):
            ok = [x for x in res["verify_lines"]
                  if "replica consistency OK" in x]
            if len(ok) != P16_EPOCHS or len(ok) != len(res["verify_lines"]):
                failures.append(f"{case} rank {r}'s replica checks "
                                f"{res['verify_lines']}")
    print(f"16a verify_replicas on the card, 3 gloo ranks: clean "
          f"{clean[0]['verify_lines']}; wall s a check (rank 0) "
          f"{[round(x, 3) for x in clean[0]['verify_s']]}", flush=True)
    desync = runs.get("desync", {})
    pair = f"rank 0 vs rank {P16_DESYNC[1]}"
    for r in range(P16_RANKS):
        err = desync.get(r, {}).get("error")
        if err is None or err[0] != "ReplicaDivergenceError" or \
                "replicas diverged at leaf" not in err[1] or \
                pair not in err[1]:
            failures.append(f"desync rank {r}: {err}")
    print(f"16a desync (bit {P16_DESYNC[2]} flipped on rank "
          f"{P16_DESYNC[1]} at step {P16_DESYNC[0]}, no SDC check): every "
          f"rank raised {sorted({str(v.get('error')) for v in desync.values()})}"
          f"; wall s of the check (rank 0) "
          f"{[round(x, 3) for x in desync.get(0, {}).get('verify_s', [])]}",
          flush=True)
    for r, res in clean.items():
        if res["stats"]["sdc_checks"] < 1 or res["stats"]["sdc_detections"]:
            failures.append(f"clean rank {r}: {res['stats']}")
        if res["fp"] != c0["fp"] or res["digest"] != c0["digest"]:
            failures.append(f"clean rank {r}'s parameters differ from "
                            "rank 0's")
        if not all(res["launches"][k] for k in FLASH_KERNELS):
            failures.append(f"clean rank {r} launched {res['launches']}")
    victim = f"p{P16_FLIP[1]}"
    for r, res in flip.items():
        det = [e["replicas"] for e in res["events"]
               if e["kind"] == "sdc_detected"]
        st = res["stats"]
        if det != [[victim]] or st["sdc_transients"] != 1 or \
                st["rollbacks"] != 1:
            failures.append(f"transient rank {r}: detections {det}, {st}")
        if res["fp"] != c0["fp"] or res["digest"] != c0["digest"]:
            failures.append(f"transient rank {r}: final parameters not "
                            "bit-equal to the clean run's")
    persistent = runs.get("persistent", {})
    marker_path = os.path.join(tmp, "persistent", QUARANTINE_MARKER)
    marker = (json.load(open(marker_path)) if os.path.exists(marker_path)
              else None)
    bad = f"p{P16_PERSIST[1]}"
    if marker is None or marker["replicas"] != [bad]:
        failures.append(f"quarantine marker {marker}")
    for r in range(P16_RANKS):
        if r == P16_PERSIST[1]:
            continue
        res = persistent.get(r)
        if res is None or res.get("error") != ("SdcPersistentError",
                                                [bad]):
            failures.append(f"persistent rank {r}: "
                            f"{None if res is None else res.get('error')}")
    print(f"16a persistent: exit codes {codes}; marker {marker}; the "
          f"others raised "
          f"{sorted({str(v.get('error')) for v in persistent.values()})}",
          flush=True)
    t = flip[0]["event_times"]
    rb = next((s for k, s in t if k == "rollback"), None)
    tr = next((s for k, s in t if k == "sdc_transient"), None)
    gathers = sorted(g for res in clean.values() for g in res["gather_ms"])
    print(f"16a costs: one fingerprint {c0['fp_ms']:.4f} device ms over "
          f"{c0['fp_bytes'] / 1e6:.1f} MB of parameters and momentum (bound "
          f"{c0['fp_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); the SDC gather's wall ms "
          f"median {gathers[len(gathers) // 2]:.2f} (min {gathers[0]:.2f}, "
          f"max {gathers[-1]:.2f}, {len(gathers)} over 3 ranks); the "
          f"rollback's restore s {[round(x, 3) for x in flip[0]['restore_s']]}"
          f", replay to the transient verdict "
          f"{(tr - rb) if rb and tr else float('nan'):.2f} s; clean run "
          f"{c0['seconds']:.1f} s, transient {flip[0]['seconds']:.1f} s",
          flush=True)
    if failures:
        raise SmokeFailure(f"16a: {failures}")
    return c0["launches"], c0["losses"]


def relaunch_path(torch, np, seed: int, tmp: str, clean_losses) -> dict:
    """16b: the clean run's ``step_1`` (epoch 1's end) resumed at 2 ranks."""
    root = os.path.join(tmp, "relaunch")
    os.makedirs(root)
    src = os.path.join(tmp, "clean")
    for name in ("step_1", "step_1.manifest.json"):
        path = os.path.join(src, name)
        (shutil.copytree if os.path.isdir(path) else shutil.copy)(
            path, os.path.join(root, name))
    got, codes = p16_spawn(p16_relaunch_rank, (seed, root),
                           P16_RELAUNCH_RANKS, P16_SDC_TIMEOUT, "16b")
    got.sort(key=lambda r: r["rank"])
    for r in got:
        if "error" in r:
            raise SmokeFailure(f"16b rank {r['rank']} failed:\n{r['error']}")
    if codes != [0] * P16_RELAUNCH_RANKS or len(got) != P16_RELAUNCH_RANKS:
        raise SmokeFailure(f"16b: exit codes {codes}")
    a = got[0]
    want = clean_losses[len(clean_losses) - len(a["losses"]):]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], want))
    print(f"16b relaunch: {P16_RELAUNCH_RANKS} gloo ranks at "
          f"{P16_BATCH // P16_RELAUNCH_RANKS} rows each resumed "
          f"{a['used']} (epoch {a['start']}) in {a['restore_s']:.2f}s; "
          f"epoch 2's window losses {[repr(x) for x in a['losses']]} against "
          f"the 3-rank run's {[repr(x) for x in want]}: max relative "
          f"difference {rel:.3e} (rtol {P16_RELAUNCH_RTOL}); "
          f"{a['seconds']:.1f}s; flash launches {a['launches']}", flush=True)
    if a["used"] != "step_1" or a["start"] != 1 or rel > P16_RELAUNCH_RTOL \
            or got[1]["losses"] != a["losses"]:
        raise SmokeFailure(f"16b: {a['used']} epoch {a['start']}, losses "
                           f"{rel:.3e} from the 3-rank run's")
    return a["launches"]


P16_CLI_FLAGS = ["--device", "cpu", "--num-devices", "2", "--verify-replicas",
                 "--synthetic-train-size", "32", "--synthetic-test-size", "8",
                 "--batch-size", "32", "--prefetch", "0"]


def p16_cli_rank(rank: int, world: int, init_method: str, results) -> None:
    """16c: one of two gloo CPU ranks running the VGG-11 ladder's CLI
    (``run_part`` at ``--num-devices 2 --verify-replicas``, which trains
    over the process group this rank joined first, as a launcher's ranks
    do) on the ``allreduce`` rung and then on ``none``; a report a run:
    its log, its error and the port kernel launches this process made
    over it (``kernel_launches`` read before and after)."""
    import contextlib
    import io

    os.environ["OMP_NUM_THREADS"] = "2"
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    from tpudp_torch.cli import run_part
    from tpudp_torch.ops import flash_attention as fa
    from tpudp_torch.ops import paged_attention as pa

    for sync in ("allreduce", "none"):
        out = {"rank": rank, "sync": sync}
        before = kernel_launches(pa, fa)
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                run_part(sync, "16c", argv=P16_CLI_FLAGS)
        except (Exception, SystemExit) as e:
            out["error"] = f"{type(e).__name__}: {e}"
        after = kernel_launches(pa, fa)
        out.update(seconds=time.perf_counter() - t0, log=buf.getvalue(),
                   launches={k: after[k] - before[k] for k in after})
        results.put(out)
    dist.destroy_process_group()


def start_verify_cli():
    """16c's two ranks, started to run beside 16b and 16d."""
    return p16_start(p16_cli_rank, (), 2)


def finish_verify_cli(started) -> None:
    """16c's verdicts: the all-reduce rung logs ``replica consistency
    OK``, the ``none`` rung raises ReplicaDivergenceError naming a leaf on
    both ranks, and neither run launched a port kernel."""
    got, codes = p16_collect(*started, 2 * P16_CLI_TIMEOUT, "16c")
    runs = {(r["rank"], r["sync"]): r for r in got}
    failures = [] if codes == [0, 0] else [f"exit codes {codes}"]
    for sync in ("allreduce", "none"):
        for rank in range(2):
            r = runs.get((rank, sync))
            if r is None:
                failures.append(f"{sync} rank {rank}: no report")
                continue
            lines = r["log"].splitlines()
            ok = next((x for x in lines if "replica consistency OK" in x),
                      None)
            err = r.get("error") or ""
            if rank == 0:
                print(f"16c {sync} rank 0: {r['seconds']:.1f}s; "
                      f"{ok or err or r['log'][-2000:]}", flush=True)
            if sync == "allreduce" and (err or (rank == 0 and ok is None)):
                failures.append(f"allreduce rank {rank}: {err} "
                                f"{r['log'][-2000:]}")
            if sync == "none" and not err.startswith(
                    "ReplicaDivergenceError: replicas diverged at leaf"):
                failures.append(f"none rank {rank}: {err or 'no error'}")
            if any(r["launches"].values()):
                failures.append(f"{sync} rank {rank} launched "
                                f"{r['launches']}")
    launched = {f"{sync} rank {rank}": sum(r["launches"].values())
                for (rank, sync), r in sorted(runs.items())}
    print(f"16c: port kernel launches in the CLI's rank processes, read "
          f"before and after each run: {launched} (VGG-11 on gloo CPU "
          f"ranks)", flush=True)
    if failures:
        raise SmokeFailure(f"16c: {failures}")


def skip_schedule_path(torch, np, fa, seed: int) -> dict:
    """16d: GPT-2 small on one rank, ``skip_nonfinite=2`` under a cosine
    schedule; the gradients of step P16_NAN_STEP are made non-finite (a
    one-shot hook on ``wte``'s gradient: a token batch cannot carry a
    NaN).  The step is skipped (parameters bit-equal, counters on the
    card), and each step's learning rate, computed on the card from the
    held-back count, equals optax's formula at that count on the host.
    After every step the parameters are held to a reference: the same
    model under ``torch.optim.SGD`` at the float rate of optax's formula,
    stepped on the applied updates only (P16_SKIP_TOL)."""
    from tpudp_torch import train
    from tpudp_torch.sdc import fingerprint

    sched = dict(learning_rate=0.01, schedule="cosine", warmup_steps=0,
                 total_steps=P16_SKIP_STEPS)
    model = p16_model(torch, seed)
    spec = train.make_optimizer(**sched, skip_nonfinite=2)
    state = train.init_state(model, spec)
    step = train.make_train_step(model, spec)
    # the reference: no skip, so optimizer_update sets lr_at(its own
    # step), the count of applied updates, and calls torch.optim.SGD.step
    ref = p16_model(torch, seed)
    ref_spec = train.make_optimizer(**sched)
    ref_state = train.init_state(ref, ref_spec)
    ref_step = train.make_train_step(ref, ref_spec)
    if not isinstance(ref_state.optimizer, torch.optim.SGD):
        raise SmokeFailure(f"16d: the reference is {ref_state.optimizer}")
    rtol, atol = P16_SKIP_TOL
    loader = P16Tokens(np, 0, 1, seed)
    lrs, want, applied, failures, ref_err = [], [], 0, [], []
    launches = dict.fromkeys(fa.KERNELS, 0)
    for i, (x, y, _) in zip(range(P16_SKIP_STEPS), loader):
        x, y = x.cuda(), y.cuda()
        if i != P16_NAN_STEP:
            ref_state, _ = ref_step(ref_state, x, y)
        lrs.append(float(spec.lr_tensor(state.skip["schedule_count"])))
        want.append(spec.lr_at(applied))
        handle = None
        if i == P16_NAN_STEP:
            handle = model.wte.weight.register_hook(
                lambda g: g * float("nan"))
        before = fingerprint(list(model.parameters()))
        for fn in fa.KERNELS.values():  # the port's steps alone count
            fn.launches = 0
        state, loss = step(state, x, y)
        for k, fn in fa.KERNELS.items():
            launches[k] += fn.launches
        if handle is not None:
            handle.remove()
        moved = not torch.equal(before, fingerprint(list(model.parameters())))
        if moved == (i == P16_NAN_STEP):
            failures.append(f"step {i}: parameters moved {moved}")
        applied += i != P16_NAN_STEP
        worst, close = 0.0, True
        with torch.no_grad():
            for p, q in zip(model.parameters(), ref.parameters()):
                worst = max(worst, float((p - q).abs().max()))
                close = close and torch.allclose(p, q, rtol=rtol, atol=atol)
        ref_err.append(worst)
        if not close:
            failures.append(f"step {i}: parameters {worst:.3e} from "
                            "torch.optim.SGD's")
    counts = {k: int(v) for k, v in state.skip.items()}
    rel = max(abs(a - b) / max(b, 1e-12) for a, b in zip(lrs, want))
    print(f"16d skip_nonfinite=2 cosine: learning rates a step "
          f"{[f'{x:.6g}' for x in lrs]} against optax's at the held-back "
          f"count {[f'{x:.6g}' for x in want]} (max relative "
          f"{rel:.2e}, rtol 1e-6); counters {counts}; parameters against "
          f"torch.optim.SGD at those rates, max |diff| a step "
          f"{[f'{x:.3e}' for x in ref_err]} (rtol {rtol}, atol {atol}); "
          f"flash launches {launches}", flush=True)
    if rel > 1e-6 or counts["schedule_count"] != P16_SKIP_STEPS - 1 or \
            counts["total_notfinite"] != 1:
        failures.append(f"learning rates {rel:.2e}, counters {counts}")
    if not all(launches[k] for k in FLASH_KERNELS):
        failures.append(f"launches {launches}")
    if failures:
        raise SmokeFailure(f"16d: {failures}")
    return launches


def phase16_path(torch, np, pa, fa, seed: int) -> dict:
    """Phase 16, 16a-16d (16c's CLI runs beside 16b and 16d); returns the
    K1-K3 launches of 16a's clean run (rank 0), 16b (rank 0) and 16d."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p16_") as tmp:
        clean_launches, clean_losses = sdc_path(torch, np, seed, tmp)
        cli_runs = start_verify_cli()
        try:
            relaunch_launches = relaunch_path(torch, np, seed, tmp,
                                              clean_losses)
            skip_launches = skip_schedule_path(torch, np, fa, seed)
        finally:
            finish_verify_cli(cli_runs)
    torch.cuda.empty_cache()
    launches = {k: clean_launches[k] + relaunch_launches[k]
                + skip_launches[k] for k in FLASH_KERNELS}
    print(f"phase 16 flash launches {launches}; phase 16 "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return launches


# -- phase 17: the audit's card half ---------------------------------------

def audit_card_path(torch) -> None:
    """17: each single-process program of ``programs.py`` once on the
    card at its pinned geometry: its K1-K6 launches (a captured window's
    replays included) against the lock's ``kernels`` census; the peak
    memory and the synchronizations ``set_sync_debug_mode('warn')``
    reports, printed beside the lock's CPU ``peak_live_bytes`` and
    ``host_reads``."""
    import warnings

    from tpudp_torch.analysis import audit, programs

    t0 = time.perf_counter()
    lock = audit.load_lock(os.path.join(ROOT, audit.LOCK_PATH))
    built = programs.build_programs("cuda")
    failures, census = [], {}
    for name, (call, axes) in built.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rec = audit.capture_one(call, axes, kernel_attr="launches")
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        peak = torch.cuda.max_memory_allocated() - base
        want = lock["programs"][name]
        census[name] = rec["kernels"]
        print(f"audit {name}: launches {rec['kernels']} (lock "
              f"{want['kernels']}); host syncs {syncs} (lock host reads "
              f"{want['host_reads']}); peak {peak} bytes above the "
              f"program's state on the card (lock peak_live_bytes "
              f"{want['budget']['peak_live_bytes']} on the CPU)",
              flush=True)
        if rec["kernels"] != want["kernels"]:
            failures.append(f"{name}: launched {rec['kernels']}, the lock "
                            f"says {want['kernels']}")
    del built
    torch.cuda.empty_cache()
    print(f"audit: {len(census)} single-process programs on the card, "
          f"kernel census {'equal to' if not failures else 'NOT'} the "
          f"lock's (lock torch {lock['torch']}, here {torch.__version__}); "
          f"phase 17 {time.perf_counter() - t0:.1f}s", flush=True)
    if failures:
        raise SmokeFailure(f"audit: {failures}")


# -- phase 8: timing -------------------------------------------------------


def time_ms(torch, fn, n=50):
    """Three medians of ``n`` single-call timings each, after warm-up:
    ``(ms, device_ms, host_ms)``.  ``ms`` is read by CUDA events around
    the call as the host submits it to an idle device, so it holds the
    host's submission as well as the device time; ``device_ms`` by
    events around the call queued behind a device spin, so it holds the
    device time alone; ``host_ms`` by the host's clock around that queued
    call, the host's time to submit it (and to wait, if the call waits on
    the device).  Where a call's host work outlasts the spin, as the
    plain versions' may, ``device_ms`` holds some of it as well."""
    for _ in range(5):
        fn(0)
    torch.cuda.synchronize()
    times = ([], [], [])
    for spin in (False, True):
        for i in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            t0 = time.perf_counter()
            fn(i)
            host = time.perf_counter() - t0
            b.record()
            b.synchronize()
            times[spin].append(a.elapsed_time(b))
            if spin:
                times[2].append(1e3 * host)
    return tuple(sorted(x)[n // 2] for x in times)


def timed(prefix, readings) -> dict:
    """``time_ms``'s three readings under record keys: ``{prefix}ms``,
    ``{prefix}device_ms`` and ``{prefix}host_ms``."""
    return dict(zip((f"{prefix}ms", f"{prefix}device_ms", f"{prefix}host_ms"),
                    readings))


def timing_line(r, library: str) -> str:
    name = f"{r['name']} {r['case']}" if "case" in r else r["name"]
    return (f"timing {name}: {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f}, host {r['host_ms']:.4f}; bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms (device {r['plain_device_ms']:.4f}), "
            f"{library} {r['library_ms']:.4f} ms (device "
            f"{r['library_device_ms']:.4f}, host {r['library_host_ms']:.4f})")


def timing_case(torch, cfg, pos_list, cur, scalar, device, seed,
                kv_dtype=None):
    """Whole-pool inputs at the main path's shapes: a (layers, 513, 16,
    kv heads, dh) float32 pool — quantized by the port's quantizer for
    ``kv_dtype="int8"`` — and one table row per slot mapping distinct
    pages up to its depth.  Returns ``q, pages, table, pos`` (``pos`` a
    host int for a scalar depth, else an int32 tensor on the card)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    page_tokens, max_pages, n_pages = 16, 64, 512
    h, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    kvh = getattr(cfg, "kv_heads", h)
    b = len(pos_list)
    gd = torch.Generator(device=device).manual_seed(seed)
    shape = (cfg.num_layers, n_pages + 1, page_tokens, kvh, dh)
    k = torch.randn(shape, generator=gd, device=device)
    v = torch.randn(shape, generator=gd, device=device)
    perm = torch.randperm(n_pages, generator=g).tolist()
    table = torch.full((b, max_pages), -1, dtype=torch.int32)
    for s, p in enumerate(pos_list):
        for i in range((p + cur - 1) // page_tokens + 1):
            table[s, i] = perm.pop()
    q = torch.randn((b, cur, h, dh), generator=gd, device=device)
    # A prefill chunk's depth is a host int, as the engine passes it.
    pos = (pos_list[0] if scalar
           else torch.tensor(pos_list).to(device, torch.int32))
    pages = ((k, v) if kv_dtype is None
             else int8_pool(torch, k, v, (slice(None), 0, 0, 0)))
    return q, pages, table.to(device), pos


def kernel_record(torch, F, pa, name, q, pages, table, pos, launches):
    """Time kernel ``name``, its plain version and SDPA on the same
    inputs, cycling the layer so successive launches read other pages
    (as a forward does); bound from the bytes and flops these inputs
    need."""
    layers = pages[0].shape[0]
    fn = pa.KERNELS[name]
    b, cur, h, dh = q.shape
    page_tokens, kvh = pages[0].shape[2], pages[0].shape[3]
    pos_v = torch.as_tensor(pos, device=q.device).expand(b)
    pos_l = pos_v.tolist()

    def layer_of(i):
        return tuple(buf[i % layers] for buf in pages)

    ms = time_ms(torch, lambda i: fn(q, *pages, table, pos,
                                     layer=i % layers))
    plain_ms = time_ms(torch, lambda i: pa._einsum_paged(
        q, layer_of(i), table, pos, dtype=q.dtype, grouped=True))
    # SDPA yardstick on K/V gathered (dequantized, KV heads expanded to
    # the query heads) outside the timing to dense rows.
    n_keys = max(pos_l) + cur
    dense_k, dense_v = [], []
    for layer in range(layers):
        kt, vt = pa.page_tiles(layer_of(layer), table, q.dtype)
        for dense, t in ((dense_k, kt), (dense_v, vt)):
            dense.append(t.flatten(1, 2)[:, :n_keys]
                         .repeat_interleave(h // kvh, dim=2)
                         .permute(0, 2, 1, 3).contiguous())
    key_pos = torch.arange(n_keys, device=q.device)
    q_pos = pos_v[:, None] + torch.arange(cur, device=q.device)
    mask = (key_pos <= q_pos[..., None])[:, None]  # (b, 1, cur, n_keys)
    qd = q.permute(0, 2, 1, 3).contiguous()
    library_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qd, dense_k[i % layers], dense_v[i % layers], attn_mask=mask))
    # What these inputs need: every visible K/V row once (distinct
    # (page, row) pairs over the slots) with its scales over int8 pages,
    # q read once, out written once.
    visible = set()
    flops = 0
    tbl = table.cpu().tolist()
    for s in range(b):
        for key in range(pos_l[s] + cur):
            visible.add((tbl[s][key // page_tokens], key % page_tokens))
        flops += sum(pos_l[s] + j + 1 for j in range(cur)) * h * dh * 4
    row_bytes = dh * pages[0].element_size() + (4 if len(pages) == 4 else 0)
    bytes_ = (len(visible) * kvh * 2 * row_bytes
              + 2 * q.numel() * q.element_size())
    peak = FP32_FLOP_PER_S if q.dtype == torch.float32 else BF16_FLOP_PER_S
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / peak
    err = (fn(q, *pages, table, pos, layer=0).float()
           - pa._einsum_paged(q, layer_of(0), table, pos, dtype=q.dtype,
                              grouped=True).float()).abs().max().item()
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, **timed("", ms), **timed("plain_", plain_ms),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **timed("library_", library_ms)}


def tree_record(torch, F, pa, cfg, pos_list, launches):
    """Time K6, its plain version and SDPA on the gathered cache K/V
    concatenated with the window under a boolean mask, cycling the layer;
    bound from the bytes and flops these inputs need."""
    from tpudp_torch.serve.speculate import TREE_SHAPES

    anc = TREE_SHAPES["fork2x2"].ancestors
    t1 = len(anc)
    q, (k, v), table, pos0 = timing_case(torch, cfg, pos_list, t1, False,
                                         "cuda", seed=3)
    layers, kvh, dh = k.shape[0], k.shape[3], k.shape[4]
    q, wk, wv = window_views(torch, q, kvh, seed=3)
    b, _, h, _ = q.shape
    page_tokens = k.shape[2]
    pos_l = pos0.tolist()
    fn = pa.KERNELS["paged_tree"]
    ms = time_ms(torch, lambda i: fn(q, k, v, table, pos0, wk, wv, anc,
                                     layer=i % layers))
    plain_ms = time_ms(torch, lambda i: pa._tree_plain(
        q, k, v, table, pos0, wk, wv, anc, i % layers))
    # SDPA yardstick on cache K/V gathered (outside the timing) to dense
    # rows, followed by the window's K/V.
    n_keys = max(pos_l)
    wkd, wvd = (w.permute(0, 2, 1, 3) for w in (wk, wv))
    dense_k, dense_v = [], []
    for layer in range(layers):
        kt, vt = pa.page_tiles((k[layer], v[layer]), table, q.dtype)
        dense_k.append(torch.cat([kt.flatten(1, 2)[:, :n_keys]
                                  .permute(0, 2, 1, 3), wkd], 2).contiguous())
        dense_v.append(torch.cat([vt.flatten(1, 2)[:, :n_keys]
                                  .permute(0, 2, 1, 3), wvd], 2).contiguous())
    cache_vis = (torch.arange(n_keys, device=q.device)
                 < pos0[:, None]).expand(b, n_keys)
    anc_t = torch.as_tensor(anc, device=q.device)
    mask = torch.cat([cache_vis[:, None].expand(b, t1, n_keys),
                      anc_t[None].expand(b, t1, t1)], 2)[:, None]
    qd = q.permute(0, 2, 1, 3).contiguous()
    library_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qd, dense_k[i % layers], dense_v[i % layers], attn_mask=mask))
    # What these inputs need: every strictly visible cache K/V row once
    # (distinct (page, row) pairs), the window K/V, q read once, out
    # written once; 4 dh flops per head and (node, visible key) pair.
    tbl = table.cpu().tolist()
    visible = {(tbl[s][key // page_tokens], key % page_tokens)
               for s in range(b) for key in range(pos_l[s])}
    n_anc = sum(map(sum, anc))
    flops = sum(t1 * pos_l[s] + n_anc for s in range(b)) * h * dh * 4
    bytes_ = (len(visible) * kvh * dh * 2 + 2 * wk.numel()
              + 2 * q.numel()) * k.element_size()
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    err = (fn(q, k, v, table, pos0, wk, wv, anc, layer=0).float()
           - pa._tree_plain(q, k, v, table, pos0, wk, wv, anc, 0).float()
           ).abs().max().item()
    return {"name": "paged_tree", "route": "cuda",
            "source": SOURCES["paged_tree"],
            "replaces": REPLACES["paged_tree"],
            "launches": launches["paged_tree"], "max_abs_err": err,
            **timed("", ms), **timed("plain_", plain_ms),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **timed("library_", library_ms)}


def timings(torch, pa, model, prompts, launches):
    import torch.nn.functional as F

    cfg = model.config
    # Decode: the eight slots midway through their completions.
    decode_pos = [p.size + NEW_TOKENS // 2 for p in prompts]
    # The int8 variants at phase 4c's shapes (LLaMA-GQA, int8 pool,
    # float32 queries), then the fp kernels at phase 4's (GPT-2 small).
    llama_cfg = SimpleNamespace(num_layers=12, num_heads=12, kv_heads=3,
                                d_model=768)
    rec = []
    for suffix, case_cfg, kv_dtype in (("_int8", llama_cfg, "int8"),
                                       ("", cfg, None)):
        # Decode: the eight slots midway through their completions.
        q, pages, table, pos = timing_case(torch, case_cfg, decode_pos, 1,
                                           False, "cuda", 1, kv_dtype)
        rec.append(kernel_record(torch, F, pa, "paged_decode" + suffix, q,
                                 pages, table, pos, launches))
        # Prefill: one 16-token chunk of the 300-token prompt at depth 144.
        q, pages, table, pos = timing_case(torch, case_cfg, [144], 16, True,
                                           "cuda", 2, kv_dtype)
        rec.append(kernel_record(torch, F, pa, "paged_window" + suffix, q,
                                 pages, table, pos, launches))
        rec[-1]["case"] = "prefill"
        del pages
    # Sequence verify: phase 4b's k+1 = 5 windows of the eight slots at
    # the decode depths, GPT-2 small over a float32 pool.
    q, pages, table, pos = timing_case(torch, cfg, decode_pos, 5, False,
                                       "cuda", 4)
    rec.append(kernel_record(torch, F, pa, "paged_window", q, pages, table,
                             pos, launches))
    rec[-1]["case"] = "verify"
    del pages
    # Tree verify: fork2x2 windows of the eight slots at phase 4's
    # decode depths.
    rec.append(tree_record(torch, F, pa, cfg, decode_pos, launches))
    for r in rec:
        print(timing_line(r, "sdpa"), flush=True)
    sms = pa._sm_count(torch.device("cuda"))
    for label, args in (("gpt2 decode", (8, 12, 12, 1024)),
                        ("llama-gqa decode", (8, 12, 3, 1024))):
        print(f"schedule paged_decode {label}: "
              f"{pa.decode_schedule(*args, sms=sms)}", flush=True)
    for label, args in (("gpt2 prefill", (1, 16, 12, 12, 160)),
                        ("llama-gqa prefill", (1, 16, 12, 3, 160)),
                        ("gpt2 verify", (8, 5, 12, 12, 1024))):
        print(f"schedule paged_window {label}: "
              f"{pa.window_schedule(*args, sms=sms)}", flush=True)
    return rec


def flash_bound(kind, b, t, h, dh, itemsize, causal):
    """``(bytes, flops)`` the function needs on these shapes: each input
    read once, each output written once; flops over the visible (query,
    key) pairs — 4 dh per pair forward (q k and p v), 6 dh for dq (q k,
    do v and ds k), 8 dh for dk/dv (those less ds k, plus p do and ds q)."""
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    elems = b * t * h * dh * itemsize  # one (b, t, h, dh) tensor
    rows = b * h * t * 4               # one float32 (b, h, t) tensor
    return {"flash_fwd": (4 * elems + rows, 4 * dh * pairs),
            "flash_dq": (5 * elems + 2 * rows, 6 * dh * pairs),
            "flash_dkv": (6 * elems + 2 * rows, 8 * dh * pairs)}[kind]


def flash_timings(torch, fa, launches, shape=(TRAIN_BATCH, TRAIN_T, 12, 64),
                  causal: bool = True, case: str | None = None):
    """K1, K2 and K3 at a training path's shapes — by default the GPT-2
    main path's (b 4, t 2048, h 12, dh 64, causal) — in bfloat16, on
    projection views, beside their plain versions and SDPA's forward /
    autograd backward; ``case`` tags the records (and their lines)."""
    import torch.nn.functional as F

    b, t, h, dh = shape
    _, q, k, v, do = projection_views(torch, b, t, h, dh, torch.bfloat16, 7)
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    delta = fa._delta(o, do)
    qd, kd, vd = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dod = do.transpose(1, 2).contiguous()
    sdpa_out = F.scaled_dot_product_attention(qd, kd, vd, is_causal=causal)
    sdpa_fwd_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qd, kd, vd, is_causal=causal), n=20)
    sdpa_bwd_ms = time_ms(torch, lambda i: torch.autograd.grad(
        sdpa_out, (qd, kd, vd), dod, retain_graph=True), n=20)
    fns = {
        "flash_fwd": (lambda i: fa.flash_fwd(q, k, v, causal=causal),
                      lambda i: fa._flash_fwd_plain(q, k, v, causal),
                      sdpa_fwd_ms),
        "flash_dq": (lambda i: fa.flash_dq(q, k, v, do, lse, delta,
                                           causal=causal),
                     lambda i: fa._dq_plain(q, k, v, do, lse, delta, causal),
                     sdpa_bwd_ms),
        "flash_dkv": (lambda i: fa.flash_dkv(q, k, v, do, lse, delta,
                                             causal=causal),
                      lambda i: fa._dkv_plain(q, k, v, do, lse, delta,
                                              causal),
                      sdpa_bwd_ms),
    }
    records = []
    for name, (kernel, plain, library_ms) in fns.items():
        got = kernel(0)  # before any plain call: see check_flash_kernels
        ms = time_ms(torch, kernel, n=20)
        plain_ms = time_ms(torch, plain, n=10)
        want = plain(0)
        if name == "flash_dq":  # the others return (o, lse), (dk, dv)
            got, want = (got,), (want,)
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        bytes_, flops = flash_bound(name, b, t, h, dh, 2, causal)
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
        records.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, **timed("", ms), **timed("plain_", plain_ms),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **timed("library_", library_ms),
            **({"case": case} if case else {})})
    kind = "" if causal else " full"
    for r in records:
        print(timing_line(r, f"sdpa{kind} forward"
                          if r["name"] == "flash_fwd"
                          else f"sdpa{kind} backward"), flush=True)
    print(f"timing flash backward{' ' + case if case else ''} (dq + dk/dv "
          f"kernels): "
          f"{records[1]['ms'] + records[2]['ms']:.4f} ms (device "
          f"{records[1]['device_ms'] + records[2]['device_ms']:.4f}), sdpa "
          f"backward {sdpa_bwd_ms[0]:.4f} ms (device {sdpa_bwd_ms[1]:.4f})",
          flush=True)
    return records


def kernel_launches(pa, fa) -> dict:
    """Every port kernel's launch count so far."""
    return {name: fn.launches
            for kernels in (pa.KERNELS, fa.KERNELS)
            for name, fn in kernels.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only-phase16", action="store_true",
                    help="build, check the flash kernels and run phase 16 "
                         "alone (a probe: it prints no result lines)")
    ap.add_argument("--only-phase13", action="store_true",
                    help="build, check the flash kernels and run phases "
                         "13b-13e and 17 alone (a probe: it prints no "
                         "result lines)")
    args = ap.parse_args(argv)
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from tpudp_torch.ops import _build
        from tpudp_torch.ops import flash_attention as fa
        from tpudp_torch.ops import paged_attention as pa
    except ImportError as exc:
        print(f"chip_smoke: the tpudp_torch package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mark = phase_clock()
    try:
        card = device_line()
        print(f"device: {card}", flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}", flush=True)
        t0 = time.perf_counter()
        _build.build()
        print(f"build: {time.perf_counter() - t0:.2f}s for "
              f"{sorted(_build.SIGNATURES)}", flush=True)
        hgmma = hgmma_counts(_build)
        print(f"build: HGMMA instructions in the SASS {hgmma}", flush=True)
        if not all(hgmma.values()):
            raise SmokeFailure(f"a tensor-core flash library has no HGMMA "
                               f"instruction: {hgmma}")
        if args.only_phase16:
            check_flash_kernels(torch, fa)
            phase16_path(torch, np, pa, fa, args.seed)
            print("chip_smoke: phase 16 probe done (no result lines)")
            return 0
        if args.only_phase13:
            check_flash_kernels(torch, fa)
            mark("phase 5")
            vgg_tp_path(torch, np, args.seed, card)
            mark("phase 13b-13e")
            audit_card_path(torch)
            mark("phase 17")
            print("chip_smoke: phase 13 probe done (no result lines)")
            return 0
        mark("build")
        check_kernels(torch, pa, "cuda")
        check_window_edges(torch, pa, "cuda", int8=False)
        check_tree_kernels(torch, pa, "cuda")
        check_int8_kernels(torch, pa, "cuda")
        check_window_edges(torch, pa, "cuda", int8=True)
        check_decode_edges(torch, pa, "cuda")
        mark("phase 3")
        model, prompts, launches = main_path(torch, np, pa, args.seed)
        launches.update(spec_main_path(torch, np, pa, model, prompts,
                                       args.seed))
        launches.update(llama_main_path(torch, np, pa, args.seed))
        routes_path(torch, np, pa, fa, model, prompts, args.seed)
        for name, n in fused_path(torch, np, pa, model, prompts,
                                  args.seed).items():
            launches[name] += n
        for name, n in spec_fused_path(torch, np, pa, model, prompts,
                                       args.seed).items():
            launches[name] += n
        robustness_path(torch, np, model, prompts, args.seed)
        mark("phase 4")
        check_flash_kernels(torch, fa)
        train_launches = train_main_path(torch, np, fa, args.seed)
        mark("phases 5-6")
        before = kernel_launches(pa, fa)
        vgg_path(torch, np)
        if kernel_launches(pa, fa) != before:
            raise SmokeFailure("the VGG path launched a port kernel")
        print("vgg: port kernel launches in phase 7: 0 (the path runs "
              "cuDNN convolutions, cuBLAS and NCCL only)", flush=True)
        mark("phase 7")
        before = kernel_launches(pa, fa)
        resnet_path(torch, np, args.seed)
        if kernel_launches(pa, fa) != before:
            raise SmokeFailure("the ResNet path launched a port kernel")
        print("resnet: port kernel launches in phase 9: 0 (the path runs "
              "cuDNN convolutions and cuBLAS only)", flush=True)
        mark("phase 9")
        ckpt_launches = checkpoint_path(torch, np, pa, fa, args.seed)
        print(f"ckpt: port kernel launches in phase 10c {ckpt_launches}",
              flush=True)
        mark("phase 10")
        strategy_launches = strategy_path(torch, np, args.seed)
        print(f"strategy: flash launches in phase 11 (rank 0) "
              f"{strategy_launches}", flush=True)
        mark("phase 11")
        phase12_launches = phase12_path(torch, np, fa, args.seed)
        print(f"phase 12: flash launches (rank 0) {phase12_launches}",
              flush=True)
        mark("phase 12")
        vit_launches = vit_path(torch, np, fa, args.seed, card)
        tp_launches = vgg_tp_path(torch, np, args.seed, card)
        mark("phase 13")
        p14_flash, p14_paged = phase14_path(torch, np, pa, fa, model,
                                            prompts, args.seed)
        for name, n in p14_paged.items():
            launches[name] += n
        mark("phase 14")
        for name, n in phase15_path(torch, np, pa, model,
                                    args.seed).items():
            launches[name] += n
        mark("phase 15")
        p16_flash = phase16_path(torch, np, pa, fa, args.seed)
        mark("phase 16")
        audit_card_path(torch)
        mark("phase 17")
        records = timings(torch, pa, model, prompts, launches)
        # K1-K3's main-path launches: phase 6's GPT-2 steps, 13a's
        # ViT-B/14 steps, 13d's and 13e's steps (rank 0), 14a's train_cli
        # steps and phase 16's runs, each counted from 0 over its run.
        records += flash_timings(torch, fa, {
            k: train_launches[k] + vit_launches[k] + tp_launches[k]
            + p14_flash[k] + p16_flash[k] for k in FLASH_KERNELS})
        flash_timings(torch, fa, vit_launches, (VIT_BATCH, 256, 12, 64),
                      causal=False, case="vit-b-t256")
        mark("phase 8")
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
