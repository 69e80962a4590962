"""The audit's program registry: the port's step programs, at pinned CPU
geometries — the counterpart of ``tpudp/analysis/programs.py``.

A program is one call of what the serving engine or the training loop
runs a step: one engine iteration that dispatches the program (the
engine is driven into the state where its next step runs exactly that
program, and the step is checked to have run it), or one call of a
step function.  :func:`build_programs` returns the single-process
programs; :func:`build_rank_programs` the multi-rank ones, which run in
one gloo world of :data:`WORLD` ranks on the CPU
(``tpudp_torch.analysis.audit``).  Each entry is ``(call,
axes)``: ``call()`` runs the program once, ``axes`` maps a process
group to its mesh axis name for the collective census.

Geometries are tiny and fixed (they are part of the lock's identity):
the serving engine at 2 slots x 32 positions, chunk 8, k 3, a fused
window of 4, 6 pages, on a 2-layer GPT-2 of width 64 and 2 heads (head
dim 32, a width the paged kernels take, so the ``_kernel`` twins reach
K4-K6's wrappers); the training step on a narrow VGG at batch 8.  The
names follow JAX's, with the port's geometry after the ``@``.

The module level is stdlib tables only (the lint rules read them);
torch loads inside the functions that build the programs.
"""

from __future__ import annotations

#: Files whose edits can change a registered program; their digests ride
#: in the lock, and the tier-1 test keeps them fresh.
AUDIT_SOURCES = (
    "tpudp_torch/serve/engine.py",
    "tpudp_torch/serve/fused.py",
    "tpudp_torch/serve/prefix_cache.py",
    "tpudp_torch/serve/speculate.py",
    "tpudp_torch/models/generate.py",
    "tpudp_torch/models/gpt2.py",
    "tpudp_torch/models/vgg.py",
    "tpudp_torch/ops/sampling.py",
    "tpudp_torch/ops/attention.py",
    "tpudp_torch/ops/paged_attention.py",
    "tpudp_torch/ops/flash_attention.py",
    "tpudp_torch/train.py",
    "tpudp_torch/parallel/collectives.py",
    "tpudp_torch/parallel/sync.py",
    "tpudp_torch/parallel/ring.py",
    "tpudp_torch/parallel/schedule.py",
    "tpudp_torch/analysis/programs.py",
)

#: The kernel wrappers the census counts (each has ``.launches`` and
#: ``.calls``): K1-K3 (flash), K4 and K5 (fp and int8), K6.
KERNEL_CENSUS = ("flash_fwd", "flash_dq", "flash_dkv", "paged_decode",
                 "paged_window", "paged_decode_int8", "paged_window_int8",
                 "paged_tree")

#: Step-program factories (``path:qualname``) -> the programs that pin
#: them (the unregistered-program rule requires an entry).
FACTORIES = {
    "tpudp_torch/train.py:make_train_step": (
        "train.step_single", "train.step_single_sdc",
        "train.step_dp_allreduce", "train.step_dp_allreduce_sdc",
        "train.step_dp_ring"),
    "tpudp_torch/train.py:make_eval_step": ("train.eval_step",),
    "tpudp_torch/train.py:make_forward_step": ("train.forward_step",),
    "tpudp_torch/parallel/schedule.py:make_pipeline_train_step": (
        "train.pp_1f1b", "train.pp_1f1b_int"),
    "tpudp_torch/parallel/schedule.py:make_pipeline_eval_step": (
        "train.pp_eval",),
}

#: CUDA-graph capture sites (``path:qualname``) -> the programs whose
#: windows they capture.
CAPTURE_SITES = {
    "tpudp_torch/serve/fused.py:_GraphWindow._capture": (
        "serve.fused_decode", "serve.fused_decode_paged",
        "serve.fused_spec_decode", "serve.fused_spec_paged"),
}

#: The engine's device-call kinds (``Engine._device(kind, ...)``) -> the
#: programs that pin them.
DEVICE_KINDS = {
    "prefill": ("serve.prefill_chunk", "serve.prefill_paged"),
    "sample": ("serve.sample_row",),
    "decode": ("serve.decode_step", "serve.decode_paged"),
    "verify": ("serve.verify_step", "serve.verify_paged"),
    "tree_verify": ("serve.tree_verify", "serve.tree_verify_paged"),
    "fused_decode": ("serve.fused_decode", "serve.fused_decode_paged"),
    "fused_spec": ("serve.fused_spec_decode", "serve.fused_spec_paged"),
    "prefix_in": ("prefix.copy_block_in",),
    "prefix_out": ("prefix.copy_block_out",),
}

SERVE = dict(vocab=64, seq=64, layers=2, heads=2, d_model=64, slots=2,
             max_len=32, chunk=8, k=3, blocks=4, fuse=4, pages=6)
DRAFT = dict(vocab=64, seq=64, layers=1, heads=2, d_model=64)
TREE = "fork2x2"  # 5 nodes: the root's two branches of depth 2
TRAIN = dict(cfg=(8, "M", "M", "M", "M", "M"), image=32, classes=10,
             batch=8)
PIPELINE = dict(vocab=64, seq=32, layers=4, heads=2, d_model=32, batch=8,
                t=16, micro=2, geometries=((2, 2, 1), (4, 1, 1), (2, 2, 2)))
#: The ranks of the multi-rank programs' gloo world.
WORLD = 4

#: The multi-rank programs, in lock order.
RANK_PROGRAMS = (
    f"train.step_dp_allreduce@w{WORLD}",
    f"train.step_dp_allreduce_sdc@w{WORLD}",
    f"train.step_dp_ring@w{WORLD}",
    f"train.eval_step@w{WORLD}",
    "train.pp_1f1b@pp2dp2m2L4",
    "train.pp_1f1b@pp4dp1m2L4",
    "train.pp_1f1b_int@pp2dp2m2v2L4",
    "train.pp_eval@pp2dp2m2L4",
)

_GEO = f"s{SERVE['slots']}m{SERVE['max_len']}d{SERVE['d_model']}"
_PGEO = f"{_GEO}p{SERVE['pages']}"


def _gpt2(spec: dict, seed: int, device):
    import torch

    from tpudp_torch.models import gpt2

    cfg = gpt2.GPT2Config(vocab_size=spec["vocab"],
                          max_seq_len=spec["seq"],
                          num_layers=spec["layers"],
                          num_heads=spec["heads"], d_model=spec["d_model"])
    model = gpt2.GPT2(cfg)
    model.load_state_dict(gpt2.params_from_jax(gpt2.random_params(cfg,
                                                                  seed)))
    return model.to(torch.device(device))


def _engine(device, *, kernel: bool = False, **kw):
    """The serving engine at the pinned geometry; ``kernel``: its paged
    families dispatched to the kernel wrappers (on the CPU they run
    their plain versions: the census counts the wrapper calls)."""
    from tpudp_torch.serve.engine import Engine, paged_dispatch

    on_card = str(device).startswith("cuda")
    if kw.get("kv_pages"):
        kw["paged_attn"] = "kernel" if kernel and on_card else "einsum"
    eng = Engine(_gpt2(SERVE, 0, device), device=device,
                 num_slots=SERVE["slots"], max_len=SERVE["max_len"],
                 prefill_chunk=SERVE["chunk"], obs=False, **kw)
    if kernel and not on_card:
        for ms in eng._mstates.values():
            tree = eng.speculate_tree
            ms.dispatch.update(paged_dispatch(
                "kernel", eng.kv_dtype,
                ms.config.d_model // ms.config.num_heads,
                len(tree.parents) if tree is not None else None))
    return eng


#: Prompts that decode into repeats, so the n-gram drafter proposes.
_PROMPTS = ([5, 6, 7, 5, 6, 7, 5], [9, 10, 9, 10, 9])


def _drafts(eng) -> bool:
    """Will the engine's next step verify: does a decoding slot's
    drafter propose?"""
    for r in eng._slots:
        if r is None or r._nfill < r._fill.size:
            continue
        ctx = eng._context(r)
        if eng.speculate_tree is not None:
            if eng.drafter.propose_tree(ctx, eng.speculate_tree) is not None:
                return True
        elif len(eng.drafter.propose(ctx, eng.speculate_k)):
            return True
    return False


def _serving(device, counter: str, *, prompt_steps: int = 2, submit=None,
             kernel: bool = False, **kw):
    """One engine step in the state where it runs one ``counter``
    program: the prompts admitted and prefilled first (and, for a verify
    program, decoded until a slot drafts).  On the card a fused window's
    graph is captured here, so the call replays it."""
    eng = _engine(device, kernel=kernel, **kw)
    for p in (submit or _PROMPTS):
        eng.submit(p, 12)
    for _ in range(prompt_steps):
        eng.step()
    if counter in ("verify_steps", "tree_verify_steps"):
        for _ in range(4):
            if _drafts(eng):
                break
            eng.step()
    if str(device).startswith("cuda") and counter in (
            "fused_windows", "fused_spec_windows"):
        ms = eng._mstates[None]
        (eng._fused_window(ms) if counter == "fused_windows"
         else eng._spec_fused_window(ms))._capture()

    def call():
        before = eng.stats[counter]
        eng.step()
        if eng.stats[counter] != before + 1:
            raise RuntimeError(f"the pinned step did not run one "
                               f"{counter!r} program")

    return call


def build_programs(device="cpu") -> dict:
    """name -> ``(call, axes)``: every single-process program, in lock
    order."""
    import torch

    from tpudp_torch.serve.speculate import DraftModelDrafter

    programs: dict[str, tuple] = {}
    k, fuse, pages = SERVE["k"], SERVE["fuse"], SERVE["pages"]

    def add(name, call):
        programs[name] = (call, {})

    def drafter():
        return DraftModelDrafter(_gpt2(DRAFT, 1, device))

    for paged, geo in ((False, _GEO), (True, _PGEO)):
        kv = {"kv_pages": pages} if paged else {}
        twins = (False, True) if paged else (False,)
        for kernel in twins:
            sfx = "_kernel" if kernel else ""
            fam = "_paged" if paged else ""
            add(f"serve.decode{fam or '_step'}{sfx}@{geo}",
                _serving(device, "decode_steps", kernel=kernel, **kv))
            add(f"serve.verify{fam or '_step'}{sfx}@{geo}k{k}",
                _serving(device, "verify_steps", kernel=kernel,
                         speculate_k=k, **kv))
            add(f"serve.prefill{fam or '_chunk'}{sfx}@{geo}"
                f"c{SERVE['chunk']}",
                _serving(device, "prefill_chunks", kernel=kernel,
                         prompt_steps=0, submit=[list(range(1, 13))], **kv))
            add(f"serve.tree_verify{fam}{sfx}@{geo}t5",
                _serving(device, "tree_verify_steps", kernel=kernel,
                         speculate_k=k, speculate_tree=TREE, **kv))
            add(f"serve.fused_decode{fam}{sfx}@{geo}n{fuse}",
                _serving(device, "fused_windows", kernel=kernel,
                         decode_fuse=fuse, **kv))
            add(f"serve.fused_spec{fam or '_decode'}{sfx}@{geo}k{k}n{fuse}",
                _serving(device, "fused_spec_windows", kernel=kernel,
                         speculate_k=k, decode_fuse=fuse,
                         drafter=drafter(), **kv))
        add(f"serve.fused_decode{fam}_stream@{geo}n{fuse}",
            _serving(device, "fused_windows", decode_fuse=fuse,
                     fuse_stream=True, **kv))
        add(f"serve.fused_spec{fam or '_decode'}_stream@{geo}k{k}n{fuse}",
            _serving(device, "fused_spec_windows", speculate_k=k,
                     decode_fuse=fuse, drafter=drafter(), fuse_stream=True,
                     **kv))

    from tpudp_torch.serve.engine import _sample_row

    gen = torch.Generator(device=device).manual_seed(0)
    logits = torch.zeros((1, SERVE["vocab"]), device=device)
    add(f"serve.sample_row@v{SERVE['vocab']}",
        lambda: _sample_row(logits, 0.0, 0, 1.0, gen))
    draft = drafter()
    ctx = (torch.arange(16) % SERVE["vocab"]).numpy()
    add(f"serve.draft_model@ctx16k{k}", lambda: draft.propose(ctx, k))

    from tpudp_torch.models.generate import KVCache
    from tpudp_torch.serve import prefix_cache

    cfg = _gpt2(SERVE, 0, "cpu").config
    cache = KVCache.zeros(cfg, SERVE["slots"], SERVE["max_len"], device)
    pool = KVCache.zeros(cfg, SERVE["blocks"], SERVE["chunk"], device)
    bgeo = f"{_GEO}b{SERVE['blocks']}"
    add(f"prefix.copy_block_in@{bgeo}",
        lambda: prefix_cache.copy_block_in(cache, pool, 0, 0, 0))
    add(f"prefix.copy_block_out@{bgeo}",
        lambda: prefix_cache.copy_block_out(cache, pool, 0, 0, 0))

    from tpudp_torch import train

    for name, sdc in (("step_single", False), ("step_single_sdc", True)):
        model, state, images, labels, _ = _train_inputs(device, sdc=sdc)
        step = train.make_train_step(model, train.make_optimizer())
        add(f"train.{name}@tiny",
            lambda step=step, state=state, x=images, y=labels:
            step(state, x, y))
    model, state, images, _, _ = _train_inputs(device)
    forward = train.make_forward_step(model)
    add("train.forward_step@tiny", lambda: forward(state, images))
    return programs


def _train_inputs(device, *, sdc: bool = False, mesh=None, rows=None):
    """The narrow VGG, its state and one batch (``rows`` of it)."""
    import torch

    from tpudp_torch import train
    from tpudp_torch.models import vgg

    model = vgg.VGG(TRAIN["cfg"]).to(device)
    model.load_state_dict(vgg.params_from_jax(*vgg.random_params(
        TRAIN["cfg"], 0)))
    state = train.init_state(model, train.make_optimizer(), mesh,
                             track_sdc=sdc)
    n = rows or TRAIN["batch"]
    g = torch.Generator().manual_seed(0)
    images = torch.randn((n, TRAIN["image"], TRAIN["image"], 3),
                         generator=g).to(device)
    labels = (torch.arange(n) % TRAIN["classes"]).to(device)
    weights = torch.ones(n, device=device)
    return model, state, images, labels, weights


def build_rank_programs(rank: int, world: int) -> dict:
    """name -> ``(call, axes)``: the multi-rank programs, on this rank
    of a gloo world of ``world`` (:data:`WORLD`) ranks whose process
    group is up; every rank builds every program in the same order."""
    import torch
    import torch.distributed as dist

    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh, make_mesh_nd

    if world != WORLD:
        raise ValueError(f"the rank programs run at {WORLD} ranks, got "
                         f"{world}")
    programs: dict[str, tuple] = {}
    mesh = make_mesh()
    world_axes = {id(dist.group.WORLD): "data"}
    rows = TRAIN["batch"] // world
    for name, sync, sdc in (("step_dp_allreduce", "allreduce", False),
                            ("step_dp_allreduce_sdc", "allreduce", True),
                            ("step_dp_ring", "ring", False)):
        model, state, x, y, _ = _train_inputs("cpu", sdc=sdc, mesh=mesh,
                                              rows=rows)
        step = train.make_train_step(model, train.make_optimizer(), mesh,
                                     sync)
        programs[f"train.{name}@w{world}"] = (
            lambda step=step, state=state, x=x, y=y: step(state, x, y),
            world_axes)
    model, state, x, y, wt = _train_inputs("cpu", mesh=mesh, rows=rows)
    ev = train.make_eval_step(model, mesh)
    programs[f"train.eval_step@w{world}"] = (
        lambda ev=ev, st=state, x=x, y=y, wt=wt: ev(st, x, y, wt),
        world_axes)

    from tpudp_torch.parallel.schedule import (make_pipeline_eval_step,
                                               make_pipeline_train_step)

    spec = train.make_optimizer(learning_rate=0.01)
    toks = torch.arange(PIPELINE["batch"] * PIPELINE["t"]).reshape(
        PIPELINE["batch"], PIPELINE["t"]) % PIPELINE["vocab"]
    for pp, dp, il in PIPELINE["geometries"]:
        pmesh = make_mesh_nd({"data": dp, "pipe": pp})
        axes = {id(pmesh.group(a)): a for a in ("data", "pipe")}
        lm = _gpt2(PIPELINE, 2, "cpu")
        built, step = make_pipeline_train_step(
            lm, spec, pmesh, train.init_state(lm, spec),
            n_microbatches=PIPELINE["micro"], interleave=il)
        block = toks.chunk(dp)[pmesh.coords["data"]]
        fam = "train.pp_1f1b_int" if il > 1 else "train.pp_1f1b"
        geo = (f"pp{pp}dp{dp}m{PIPELINE['micro']}"
               + (f"v{il}" if il > 1 else "") + f"L{PIPELINE['layers']}")
        programs[f"{fam}@{geo}"] = (
            lambda step=step, st=built, b=block: step(st, b, b), axes)
        if (pp, dp, il) == PIPELINE["geometries"][0]:
            ev = make_pipeline_eval_step(lm, pmesh, built,
                                         n_microbatches=PIPELINE["micro"],
                                         interleave=il)
            w = torch.ones(block.shape[0])
            eval_prog = (lambda ev=ev, st=built, b=block, w=w:
                         ev(st, b, b, w), axes)
    programs[f"train.pp_eval@pp2dp2m{PIPELINE['micro']}"
             f"L{PIPELINE['layers']}"] = eval_prog
    assert tuple(programs) == RANK_PROGRAMS, tuple(programs)
    return programs
