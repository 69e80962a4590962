"""The step-program audit: each registered program's operator census,
kernel calls, host reads, collectives and resource ledger against a
committed lock — the counterpart of ``tpudp/analysis/audit.py``.

Each program of :mod:`tpudp_torch.analysis.programs` runs once on the
CPU under a ``TorchDispatchMode`` that records:

  * ``fingerprint`` — the sha256 of the ordered aten overloads with
    their output shapes and dtypes (the jaxpr hash's counterpart), and
    ``ops``, their count (``eqns``'s);
  * ``kernels`` — calls of each K1-K6 wrapper (``.calls``: off the card
    the wrappers run their plain versions, so the census counts them at
    entry);
  * ``host_reads`` — ``aten._local_scalar_dense`` (``.item()``,
    ``float()``, ``int()``, ``bool()`` of a tensor) and the ``.tolist()``,
    ``.numpy()`` and ``.cpu()`` calls, by kind;
  * ``collectives`` — rank 0's ordered ``torch.distributed`` calls
    (those of ``parallel/collectives.py`` among them) as ``[call, axis,
    bytes]``, point-to-point calls as ``send`` and ``recv``.  Every
    rank's sequence of group collectives must be equal; sends and
    receives pair across ranks instead (a pipeline's middle stage both
    receives and sends), so ``p2p`` records each rank's ``[sends,
    receives, bytes sent, bytes received]`` and the capture checks that
    every byte sent is received;
  * ``budget`` — the ledger of :mod:`tpudp_torch.analysis.budget`.

The multi-rank programs run in one spawned gloo world of
``programs.WORLD`` ranks, torch on one intra-op thread.  The lock
(``program_lock.json`` beside this module) holds ``version``,
``torch``, ``geometry``, ``sources`` (the sha256 of ``AUDIT_SOURCES``)
and ``programs``.  :func:`compare` checks ``kernels``, ``host_reads``,
``collectives`` and the version-neutral budget metrics always, and
``fingerprint``, ``ops`` and ``peak_live_bytes`` only when the running
torch is the lock's: another torch dispatches other operators, so it
prints both versions and does not fail on those.

The module level is stdlib; torch loads inside the capture.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

LOCK_VERSION = 1
LOCK_PATH = os.path.join("tpudp_torch", "analysis", "program_lock.json")

#: Record fields compared whatever the torch version.
NEUTRAL_FIELDS = ("kernels", "host_reads", "collectives", "p2p")
#: Record fields compared only under the lock's torch.
VERSION_FIELDS = ("fingerprint", "ops")

#: ``torch.distributed`` calls the census records, and the position of
#: the tensor each moves; point-to-point calls record as ``send`` or
#: ``recv``.
DIST_CALLS = {"all_reduce": 0, "all_gather_into_tensor": 1,
              "reduce_scatter_tensor": 1, "all_to_all_single": 1,
              "all_gather": 1, "broadcast": 0, "barrier": None,
              "isend": 0, "irecv": 0, "send": 0, "recv": 0,
              "all_gather_object": None, "broadcast_object_list": None}
P2P_KINDS = {"isend": "send", "send": "send", "irecv": "recv",
             "recv": "recv"}
HOST_READ_METHODS = ("tolist", "numpy", "cpu")


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


# -- stdlib half --------------------------------------------------------------

def source_digests(root: str | None = None) -> dict[str, str]:
    from .programs import AUDIT_SOURCES

    root = root or repo_root()
    out = {}
    for rel in AUDIT_SOURCES:
        try:
            with open(os.path.join(root, rel), "rb") as f:
                out[rel] = hashlib.sha256(f.read()).hexdigest()
        except OSError:
            out[rel] = "MISSING"
    return out


def load_lock(path: str) -> dict:
    """The lock at ``path``; raises ``ValueError`` on a file that is not
    a lock (a merge conflict, a truncated write)."""
    with open(path, encoding="utf-8") as f:
        lock = json.load(f)
    if not isinstance(lock, dict) or not isinstance(
            lock.get("programs"), dict):
        raise ValueError("no 'programs' table")
    return lock


def write_lock(path: str, capture_result: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(capture_result, f, indent=1, sort_keys=True)
        f.write("\n")


def _stale(recorded: dict, current: dict) -> list[str]:
    return sorted({rel for rel, d in current.items()
                   if recorded.get(rel) != d}
                  | {rel for rel in recorded if rel not in current})


def sources_stale(lock: dict, root: str | None = None) -> list[str]:
    """Pinned sources whose digest is not the lock's (either way)."""
    return _stale(lock.get("sources", {}), source_digests(root))


def compare(lock: dict, current: dict) -> tuple[list[str], list[str]]:
    """``(problems, notes)``: each problem names its program and field;
    the notes say what was not compared (another torch)."""
    from . import budget

    problems: list[str] = []
    notes: list[str] = []
    if lock.get("version") != current["version"]:
        return ([f"lock version {lock.get('version')} != auditor version "
                 f"{current['version']} — regenerate with --update"], notes)
    same_torch = lock.get("torch") == current.get("torch")
    if not same_torch:
        notes.append(
            f"torch version skew: the lock was made under torch "
            f"{lock.get('torch')}, this run has {current.get('torch')} — "
            f"fingerprint, ops and peak_live_bytes are not compared; "
            f"kernels, host reads, collectives and the other budget "
            f"metrics are")
    if lock.get("geometry") != current.get("geometry"):
        problems.append(f"capture geometry {current.get('geometry')} is not "
                        f"the lock's {lock.get('geometry')}")
    locked, live = lock.get("programs", {}), current["programs"]
    for name in locked:
        if name not in live:
            problems.append(f"{name}: in the lock but no longer registered "
                            f"— a pinned program disappeared (deliberate "
                            f"removal: --update)")
    metrics = tuple(budget.BUDGET_TOLERANCES) if same_torch \
        else budget.VERSION_NEUTRAL
    for name, rec in live.items():
        old = locked.get(name)
        if old is None:
            problems.append(f"{name}: registered but not in the lock — "
                            f"run --update to pin it")
            continue
        deltas = [f"{field} {old.get(field)} -> {rec.get(field)}"
                  for field in NEUTRAL_FIELDS
                  if old.get(field) != rec.get(field)]
        if same_torch:
            deltas += [f"{field} {old.get(field)} -> {rec.get(field)}"
                       for field in VERSION_FIELDS
                       if old.get(field) != rec.get(field)]
        deltas += [p.split(": ", 1)[1] for p in budget.compare_budgets(
            name, old.get("budget"), rec.get("budget"), metrics)]
        if deltas:
            problems.append(f"{name}: changed — " + "; ".join(deltas))
    stale = _stale(lock.get("sources", {}), current.get("sources", {}))
    if stale:
        problems.append("stale source digests (edited without --update): "
                        + ", ".join(stale) + " — rerun `python -m "
                        "tpudp_torch.analysis audit --update` and commit "
                        "the lock")
    return problems, notes


# -- the capture --------------------------------------------------------------

def _tensors(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def _storage(t):
    """``(key, nbytes)`` of ``t``'s storage; key None for no bytes."""
    s = t.untyped_storage()
    n = s.nbytes()
    return (s.data_ptr() if n else None), n


def _census_mode():
    import weakref

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    scalar = torch.ops.aten._local_scalar_dense.default

    class Census(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops: list[str] = []
            self.scalar_reads = 0
            # Storages are keyed by address, each dropped when the tensor
            # that first held it dies (so a reused address is new).
            self.inputs: set = set()  # storages the call did not create
            self.arg_bytes = 0
            self.alive: dict = {}     # storages the call created, alive
            self.live = self.peak = 0

        def _free(self, key, n):
            if self.alive.get(key) == n:
                del self.alive[key]
                self.live -= n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            for t in _tensors((args, kwargs)):
                key, n = _storage(t)
                if key is None or key in self.alive or key in self.inputs:
                    continue
                self.inputs.add(key)
                self.arg_bytes += n
                weakref.finalize(t, self.inputs.discard, key)
            out = func(*args, **kwargs)
            outs = list(_tensors(out))
            self.ops.append(f"{func}(" + ",".join(
                f"{str(t.dtype)[6:]}{list(t.shape)}" for t in outs) + ")")
            if func is scalar:
                self.scalar_reads += 1
            for t in outs:
                key, n = _storage(t)
                if key is None or key in self.alive or key in self.inputs:
                    continue
                self.alive[key] = n
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, key, n)
            return out

    return Census()


class _Patched:
    """Counts ``.tolist()``/``.numpy()``/``.cpu()`` and records the
    ``torch.distributed`` calls inside the block."""

    def __init__(self, axes: dict):
        self.axes = axes
        self.reads = {m: 0 for m in HOST_READ_METHODS}
        self.collectives: list[list] = []
        self._saved: list = []
        self._inside = False

    def _axis(self, group):
        import torch.distributed as dist

        g = dist.group.WORLD if group is None else group
        if id(g) in self.axes:
            return self.axes[id(g)]
        return f"group{dist.get_world_size(g)}"

    def __enter__(self):
        import torch
        import torch.distributed as dist
        from torch.distributed import distributed_c10d

        for method in HOST_READ_METHODS:
            orig = getattr(torch.Tensor, method)

            def counted(t, *a, _orig=orig, _m=method, **kw):
                self.reads[_m] += 1
                return _orig(t, *a, **kw)

            self._saved.append((torch.Tensor, method, orig))
            setattr(torch.Tensor, method, counted)
        for name, pos in DIST_CALLS.items():
            orig = getattr(dist, name, None)
            if orig is None:
                continue

            def recorded(*a, _orig=orig, _name=name, _pos=pos, **kw):
                if self._inside:  # torch's recv calls irecv: one call
                    return _orig(*a, **kw)
                t = a[_pos] if _pos is not None and len(a) > _pos else None
                nbytes = (t.numel() * t.element_size()
                          if isinstance(t, torch.Tensor) else 0)
                kind = P2P_KINDS.get(_name, _name)
                self.collectives.append(
                    [kind, self._axis(kw.get("group")), nbytes])
                self._inside = True
                try:
                    return _orig(*a, **kw)
                finally:
                    self._inside = False

            for module in (dist, distributed_c10d):
                if getattr(module, name, None) is orig:
                    self._saved.append((module, name, orig))
                    setattr(module, name, recorded)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        return False


def _kernel_counts(attr: str) -> dict:
    from tpudp_torch.ops import flash_attention, paged_attention

    wrappers = {**flash_attention.KERNELS, **paged_attention.KERNELS}
    return {name: getattr(fn, attr) for name, fn in wrappers.items()}


def capture_one(call, axes: dict | None = None, *,
                kernel_attr: str = "calls") -> dict:
    """Run ``call()`` once under the census: the program's record."""
    import gc

    before = _kernel_counts(kernel_attr)
    mode = _census_mode()
    # Cyclic garbage dies at the end, not whenever gc happens to run: with
    # gc off, everything the call makes stays in the youngest generation,
    # which one cheap collection then sweeps.
    gc.disable()
    try:
        with _Patched(axes or {}) as patched, mode:
            result = call()
            gc.collect(0)
            out_bytes = sum(mode.alive.values())
        del result
    finally:
        gc.enable()
    after = _kernel_counts(kernel_attr)
    kernels = {k: after[k] - before[k] for k in sorted(after)
               if after[k] != before[k]}
    reads = {"item": mode.scalar_reads, **patched.reads}
    text = "\n".join(mode.ops)
    return {
        "fingerprint": hashlib.sha256(text.encode()).hexdigest(),
        "ops": len(mode.ops),
        "kernels": kernels,
        "host_reads": {k: v for k, v in reads.items() if v},
        "collectives": patched.collectives,
        "budget": {
            "arg_bytes": mode.arg_bytes,
            "out_bytes": out_bytes,
            "collective_payload_bytes": sum(c[2] for c in
                                            patched.collectives),
            "peak_live_bytes": mode.peak,
        },
    }


def geometry() -> dict:
    from .programs import SERVE, TRAIN, WORLD

    return {"platform": "cpu", "world": WORLD,
            "serve": f"s{SERVE['slots']}m{SERVE['max_len']}"
                     f"d{SERVE['d_model']}p{SERVE['pages']}",
            "train_batch": TRAIN["batch"]}


def capture(programs: dict | None = None, *, rank_world: bool = True,
            extra=(), sys_path=()) -> dict:
    """Run every registered program (``programs``: name -> ``(call,
    axes)`` in their place) and, with ``rank_world``, the multi-rank
    ones in one spawned gloo world (``extra``: more ``module:function``
    rank-program factories for it, importable from
    ``sys_path``) → a lock-shaped dict."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if programs is None:
            from .programs import build_programs
            programs = build_programs()
        records = {name: capture_one(call, axes)
                   for name, (call, axes) in programs.items()}
    finally:
        torch.set_num_threads(threads)
    if rank_world:
        records.update(capture_world(extra=extra, sys_path=sys_path))
    return {"version": LOCK_VERSION, "torch": torch.__version__,
            "geometry": geometry(), "programs": records,
            "sources": source_digests()}


def capture_world(*, extra=(), sys_path=(), registered: bool = True,
                  timeout: float = 600.0) -> dict:
    """The multi-rank programs' records from one gloo world of
    ``programs.WORLD`` ranks on the CPU; raises naming the program whose
    ranks made different collective sequences."""
    import subprocess
    import tempfile

    from .programs import WORLD

    with tempfile.TemporaryDirectory(prefix="tpudp-audit-") as tmp:
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"world": WORLD, "out": tmp, "extra": list(extra),
                       "sys_path": list(sys_path), "registered": registered,
                       "init": f"file://{os.path.join(tmp, 'store')}"}, f)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [repo_root()] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tpudp_torch.analysis.audit", spec,
             str(r)], env=env, cwd=repo_root(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"audit rank {r} exited {p.returncode}:"
                                   f"\n{log[-4000:]}")
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    out = {}
    for name, rec in ranks[0].items():
        seqs = [[c for c in r[name]["collectives"]
                 if c[0] not in ("send", "recv")] for r in ranks]
        for r, seq in enumerate(seqs[1:], 1):
            if seq != seqs[0]:
                raise RuntimeError(
                    f"{name}: rank {r} made the collectives {seq}, rank 0 "
                    f"{seqs[0]} — every rank must make the same sequence")
        p2p = [[sum(c[0] == kind for c in r[name]["collectives"])
                for kind in ("send", "recv")]
               + [sum(c[2] for c in r[name]["collectives"] if c[0] == kind)
                  for kind in ("send", "recv")] for r in ranks]
        sent = sorted(c[2] for r in ranks for c in r[name]["collectives"]
                      if c[0] == "send")
        got = sorted(c[2] for r in ranks for c in r[name]["collectives"]
                     if c[0] == "recv")
        if sent != got:
            raise RuntimeError(f"{name}: the ranks sent {sent} bytes and "
                               f"received {got} — a send without its "
                               f"receive")
        out[name] = dict(rec, p2p=p2p)
    return out


def _rank_main(spec_path: str, rank: int) -> None:
    """One rank of the audit's gloo world: build the rank programs, run
    each under the census, write ``rank{rank}.json``."""
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path[:0] = spec["sys_path"]
    dist.init_process_group("gloo", init_method=spec["init"],
                            world_size=spec["world"], rank=rank)
    try:
        programs = {}
        if spec["registered"]:
            from .programs import build_rank_programs
            programs.update(build_rank_programs(rank, spec["world"]))
        for ref in spec["extra"]:
            module, fn = ref.split(":")
            programs.update(getattr(importlib.import_module(module), fn)(
                rank, spec["world"]))
        records = {name: capture_one(call, axes)
                   for name, (call, axes) in programs.items()}
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(records, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
