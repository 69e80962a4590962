"""Checkpoint and resume with per-leaf integrity manifests — the port of
``tpudp/utils/checkpoint.py``'s single-host core.

A checkpoint is a directory ``step_N/`` holding one file, ``state.pt``,
written by ``torch.save`` under a temporary name and then
``os.replace``d, so a torn write is never taken for a checkpoint.  It is
read back with ``torch.load(weights_only=True)``.  The saved tree is
:func:`tpudp_torch.train.state_to_jax`'s: the model's leaves (params and
BatchNorm statistics), ``step`` (int32, shape ``()``) and ``loss_sum``
(float32, shape ``()``) under the JAX package's names, layouts and dtypes,
the optimizer's state keyed by the JAX name of the parameter it belongs
to, and with ``compress='int8_ef'`` every rank's residuals stacked
``(N, *shape)``.  The integrity manifest sits BESIDE the directory as
``step_N.manifest.json`` in JAX's format 1 (``{"format": 1, "leaves":
{keystr: {crc32, dtype, shape}}}``), so its entries for the model, step
and ``loss_sum`` equal JAX's ``leaf_checksums`` of the same state.

Ranks (``torch.distributed``; a process without a group is one rank):
only rank 0 writes, quarantines, consumes or prunes, and every save ends
at a barrier of all ranks.  Every rank restores the SAME step: each
finds its newest verified step and one all-reduce takes their minimum
(:func:`restore_latest_verified`) — JAX's multi-host vote reduced to one
collective.  JAX's two-phase multi-host commit (per-host shard
manifests, the ``COMMITTED`` marker) and its elastic shard coverage are
not ported: one writer on one host needs neither.

Transient I/O (``_retry_fs``): every file operation of a save or restore
retries EIO-class errnos a bounded number of times with linear backoff;
ENOENT, EACCES, ENOSPC and the like propagate at once.
"""

from __future__ import annotations

import errno
import json
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

_TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EBUSY, errno.EINTR, errno.ESTALE,
    errno.ETIMEDOUT,
})

FS_RETRIES = 3          # attempts after the first
FS_BACKOFF_S = 0.05     # linear: sleep(FS_BACKOFF_S * attempt)

STATE_FILE = "state.pt"
_STEP_DIR = re.compile(r"^step_(\d+)$")
_EMERGENCY_SENTINEL = "emergency.COMPLETE"


def _retry_fs(fn: Callable[[], Any]):
    """Run ``fn()``, retrying transient filesystem errors (the
    ``_TRANSIENT_ERRNOS`` set) up to ``FS_RETRIES`` times with linear
    ``FS_BACKOFF_S`` backoff; any other ``OSError``, and the last
    transient one, propagates unchanged."""
    for attempt in range(FS_RETRIES + 1):
        try:
            return fn()
        except OSError as exc:
            if (exc.errno not in _TRANSIENT_ERRNOS
                    or attempt >= FS_RETRIES):
                raise
            time.sleep(FS_BACKOFF_S * (attempt + 1))


class CheckpointCorruptError(RuntimeError):
    """A checkpoint was read but its bytes do not match the checksum
    manifest written at save time.  Typed so that a resume can fall back
    to an older checkpoint instead of crashing."""


# -- ranks ------------------------------------------------------------------

def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def _all_reduce(values: list[int], op) -> list[int]:
    """All-reduce a few integers over the default group (the identity at
    one rank); the tensor lives where the backend wants it."""
    if world_size() == 1:
        return [int(v) for v in values]
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor(values, dtype=torch.int64, device=device)
    dist.all_reduce(t, op=op)
    return [int(v) for v in t.tolist()]


def barrier() -> None:
    """Every rank waits for every other (a no-op at one rank)."""
    if world_size() > 1:
        _all_reduce([0], dist.ReduceOp.SUM)


def coordinated_any(flag: bool) -> bool:
    """True on every rank if any rank passed True (identity at one rank):
    entry into a collective restore is itself a collective decision, so
    a rank whose listing shows no checkpoint is not left outside an
    all-reduce its peers entered."""
    if world_size() == 1:
        return bool(flag)
    return _all_reduce([1 if flag else 0], dist.ReduceOp.MAX)[0] == 1


def all_ranks_ok(ok: bool) -> bool:
    """True only if every rank passed ``ok=True`` (identity at one
    rank)."""
    if world_size() == 1:
        return bool(ok)
    return _all_reduce([1 if ok else 0], dist.ReduceOp.MIN)[0] == 1


def _gather_device() -> torch.device:
    """Where a gather's tensors live: the card for NCCL, else the host
    (gloo is trusted with CUDA tensors for all-reduce only)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather_rows(row: torch.Tensor) -> list[torch.Tensor]:
    """All-gather one equal-shaped tensor a rank, in rank order."""
    rows = [torch.empty_like(row) for _ in range(world_size())]
    dist.all_gather(rows, row)
    return rows


def all_hosts_ok(ok: bool, value: int = 0) -> bool:
    """True only if every rank passed ``ok=True`` and the same ``value``
    (the step being voted on, say): ranks whose views diverged reject
    together.  One all-gather of ``[ok, value]`` a rank; the identity at
    one rank, with no collective."""
    if world_size() == 1:
        return bool(ok)
    rows = _all_gather_rows(torch.tensor([1 if ok else 0, int(value)],
                                         dtype=torch.int64,
                                         device=_gather_device()))
    flags = torch.stack(rows).cpu()
    return bool(flags[:, 0].min() == 1
                and bool((flags[:, 1] == flags[0, 1]).all()))


def gather_host_values(value: int) -> list[int]:
    """One integer from every rank, in rank order (``[value]`` at one
    rank, with no collective)."""
    if world_size() == 1:
        return [int(value)]
    rows = _all_gather_rows(torch.tensor([int(value)], dtype=torch.int64,
                                         device=_gather_device()))
    return [int(r[0]) for r in rows]


def gather_host_blobs(blob: bytes) -> list[bytes]:
    """One variable-length byte payload from every rank, in rank order
    (``[blob]`` at one rank, with no collective) — the transfer under KV
    page migration (``tpudp_torch/serve/disagg.py``).  Exactly two fixed
    collectives: a length gather, then one all-gather of uint8 rows
    padded to the longest payload (rounded up to a power of two, as in
    JAX), so every rank issues the same sequence whoever has bytes to
    send."""
    if world_size() == 1:
        return [bytes(blob)]
    lengths = gather_host_values(len(blob))
    width = 1 << (max(max(lengths), 1) - 1).bit_length()
    buf = torch.zeros(width, dtype=torch.uint8)
    if blob:
        buf[:len(blob)] = torch.frombuffer(bytearray(blob),
                                           dtype=torch.uint8)
    rows = _all_gather_rows(buf.to(_gather_device()))
    return [r[:n].cpu().numpy().tobytes() for r, n in zip(rows, lengths)]


# -- manifests --------------------------------------------------------------

def manifest_path(path: str | os.PathLike) -> str:
    """The integrity manifest lives BESIDE the checkpoint directory, as
    in the JAX package."""
    return os.path.abspath(os.fspath(path)) + ".manifest.json"


def _sidecar_paths(path: str | os.PathLike) -> list[str]:
    """Every integrity sidecar beside the checkpoint dir at ``path`` —
    the set that travels with the dir on quarantine and dies with it on
    prune.  Single-host: the manifest alone."""
    return [manifest_path(path)]


def invalidate_commit(path: str | os.PathLike) -> None:
    """Remove a previous save's manifest BEFORE ``path`` is rewritten
    (rank 0 only): the new bytes must never be read against the old
    checksums.  The JAX package also clears its multi-host commit marker
    and host manifests here; the port writes neither."""
    if rank() != 0:
        return
    for p in _sidecar_paths(path):
        try:
            os.unlink(p)
        except OSError:
            pass


def _flatten(tree: Any, prefix: str = "", top: bool = True):
    """``(keystr, leaf)`` pairs of a nested dict, sorted by key as JAX
    flattens a dict: ``.name`` at the top level (the fields of JAX's
    ``TrainState``) and ``['key']`` below, the names
    ``jax.tree_util.keystr`` gives the same state."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            part = f".{key}" if top else f"[{key!r}]"
            yield from _flatten(tree[key], prefix + part, False)
    else:
        yield prefix, tree


def _as_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf's bytes as a C-contiguous numpy array and its dtype name
    (bfloat16, which numpy lacks, is viewed as int16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if not arr.flags.c_contiguous:  # (np.ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    return arr, str(arr.dtype)


def _crc32(arr: np.ndarray) -> int:
    if arr.size == 0:
        return zlib.crc32(b"") & 0xFFFFFFFF
    return zlib.crc32(memoryview(arr).cast("B")) & 0xFFFFFFFF


def leaf_checksums(tree: Any) -> dict:
    """Per-leaf crc32, dtype and shape of a checkpoint tree, keyed by the
    JAX package's ``keystr`` names (:func:`_flatten`)."""
    out = {}
    for key, leaf in _flatten(tree):
        arr, dtype = _as_numpy(leaf)
        out[key] = {"crc32": _crc32(arr), "dtype": dtype,
                    "shape": list(arr.shape)}
    return out


def write_manifest(path: str | os.PathLike, tree: Any) -> str:
    """Write the format-1 manifest of the checkpoint at ``path``."""
    mpath = manifest_path(path)
    payload = {"format": 1, "leaves": leaf_checksums(tree)}

    def _write() -> None:
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, mpath)

    _retry_fs(_write)
    return mpath


def read_manifest(path: str | os.PathLike) -> dict | None:
    """The manifest payload of the checkpoint at ``path``, or None if it
    is absent or unreadable."""
    def _read() -> dict:
        with open(manifest_path(path)) as f:
            return json.load(f)

    try:
        return _retry_fs(_read)
    except (json.JSONDecodeError, OSError):
        return None


def verify_restored(path: str | os.PathLike, tree: Any) -> tuple[bool, str]:
    """Hold a tree read from ``path`` against the manifest written when
    it was saved: ``(ok, detail)``.  A checkpoint without a manifest
    verifies vacuously, as in the JAX package."""
    payload = read_manifest(path)
    if payload is None:
        return True, "no manifest (unverified checkpoint)"
    have = dict(_flatten(tree))
    checked = 0
    for key, rec in payload.get("leaves", {}).items():
        if key not in have:
            return False, f"leaf {key} missing from restored tree"
        if "crc32" not in rec:
            continue
        arr, dtype = _as_numpy(have[key])
        if list(arr.shape) != rec.get("shape", list(arr.shape)) or \
                dtype != rec.get("dtype", dtype):
            return False, (f"leaf {key} is {dtype}{list(arr.shape)}, saved "
                           f"as {rec.get('dtype')}{rec.get('shape')}")
        got = _crc32(arr)
        if got != rec["crc32"]:
            return False, (f"leaf {key} checksum mismatch (saved "
                           f"{rec['crc32']}, restored {got})")
        checked += 1
    return True, f"{checked} leaf checksums verified"


# -- save and restore -------------------------------------------------------

def _tree_of(state: Any) -> Any:
    """A TrainState's checkpoint tree (collective with ``compress``:
    every rank must call it), or a tree as it is."""
    from tpudp_torch.train import TrainState, state_to_jax

    return state_to_jax(state) if isinstance(state, TrainState) else state


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=tree.device.type == "cpu")
    return tree


def _write_tree(path: str, tree: Any, manifest: bool = True) -> None:
    """Rank 0's write: ``path/state.pt`` through a temporary name and
    ``os.replace``, then (``manifest``) the manifest beside the
    directory."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, STATE_FILE)
    tmp = final + ".tmp"

    def _save() -> None:
        torch.save(tree, tmp)
        os.replace(tmp, final)

    _retry_fs(_save)
    if manifest:
        write_manifest(path, tree)


def _refuse_existing(path: str, force: bool) -> None:
    """orbax's rule for ``force=False``: an existing ``path`` is refused,
    on every rank alike (the ranks decide together before any write)."""
    if not force and coordinated_any(os.path.exists(path)):
        raise ValueError(f"Destination {path} already exists.")


def save_checkpoint(path: str | os.PathLike, state: Any, *,
                    force: bool = True, manifest: bool = True) -> str:
    """Write ``state`` (a :class:`tpudp_torch.train.TrainState`, or a
    checkpoint tree) to the directory ``path``, with (``manifest``) its
    checksum manifest beside it.  Every rank calls it; rank 0 writes,
    and all ranks meet at a barrier after the write.  A checkpoint
    already at ``path`` is replaced, or with ``force=False`` refused
    (``ValueError``, as orbax refuses it).  Without a manifest the
    checkpoint verifies vacuously (:func:`verify_restored`), as in the
    JAX package."""
    path = os.path.abspath(os.fspath(path))
    _refuse_existing(path, force)
    tree = _tree_of(state)
    if rank() == 0:
        invalidate_commit(path)
        _write_tree(path, _to_cpu(tree), manifest)
    barrier()
    return path


def _load_tree(path: str) -> Any:
    file = os.path.join(os.fspath(path), STATE_FILE)
    return _retry_fs(lambda: torch.load(file, map_location="cpu",
                                        weights_only=True))


def restore_checkpoint(path: str | os.PathLike, target: Any = None, *,
                       verify: bool = False) -> Any:
    """Read the checkpoint at ``path``.  With a TrainState ``target`` its
    contents are loaded into it (:func:`tpudp_torch.train.load_state`)
    and the target is returned; without one, the tree is returned.
    ``verify=True`` recomputes the checksums of what was read against
    the manifest first and raises :class:`CheckpointCorruptError` on a
    mismatch, leaving the target untouched."""
    path = os.path.abspath(os.fspath(path))
    tree = _load_tree(path)
    if verify:
        ok, detail = verify_restored(path, tree)
        if not ok:
            raise CheckpointCorruptError(f"checkpoint {path} corrupt: "
                                         f"{detail}")
    if target is None:
        return tree
    from tpudp_torch.train import load_state

    load_state(target, tree)
    return target


def restore_params(path: str | os.PathLike) -> dict:
    """Only the ``params`` of a saved state, by JAX names — read without
    a target, as the JAX package's item-free restore does, so a tool
    that serves or evaluates needs no knowledge of the optimizer."""
    tree = _load_tree(os.path.abspath(os.fspath(path)))
    try:
        return tree["params"]
    except (KeyError, TypeError):
        raise ValueError(f"{os.fspath(path)!r} holds no 'params' subtree — "
                         "not a saved TrainState?") from None


# -- the step series --------------------------------------------------------

def step_dirs_newest_first(root: str | os.PathLike) -> list[str]:
    """All exact ``step_<digits>`` directories under ``root``, highest N
    first."""
    root = os.fspath(root)
    if not os.path.isdir(root):
        return []
    steps = sorted((int(m.group(1)), m.group(0))
                   for d in os.listdir(root) if (m := _STEP_DIR.match(d)))
    return [os.path.join(root, name) for _, name in reversed(steps)]


def latest_step_dir(root: str | os.PathLike) -> str | None:
    """The highest-numbered ``step_N`` directory, or None; only exact
    ``step_<digits>`` names count (not ``step_N.corrupt``)."""
    dirs = step_dirs_newest_first(root)
    return dirs[0] if dirs else None


def _step_of(path: str) -> int:
    return int(os.path.basename(path).rsplit("_", 1)[1])


def quarantine_step_dir(path: str) -> None:
    """Move a rejected ``step_N`` dir and its manifest aside to
    ``step_N.corrupt``: out of the series (no walk counts it twice, no
    prune mistakes it for live state), bytes kept for forensics."""
    base = os.path.abspath(os.fspath(path))
    target = base + ".corrupt"
    sidecars = _sidecar_paths(base)
    try:
        if os.path.isdir(target):
            shutil.rmtree(target)
        os.rename(base, target)
    except OSError:
        return
    for src in sidecars:
        try:
            os.replace(src, target + src[len(base):])
        except OSError:
            pass


def restore_latest_verified(root: str | os.PathLike, target: Any, *,
                            log=print) -> tuple[Any, str, list]:
    """Restore the newest intact ``step_N`` checkpoint under ``root`` into
    ``target`` (a TrainState).  A dir that fails to load or to verify is
    quarantined by rank 0 (logged) and the walk falls back to the next.

    With several ranks the walk is voted: each rank finds its newest
    verified step at or below the bound, one all-reduce takes the
    minimum and maximum of the proposals, and the ranks repeat at the
    minimum until they agree — so every rank restores the same step.
    Returns ``(target, path, skipped)`` with ``skipped`` the ``(path,
    reason)`` of every rejected dir.  Raises FileNotFoundError when no
    rank has a step dir and RuntimeError when none is restorable."""
    pending = step_dirs_newest_first(root)
    multi = world_size() > 1
    if not pending and not multi:
        # tpudp: lint-ok(protocol-early-exit): single-host-only raise —
        # the `not multihost` conjunct (process_count, host-uniform)
        # makes this arm unreachable on a pod; multihost exhaustion is
        # voted through the alignment gather below (-1 proposal), which
        # aborts every host together.
        raise FileNotFoundError(
            f"no step_N checkpoints under {os.fspath(root)!r}")
    skipped: list[tuple[str, str]] = []
    found: tuple[str, Any] | None = None
    bound = None
    first_round = True
    while True:
        if found is not None and bound is not None \
                and _step_of(found[0]) > bound:
            skipped.append((found[0], "newer than the step every rank "
                            "verified; skipped without quarantine"))
            found = None  # a peer cannot restore this one
        while found is None and pending:
            path = pending[0]
            if bound is not None and _step_of(path) > bound:
                pending.pop(0)
                skipped.append((path, "newer than the step every rank "
                                "verified; skipped without quarantine"))
                continue
            try:
                tree = restore_checkpoint(path, None, verify=True)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                reason = f"{type(e).__name__}: {e}"
                skipped.append((path, reason))
                log(f"[tpudp] WARNING: checkpoint {path} unrestorable "
                    f"({reason}); quarantining it and falling back to the "
                    "previous step dir")
                if rank() == 0:
                    quarantine_step_dir(path)
                pending.pop(0)
                continue
            found = (path, tree)
            pending.pop(0)
        proposal = _step_of(found[0]) if found is not None else -1
        if not multi:
            break
        lo, neg_hi = _all_reduce([proposal, -proposal], dist.ReduceOp.MIN)
        hi = -neg_hi
        if lo == hi:
            break
        if lo < 0:
            break
        bound, first_round = lo, False
    # Several ranks decide on the reduced proposals alone (a rank with
    # nothing proposed -1, so lo < 0 on every rank together).
    if multi and lo < 0 and first_round and hi < 0:
        raise FileNotFoundError(
            f"no step_N checkpoints under {os.fspath(root)!r} (on any "
            "rank)")
    exhausted = (f"no step_N checkpoint under {os.fspath(root)!r} is "
                 f"restorable on every rank ({len(skipped)} tried here); "
                 "refusing to silently restart from scratch — remove the "
                 "directory to train fresh")
    if multi and lo < 0:
        # `lo` is the all-reduced minimum of the proposals: every rank
        # takes this arm together.
        raise RuntimeError(exhausted)
    if not multi and found is None:
        # tpudp: lint-ok(protocol-early-exit): single-host-only raise —
        # the `not multihost` conjunct (process_count, host-uniform)
        # makes this arm unreachable on a pod; multihost exhaustion is
        # voted through the alignment gather below (-1 proposal), which
        # aborts every host together.
        raise RuntimeError(exhausted)
    from tpudp_torch.train import load_state

    load_state(target, found[1])
    barrier()  # rank 0's quarantine renames are done for everyone
    return target, found[0], skipped


def prune_step_dirs(root: str | os.PathLike, keep: int) -> list[str]:
    """Delete all but the newest ``keep`` ``step_N`` checkpoints under
    ``root`` (rank 0 only; a no-op elsewhere) and return the deleted
    paths.  The newest verifiable checkpoint (one with a manifest, or a
    complete ``state.pt``) is never deleted, even outside the window:
    when the newer dirs are torn it is the only restorable state left.
    A pruned dir's manifest goes with it."""
    root = os.fspath(root)
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    if rank() != 0:
        return []
    newest_first = step_dirs_newest_first(root)
    protected = next(
        (path for path in newest_first
         if os.path.exists(manifest_path(path))
         or os.path.exists(os.path.join(path, STATE_FILE))), None)
    deleted = []
    for path in list(reversed(newest_first))[:-keep]:
        if path == protected:
            continue
        sidecars = _sidecar_paths(path)
        try:
            shutil.rmtree(path)
        except OSError as e:
            print(f"[tpudp] WARNING: could not prune checkpoint {path}: {e}")
            continue
        for sidecar in sidecars:
            try:
                os.unlink(sidecar)
            except FileNotFoundError:
                pass
            except OSError as e:
                print(f"[tpudp] WARNING: could not remove sidecar of pruned "
                      f"checkpoint {path}: {e}")
        deleted.append(path)
    return deleted


def ensure_writable(root: str | os.PathLike) -> str:
    """Fail-fast probe for ``--save-checkpoint``: create ``root`` and
    write a file there BEFORE any compute is spent."""
    root = os.path.abspath(os.fspath(root))
    os.makedirs(root, exist_ok=True)
    probe = os.path.join(root, ".write_probe")
    with open(probe, "w") as f:
        f.write("ok")
    os.unlink(probe)
    return root


# -- asynchronous writes ----------------------------------------------------

class AsyncCheckpointWriter:
    """Checkpoint writes overlapped with training.

    ``save()`` takes the state's tree, copies every tensor to host memory
    (pinned, through non-blocking copies queued on the current stream
    behind the work that produced them, on a card; a clone on the CPU)
    and returns; a thread then waits for those copies, serializes,
    checksums and writes.  The next step may update the state in place at
    once: the copies read it first in stream order.  At most one write is
    in flight — the next ``save()``, ``wait()`` and ``close()`` each join
    it (and meet the other ranks at a barrier) — so a crash can lose only
    the newest checkpoint.  A write's error is raised by that join.
    ``last_write_s`` is the background time of the newest joined write.

    Usage::

        with AsyncCheckpointWriter() as writer:
            for epoch ...:
                trainer.train_epoch(...)
                writer.save(f"{root}/step_{epoch + 1}", trainer.state)
    """

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pending = False
        self._pinned: dict[str, torch.Tensor] = {}
        self.last_write_s: float | None = None

    def _snapshot(self, tree: Any, prefix: str = ""):
        if isinstance(tree, dict):
            return {k: self._snapshot(v, f"{prefix}/{k}")
                    for k, v in tree.items()}
        if not isinstance(tree, torch.Tensor):
            return tree
        t = tree.detach()
        if t.device.type != "cuda":
            return t.clone()
        buf = self._pinned.get(prefix)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[prefix] = buf
        buf.copy_(t, non_blocking=True)
        return buf

    def _write(self, path: str, tree: Any, ready, manifest: bool) -> None:
        start = time.perf_counter()
        try:
            if ready is not None:
                ready.synchronize()
            _write_tree(path, tree, manifest)
        except BaseException as e:  # raised by the next join
            self._error = e
        self.last_write_s = time.perf_counter() - start

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, path: str | os.PathLike, state: Any, *,
             force: bool = True, manifest: bool = True) -> str:
        """Start writing ``state`` to ``path``; every rank calls it.
        ``force`` and ``manifest``: :func:`save_checkpoint`'s."""
        path = os.path.abspath(os.fspath(path))
        self._join()
        _refuse_existing(path, force)
        tree = _tree_of(state)
        if rank() == 0:
            invalidate_commit(path)
            snap = self._snapshot(tree)
            ready = None
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                ready = torch.cuda.Event()
                ready.record()
            self._thread = threading.Thread(
                target=self._write, args=(path, snap, ready, manifest),
                daemon=True, name="tpudp-ckpt-writer")
            self._thread.start()
        self._pending = True
        return path

    def wait(self) -> None:
        """Block until every started save is on disk."""
        self._join()

    def close(self) -> None:
        """Join the outstanding write and release the pinned buffers."""
        try:
            self._join()
        finally:
            self._pinned.clear()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- emergency dumps --------------------------------------------------------

def _emergency_sentinel_path(root: str | os.PathLike) -> str:
    return os.path.join(os.fspath(root), _EMERGENCY_SENTINEL)


def clear_emergency_sentinel(root: str | os.PathLike) -> None:
    """Invalidate the emergency dump BEFORE a new dump starts writing (or
    after a restore consumed it)."""
    try:
        os.unlink(_emergency_sentinel_path(root))
    except FileNotFoundError:
        pass


def write_emergency_sentinel(root: str | os.PathLike,
                             step: int | None = None,
                             per_epoch_batches: int | None = None) -> None:
    """Mark the emergency dump complete — only after its save returned.
    ``per_epoch_batches`` records the interrupted run's loader length, so
    a resume can check that the step counter maps onto the same batch
    grid."""
    with open(_emergency_sentinel_path(root), "w") as f:
        json.dump({"step": step, "per_epoch_batches": per_epoch_batches,
                   "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                               time.gmtime())}, f)


def read_emergency_sentinel(root: str | os.PathLike) -> dict | None:
    """The sentinel's payload, or None if absent or unreadable."""
    try:
        with open(_emergency_sentinel_path(root)) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return None


def _move_dump(root: str | os.PathLike, suffix: str) -> str | None:
    """Rename ``root/emergency`` (and its manifest) to
    ``emergency<suffix>``, replacing an earlier one."""
    emerg = os.path.abspath(os.path.join(os.fspath(root), "emergency"))
    target = emerg + suffix
    sidecars = _sidecar_paths(emerg)
    try:
        if os.path.isdir(target):
            shutil.rmtree(target)
        os.rename(emerg, target)
    except OSError:
        return None
    for src in sidecars:
        try:
            os.replace(src, target + src[len(emerg):])
        except OSError:
            pass
    return target


def consume_emergency(root: str | os.PathLike) -> str:
    """Consume a restored emergency dump: rename ``root/emergency`` to
    ``emergency.restored`` and clear the sentinel, so later resumes fall
    back to the ``step_N`` series."""
    consumed = _move_dump(root, ".restored")
    if consumed is None:
        raise OSError(f"could not consume the emergency dump under "
                      f"{os.fspath(root)!r}")
    clear_emergency_sentinel(root)
    return consumed


def quarantine_emergency(root: str | os.PathLike) -> str | None:
    """Move a corrupt emergency dump aside (``emergency.corrupt``) and
    clear its sentinel, so resume falls back to the ``step_N`` series;
    returns the new path, or None if the rename failed."""
    moved = _move_dump(root, ".corrupt")
    clear_emergency_sentinel(root)
    return moved


def emergency_dir(root: str | os.PathLike) -> str | None:
    """The emergency dump's directory if a COMPLETE one exists: its
    sentinel is present, or its ``state.pt`` (which ``os.replace`` made
    whole).  A dump with neither is moved aside to
    ``emergency.truncated`` with a warning, and None returned."""
    path = os.path.join(os.fspath(root), "emergency")
    if not os.path.isdir(path):
        return None
    if (os.path.exists(_emergency_sentinel_path(root))
            or os.path.exists(os.path.join(path, STATE_FILE))):
        return path
    quarantined = path + ".truncated"
    try:
        if os.path.isdir(quarantined):
            shutil.rmtree(quarantined)
        os.rename(path, quarantined)
        moved = f"; moved to {quarantined}"
    except OSError as e:
        moved = f"; could not move aside ({e})"
    print(f"[tpudp] WARNING: ignoring emergency dump {path} — no completion "
          f"sentinel and no {STATE_FILE} (the dump was interrupted "
          f"mid-write){moved}; falling back to the epoch checkpoint series")
    return None


def restore_emergency_voted(root: str | os.PathLike, emerg: str,
                            target: Any, *, log=print) -> Any | None:
    """Restore and verify the emergency dump at ``emerg`` into ``target``
    with the accept decision unanimous across ranks: returns the target,
    or None when any rank rejected the dump — rank 0 then quarantines it
    and the caller falls back to the ``step_N`` series."""
    tree, err = None, None
    try:
        tree = restore_checkpoint(emerg, None, verify=True)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:
        err = e
    if all_ranks_ok(err is None):
        from tpudp_torch.train import load_state

        load_state(target, tree)
        return target
    log(f"[tpudp] WARNING: emergency dump {emerg} failed restore/"
        f"verification ({err if err is not None else 'on a peer rank'}); "
        "quarantining it and falling back to the epoch checkpoint series")
    if rank() == 0:
        quarantine_emergency(root)
    barrier()
    return None
