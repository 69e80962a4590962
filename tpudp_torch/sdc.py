"""Silent-data-corruption defense — the port of ``tpudp/sdc.py``:
replica fingerprints, the majority vote and deterministic bit-flip
injectors.

A chip that computes wrong but finite numbers passes every loud
detector (non-finite windows, exceptions, hangs, checkpoint checksums),
and the data-parallel all-reduce then spreads the damage.  Data
parallelism is its own check: healthy replicas hold bit-identical
parameters and optimizer state after the synchronized update, so any
disagreement of their checksums is corruption, and with three or more
replicas a majority vote names the bad one.  The supervisor's bit-exact
rollback and replay (``tpudp_torch.resilience``) is the repair and the
oracle that grades a detection.

In the port a replica is a RANK (one process, one device), so the vote
is JAX's multi-host path: every rank computes :func:`fingerprint` over
its own bytes inside the train step (``TrainState.sdc_fp``), and the
supervisor gathers one small row per rank at the window edge.  Replica
keys are ``p<rank>`` where JAX's single-process keys are
``p0/d<device>``.

  * :func:`fingerprint` — ``[checksum, count]``: the wraparound u32 sum
    of every element's raw bits (an 8-byte element contributes its two
    32-bit halves, a 1- or 2-byte element its unsigned value) and the
    element count, computed on the tensors' device (copies of at most
    128 MiB batch the reductions).  It equals :func:`np_fingerprint` bit for bit on the
    same bytes.  A float sum would round a low-mantissa flip away; an
    integer sum of the bit patterns cannot.
  * :func:`localize_minority` — the vote over replica fingerprints.
  * :class:`BitFlipParams` / :class:`BitFlipGrads` — a ``(step,
    replica, bit)`` schedule (or ``persist_from``) applied through
    ``Trainer(sdc_fault_hook=...)``: the injector on rank ``replica``
    flips one bit of the first floating tensor in place, through an
    integer view; the other ranks leave their bytes alone.

Response grading (the Supervisor): a first detection rolls back to the
newest verified checkpoint and replays; a clean re-check past the
detection step is a TRANSIENT flip (params repaired bit for bit); the
same localized rank diverging again is PERSISTENT — that rank writes
:data:`QUARANTINE_MARKER` and exits :data:`SDC_QUARANTINE_EXIT`, the
others raise :class:`SdcPersistentError`, and the relaunch resumes at
fewer ranks through ``restore_newest`` and ``ShardedSampler(
batch_contiguous=)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: Exit code of the rank a persistent verdict quarantines (the watchdog
#: exits 42, a failed recovery vote 43).
SDC_QUARANTINE_EXIT = 44

#: The marker (under ``ResiliencePolicy.checkpoint_dir``) written before
#: a quarantine exit; the relaunch reads it to shrink the geometry.
QUARANTINE_MARKER = "sdc_quarantine.json"


class SdcDetected(RuntimeError):
    """Replica fingerprints disagree.  ``replica`` names the minority
    (None where the vote could not: a two-replica tie)."""

    def __init__(self, message: str, *, step: int | None = None,
                 replica=None, fingerprints=None):
        super().__init__(message)
        self.step = step
        self.replica = replica
        self.fingerprints = dict(fingerprints or {})


class SdcPersistentError(RuntimeError):
    """The same replica diverged again after a bit-exact replay: a bad
    chip, not a transient flip."""

    def __init__(self, message: str, *, replica=None):
        super().__init__(message)
        self.replica = replica


def _np_bits_u32(a: np.ndarray) -> np.ndarray:
    """The raw bits of ``a`` widened to uint32 (an 8-byte element is the
    sum of its two halves)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.bool_:
        a = a.astype(np.uint8)
    nbytes = a.dtype.itemsize
    if nbytes >= 8:
        v = a.view(np.uint64).ravel()
        return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                .astype(np.uint64)
                + (v >> np.uint64(32)).astype(np.uint32).astype(np.uint64)
                ).astype(np.uint32)
    view = {1: np.uint8, 2: np.uint16, 4: np.uint32}[nbytes]
    return a.view(view).ravel().astype(np.uint32)


def np_fingerprint(arrays) -> np.ndarray:
    """The host twin of :func:`fingerprint` over numpy arrays:
    ``[checksum, count]`` as uint64, each mod 2^32."""
    total = np.uint64(0)
    count = np.uint64(0)
    for a in arrays:
        bits = _np_bits_u32(np.asarray(a))
        total = (total + np.uint64(bits.sum(dtype=np.uint64))) \
            & np.uint64(0xFFFFFFFF)
        count = (count + np.uint64(bits.size)) & np.uint64(0xFFFFFFFF)
    return np.array([total, count], dtype=np.uint64)


def _narrow_bits_sum(t):
    """The sum of a 1- or 2-byte (or bool) tensor's elements' unsigned
    values as an int64 device scalar: a 2-byte element adds 2^16 where
    its signed view is negative."""
    import torch

    t = t.detach()
    if t.element_size() == 1:
        return t.view(torch.uint8).sum(dtype=torch.int64)
    v = t.view(torch.int16)
    return v.sum(dtype=torch.int64) + (v < 0).sum(dtype=torch.int64) * 65536


#: The most 32-bit words one concatenation of :func:`partial_fingerprint`
#: holds (128 MiB): the 4- and 8-byte tensors are summed a batch at a time
#: with one copy and one reduction, not one reduction a tensor.
FINGERPRINT_BATCH_WORDS = 1 << 25


def partial_fingerprint(tensors):
    """``[bits sum, count]`` of ``tensors`` as an int64 (2,) tensor, not
    yet reduced mod 2^32 — partial sums of several ranks add up before
    :func:`finish_fingerprint`.  An entry may be an int (the element
    count of a tensor of zeros, whose bits add nothing).  The 4- and
    8-byte tensors' 32-bit words are concatenated in batches of up to
    :data:`FINGERPRINT_BATCH_WORDS` and each batch summed once (a model's
    few hundred tensors would otherwise cost a launch each): the signed
    words sum to the unsigned sum less a multiple of 2^32, and an 8-byte
    element's two halves are JAX's ``lo + hi``."""
    import torch

    sums, words, count, device = [], [], 0, None
    for t in tensors:
        if isinstance(t, int):
            count += t
            continue
        count += t.numel()
        if device is None:
            device = t.device
        if t.element_size() in (4, 8) and t.dtype != torch.bool:
            words.append(t.detach().contiguous().reshape(-1)
                         .view(torch.int32))
        else:
            sums.append(_narrow_bits_sum(t))
    batch, size = [], 0
    for w in words + [None]:
        if batch and (w is None or size + w.numel() > FINGERPRINT_BATCH_WORDS):
            flat = batch[0] if len(batch) == 1 else torch.cat(batch)
            sums.append(flat.sum(dtype=torch.int64))
            batch, size = [], 0
        if w is not None:
            batch.append(w)
            size += w.numel()
    total = (torch.stack(sums).sum() if sums
             else torch.zeros((), dtype=torch.int64, device=device))
    return torch.stack([total, torch.tensor(count, dtype=torch.int64,
                                            device=total.device)])


def finish_fingerprint(fp):
    """Both entries of a partial fingerprint reduced mod 2^32."""
    return fp & 0xFFFFFFFF


def fingerprint(tensors):
    """``[checksum, count]`` (int64, each mod 2^32) of ``tensors`` on
    their device — the counterpart of JAX's ``traced_fingerprint``."""
    return finish_fingerprint(partial_fingerprint(list(tensors)))


def localize_minority(fps: dict) -> tuple[list, list]:
    """Majority vote over replica fingerprints: ``(minority_keys,
    majority_keys)``.  Empty minority: every replica agrees.  Naming a
    bad replica needs a strict majority; without one (two replicas
    disagreeing, a 2-2 split) every key is minority and the majority is
    empty: corruption proven, culprit unknown."""
    if not fps:
        return [], []
    groups: dict = {}
    for k, v in fps.items():
        groups.setdefault(np.asarray(v).tobytes(), []).append(k)
    if len(groups) == 1:
        return [], sorted(fps)
    best = max(groups.values(), key=len)
    if len(best) * 2 <= len(fps):
        return sorted(fps), []  # no strict majority: unlocalizable
    minority = sorted(k for k in fps if k not in best)
    return minority, sorted(best)


# -- deterministic injectors -------------------------------------------


@dataclass(frozen=True)
class BitFlip:
    """One scheduled flip: at the injector's own call ``step``, flip bit
    ``bit`` of element 0 of the target tensor on rank ``replica``."""

    step: int
    replica: int = 0
    bit: int = 0


def first_float_tensor(named):
    """The floating tensor of ``named`` (``(name, tensor)`` pairs) with
    the smallest name: the same target every run."""
    best = None
    for name, t in named:
        if t is not None and t.is_floating_point() and t.numel() > 0:
            if best is None or name < best[0]:
                best = (name, t)
    if best is None:
        raise ValueError("no floating-point tensor to corrupt")
    return best


def flip_bit(t, bit: int) -> None:
    """Flip ``bit`` of ``t``'s element 0 in place, through an integer
    view; the index wraps to the dtype's own width, so the flip is
    always real."""
    import torch

    nbytes = t.element_size()
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[nbytes]
    with torch.no_grad():
        word = t.detach().reshape(-1)[:1].view(view)
        b = bit % (8 * nbytes)
        # the sign bit of a signed view is the negative power of two
        signed = nbytes > 1 and b == 8 * nbytes - 1
        word ^= -(1 << b) if signed else (1 << b)


def flip_bit_on_replica(t, replica: int, bit: int, rank: int) -> bool:
    """Flip ``bit`` of element 0 of ``t`` when this rank is ``replica``
    (the other ranks keep their bytes); returns whether it flipped."""
    if rank != replica:
        return False
    flip_bit(t, bit)
    return True


class _BitFlipInjector:
    """A ``(step, replica, bit)`` schedule for ``Trainer(
    sdc_fault_hook=...)``, called as ``state = hook(state)`` after each
    train step.  The injector counts its own calls, monotonic across
    rollback replays: a one-shot entry fires once ever (the replay is
    clean: the transient verdict), ``persist_from=K`` re-corrupts every
    call from the K-th on (the persistent verdict).  Every rank runs the
    same injector and counts the same calls; only rank ``replica``
    changes its bytes, but ``fired`` records the flip on every rank."""

    def __init__(self, schedule=(), *, persist_from: int | None = None,
                 replica: int = 0, bit: int = 0):
        self.schedule = tuple(
            e if isinstance(e, BitFlip) else BitFlip(*e) for e in schedule)
        if persist_from is not None and persist_from < 0:
            raise ValueError(f"persist_from must be >= 0, got {persist_from}")
        self.persist_from = persist_from
        self.replica = replica
        self.bit = bit
        self.fired: list[tuple[int, int, int]] = []
        self._calls = 0

    def _target(self, state):
        raise NotImplementedError

    def __call__(self, state):
        from tpudp_torch.utils.checkpoint import rank

        self._calls += 1
        step = self._calls
        flips = [f for f in self.schedule
                 if f.step == step and (f.step, f.replica, f.bit)
                 not in self.fired]
        if self.persist_from is not None and step >= self.persist_from:
            flips.append(BitFlip(step, self.replica, self.bit))
        for f in flips:
            _, t = self._target(state)
            flip_bit_on_replica(t, f.replica, f.bit, rank())
            self.fired.append((f.step, f.replica, f.bit))
        return state


def _param_tensors(state):
    """``(name, tensor)`` of the tensors the optimizer updates: a sharded
    rung's leaves (1f1b_mpmd's sharded update holds them empty between
    steps), else the model's parameters."""
    if getattr(state, "layout", None) is not None:
        return [(lf.name, lf.local) for lf in state.layout.leaves]
    return list(state.model.named_parameters())


class BitFlipParams(_BitFlipInjector):
    """Flip a bit in one replica's post-update PARAMETERS: the next
    fingerprint check sees it.  Where the optimizer's tensors are empty
    between steps (1f1b_mpmd's sharded update), the stage's module holds
    the parameters."""

    def _target(self, state):
        named = [(n, t) for n, t in _param_tensors(state) if t.numel()]
        return first_float_tensor(named
                                  or list(state.model.named_parameters()))


class BitFlipGrads(_BitFlipInjector):
    """Flip a bit in one replica's OPTIMIZER STATE (the momentum, or
    AdamW's ``exp_avg`` — optax's ``mu``), where a corrupted gradient
    lands and keeps poisoning later updates.  A buffer torch has not
    made yet is made as zeros, its value before the first update."""

    def _target(self, state):
        import torch

        opt = state.optimizer
        key = ("exp_avg" if isinstance(opt, torch.optim.AdamW)
               else "momentum_buffer")
        named = []
        for name, p in _param_tensors(state):
            st = opt.state[p]
            if st.get(key) is None:
                st[key] = torch.zeros_like(p)
            named.append((name, st[key]))
        return first_float_tensor(named)
