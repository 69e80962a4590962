"""Disaggregated serving: prefill and decode split across engines, with
live KV page migration — the port of ``tpudp/serve/disagg.py``.

:meth:`Engine.export_ticket` detaches a live request into a
:class:`MigrationTicket` (its tokens, the slot's generator state and the
crc32-stamped payloads of its prefix pages), the ticket rides the
collective seam (:func:`tpudp_torch.utils.checkpoint.gather_host_blobs`
over ``torch.distributed``), and the receiving engine re-admits it with
:meth:`Engine.admit_ticket`: the pages are adopted into its own pool
through ``PageIndex.adopt`` and the continuation is exact, because a
migration is the vacate/resume carry landing on another engine.  On the
card the receiver's final chunk runs through the paged-window kernel and
its decode steps and fused windows through the paged-decode kernel, over
the adopted pages.

The wire format is JAX's byte for byte (:func:`pack_batch`): magic
``TPDG``, version 1, a framing crc32, a JSON header, and a crc32 per
array.  The handshake is four joint phases a round, every live rank
calling :meth:`DisaggHost.round` in lockstep:

    offer      gather each rank's outbox size and done flag
               (``gather_host_values`` twice; an idle rank offers zero
               bytes rather than skipping)
    transfer   one ``gather_host_blobs`` of every rank's packed batch
    adopt-ack  each receiver verifies and admits the tickets addressed
               to it; a corrupt or torn transfer is quarantined on the
               receiver (flight dump, stats) without leaving the round
    release    each sender resolves its pending tickets against the
               gathered acks: acked tickets are done, the others retry
               with backoff and finally fall back to local re-admission
               under a typed :class:`MigrationFailed`; an
               ``all_hosts_ok`` seal closes the round

Every collective of :meth:`DisaggHost.round` is unconditional and the
quarantine arm holds no collective and no early exit.  JAX proves both
with its protocol verifier and migration model checker
(``tpudp.analysis.protocol``), which read that package's source; the
verifier is not ported yet (ROADMAP.md Queue 1, the analysis item), so
here the properties are held by review and by the tests.

:class:`DisaggCluster` runs the same state machine in one process — one
prefill engine and N decode engines driven phase-locked, blobs delivered
directly in place of the collectives — with a failover journal of every
live request's tokens and generator state, so a killed decode host's
requests, or a canary-quarantined engine's, continue exactly elsewhere.
"""

from __future__ import annotations

import contextlib
import json
import time
import zlib
from dataclasses import dataclass, field

import numpy as np

from tpudp_torch.utils.checkpoint import (all_hosts_ok, gather_host_blobs,
                                          gather_host_values)

_MAGIC = b"TPDG"
_VERSION = 1


class MigrationFailed(RuntimeError):
    """One request's migration could not complete (dropped transfer,
    receiver nack, geometry mismatch) after its retry budget.  The
    request itself is SAFE: the sender falls back to local
    re-admission — functionally a local pressure-vacate, the request
    requeues on the host that already holds it — so a flaky link
    degrades throughput, never correctness.  Carries ``rid``, ``dest``
    and ``attempts`` for the caller's accounting."""

    def __init__(self, msg: str, *, rid: int = -1, dest: int = -1,
                 attempts: int = 0):
        super().__init__(msg)
        self.rid = rid
        self.dest = dest
        self.attempts = attempts


class TransferCorrupt(RuntimeError):
    """A received transfer failed its integrity checks: torn framing
    (truncated blob, whole-blob crc mismatch — a sender that died
    mid-transfer) or a page payload whose crc32 stamp does not match
    its bytes.  Quarantined ON THE RECEIVER (flight dump +
    ``quarantined_transfers``); never propagates across the
    rendezvous."""


@dataclass
class MigrationTicket:
    """Everything one request needs to continue bit-identically on
    another host: identity + sampling params, the emitted tokens, the
    slot's generator state as of the last committed token (the
    vacate/resume carry), and the chunk-prefilled prefix pages as raw
    host payloads (optional — a ticket without pages re-prefills
    deterministically on the receiver, which is also the failover path
    where the dead host's pool is gone)."""

    rid: int
    model: str | None
    prompt: np.ndarray
    tokens: tuple
    max_new_tokens: int
    temperature: float
    top_k: int
    top_p: float
    seed: int
    eos_id: int | None
    deadline_s: float | None
    tenant: str | None
    migrations: int
    preemptions: int
    draft_proposed: int
    draft_accepted: int
    resume_key: np.ndarray | None
    page_tokens: int
    pages: tuple = ()


# -- wire format ------------------------------------------------------
#
# batch blob = MAGIC + u16 version + u64 body_len + u32 crc32(body)
#              + body
# body       = u64 header_len + header(json) + payload bytes
#
# Arrays (prompt, resume key, every page payload field) live in the
# payload region; the header records per-array dtype/shape/offset and a
# crc32 stamp per array.  The outer crc detects TORN transfers (sender
# died mid-send, truncated delivery); the per-array stamps localize
# corruption to a page payload.  Ticket entries carry src/dest ranks so
# one allgathered blob can address several receivers.


def _pack_array(arr: np.ndarray, payloads: list) -> dict:
    raw = np.ascontiguousarray(arr).tobytes()
    off = sum(len(p) for p in payloads)
    payloads.append(raw)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "off": off, "nbytes": len(raw), "crc": zlib.crc32(raw)}


def _unpack_array(meta: dict, payload: bytes) -> np.ndarray:
    raw = payload[meta["off"]:meta["off"] + meta["nbytes"]]
    if len(raw) != meta["nbytes"] or zlib.crc32(raw) != meta["crc"]:
        raise TransferCorrupt(
            f"page payload crc mismatch (expected {meta['crc']:#x}, "
            f"got {zlib.crc32(raw):#x} over {len(raw)} bytes)")
    return np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).reshape(
        meta["shape"])


def pack_batch(items: list, *, seq: int, src: int) -> bytes:
    """Pack ``[(dest_rank, MigrationTicket), ...]`` into one framed,
    crc-stamped batch blob for the transfer gather."""
    payloads: list = []
    tickets = []
    for dest, t in items:
        pages_meta = [{name: _pack_array(arr, payloads)
                       for name, arr in sorted(payload.items())}
                      for payload in t.pages]
        tickets.append({
            "dest": int(dest), "rid": t.rid, "model": t.model,
            "prompt": _pack_array(np.asarray(t.prompt, np.int32),
                                  payloads),
            "tokens": [int(x) for x in t.tokens],
            "max_new_tokens": t.max_new_tokens,
            "temperature": t.temperature, "top_k": t.top_k,
            "top_p": t.top_p, "seed": t.seed, "eos_id": t.eos_id,
            "deadline_s": t.deadline_s, "tenant": t.tenant,
            "migrations": t.migrations, "preemptions": t.preemptions,
            "draft_proposed": t.draft_proposed,
            "draft_accepted": t.draft_accepted,
            "resume_key": (None if t.resume_key is None
                           else _pack_array(np.asarray(t.resume_key),
                                            payloads)),
            "page_tokens": t.page_tokens, "pages": pages_meta,
        })
    header = json.dumps({"seq": int(seq), "src": int(src),
                         "tickets": tickets}).encode()
    body = (len(header).to_bytes(8, "big") + header
            + b"".join(payloads))
    return (_MAGIC + _VERSION.to_bytes(2, "big")
            + len(body).to_bytes(8, "big")
            + zlib.crc32(body).to_bytes(4, "big") + body)


def unpack_batch(blob: bytes):
    """Parse one batch blob back into ``(seq, src, [(dest, ticket)])``,
    verifying the framing and every per-array crc stamp.  Raises
    :class:`TransferCorrupt` on any mismatch — torn framing and flipped
    payload bytes both land here, for the receiver to quarantine."""
    if len(blob) < 18 or blob[:4] != _MAGIC:
        raise TransferCorrupt(
            f"torn transfer: bad framing ({len(blob)} bytes)")
    if int.from_bytes(blob[4:6], "big") != _VERSION:
        raise TransferCorrupt(
            f"transfer version {int.from_bytes(blob[4:6], 'big')} != "
            f"{_VERSION}")
    body_len = int.from_bytes(blob[6:14], "big")
    crc = int.from_bytes(blob[14:18], "big")
    body = blob[18:]
    if len(body) != body_len or zlib.crc32(body) != crc:
        raise TransferCorrupt(
            f"torn transfer: body {len(body)}/{body_len} bytes, crc "
            f"{zlib.crc32(body):#x} != {crc:#x}")
    hlen = int.from_bytes(body[:8], "big")
    header = json.loads(body[8:8 + hlen].decode())
    payload = body[8 + hlen:]
    out = []
    for m in header["tickets"]:
        pages = tuple(
            {name: _unpack_array(meta, payload)
             for name, meta in page.items()}
            for page in m["pages"])
        ticket = MigrationTicket(
            rid=m["rid"], model=m["model"],
            prompt=_unpack_array(m["prompt"], payload),
            tokens=tuple(m["tokens"]),
            max_new_tokens=m["max_new_tokens"],
            temperature=m["temperature"], top_k=m["top_k"],
            top_p=m["top_p"], seed=m["seed"], eos_id=m["eos_id"],
            deadline_s=m["deadline_s"], tenant=m["tenant"],
            migrations=m["migrations"], preemptions=m["preemptions"],
            draft_proposed=m["draft_proposed"],
            draft_accepted=m["draft_accepted"],
            resume_key=(None if m["resume_key"] is None
                        else _unpack_array(m["resume_key"], payload)),
            page_tokens=m["page_tokens"], pages=pages)
        out.append((m["dest"], ticket))
    return header["seq"], header["src"], out


def corrupt_page_bytes(blob: bytes) -> bytes:
    """Flip the LAST payload byte of a batch blob and re-stamp the
    outer framing crc — the fault-injection helper behind
    :class:`tpudp_torch.serve.faults.CorruptPagePayload`: the result passes
    the torn-transfer check but fails exactly one per-array crc, which
    is the "bit flip on the wire" case the receiver must quarantine.
    Raises :class:`ValueError` when the blob carries no payload bytes
    to flip (nothing staged)."""
    body = blob[18:]
    hlen = int.from_bytes(body[:8], "big")
    if len(body) <= 8 + hlen:
        raise ValueError("batch blob has no payload bytes to corrupt")
    body = body[:-1] + bytes([body[-1] ^ 0x01])
    return (blob[:6] + len(body).to_bytes(8, "big")
            + zlib.crc32(body).to_bytes(4, "big") + body)


def _pack_acks(src: int, entries: list, seq: int) -> bytes:
    return json.dumps({"seq": int(seq), "src": int(src),
                       "acks": entries}).encode()


def _unpack_acks(blob: bytes) -> list:
    if not blob:
        return []
    return json.loads(blob.decode()).get("acks", [])


@dataclass
class _Pending:
    """A staged migration awaiting its ack (sender side)."""

    dest: int
    ticket: MigrationTicket
    attempts: int = 1


class DisaggHost:
    """One host's half of the disaggregated arena: a local
    :class:`~tpudp_torch.serve.engine.Engine` plus the migration state
    machine.  ``stage(dest, request)`` exports a live request and
    queues its ticket; :meth:`round` runs the four-phase handshake over
    the real multi-host collective seam (every live host must call it
    together: its call pattern is the same on every host).  The in-process :class:`DisaggCluster` drives the
    same staging/adopt/release methods phase-locked with direct blob
    delivery instead.

    ``faults`` are :mod:`tpudp_torch.serve.faults` transfer injectors
    (``on_send(rank, seq, blob) -> blob`` hooks) applied to this
    host's OUTGOING batch — deterministic wire-level failure, exercised
    by the soak harness."""

    def __init__(self, engine, *, rank: int = 0, n_hosts: int = 1,
                 role: str = "decode", faults=(), retries: int = 2,
                 backoff_s: float = 0.0, on_admit=None, watchdog=None):
        self.engine = engine
        self.rank = int(rank)
        self.n_hosts = int(n_hosts)
        self.role = role
        self.faults = tuple(faults)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.on_admit = on_admit   # callback(src, ticket, request)
        self.watchdog = watchdog
        self.seq = 0
        self.alive = True
        self.failures: list[MigrationFailed] = []
        self._outbox: list[_Pending] = []
        self._pending: list[_Pending] = []

    def _wd(self, phase: str):
        """Scoped watchdog deadline naming one round phase.  A peer
        that dies mid-round leaves this host blocked INSIDE a
        collective — undetectable from within the blocked call — so
        each rendezvous is armed by name (``disagg.migrate_offer`` /
        ``disagg.transfer`` / ``disagg.adopt`` / ``disagg.release``)
        and a hang report says exactly which phase never completed."""
        if self.watchdog is None:
            return contextlib.nullcontext()
        return self.watchdog.step(name=f"disagg.{phase}")

    # -- sender side ---------------------------------------------------

    def stage(self, dest: int, request) -> MigrationTicket:
        """Export ``request`` from the local engine and queue its
        ticket for ``dest`` on the next round.  The request leaves the
        local slot/queue immediately (bit-exact vacate); until the
        receiver acks, the ticket is the request's only live copy, so
        a nack/drop re-admits it locally (:class:`MigrationFailed`
        fallback) rather than losing it."""
        ticket = self.engine.export_ticket(request)
        self._outbox.append(_Pending(int(dest), ticket))
        self.engine.obs.event("migrate_offer", rid=ticket.rid,
                              dest=int(dest), pages=len(ticket.pages))
        return ticket

    def outbox_blob(self) -> bytes:
        """Pack + clear the outbox into this round's transfer blob
        (moving the tickets to the pending-ack list), then run the
        fault injectors over the bytes.  Empty outbox packs to an
        empty blob — the host still joins every rendezvous."""
        items = self._outbox
        self._outbox = []
        blob = b""
        if items:
            blob = pack_batch([(p.dest, p.ticket) for p in items],
                              seq=self.seq, src=self.rank)
            self._pending.extend(items)
        for f in self.faults:
            blob = f.on_send(self.rank, self.seq, blob)
        return blob

    # -- receiver side -------------------------------------------------

    def _quarantine(self, src: int, blob: bytes, exc: Exception) -> None:
        """Contain a corrupt/torn transfer on the receiver: account
        it, dump the flight recorder (the cross-host debugging story —
        the sender's view is on the other host), and drop the bytes.
        Nothing was admitted, so there is nothing to roll back; the
        sender sees no ack for its tickets and handles them through
        the release phase's retry/fallback path."""
        self.engine.stats["quarantined_transfers"] += 1
        self.engine.obs.event("migrate_quarantine", src=int(src),
                              nbytes=len(blob), reason=str(exc))
        self.engine.flight.dump(
            "transfer_quarantined",
            extra={"src": int(src), "rank": self.rank, "seq": self.seq,
                   "nbytes": len(blob), "reason": str(exc)})

    def admit_blob(self, src: int, blob: bytes) -> list:
        """Verify + admit every ticket addressed to this host from one
        sender's batch blob; returns the ack entries.  Framing or
        page-crc corruption raises :class:`TransferCorrupt` (the caller
        quarantines); a per-ticket admission error (geometry mismatch,
        engine closed) nacks that ticket only."""
        _seq, _src, entries = unpack_batch(blob)
        acks = []
        for dest, ticket in entries:
            if dest != self.rank:
                continue
            try:
                with self.engine.obs.span("migrate_adopt",
                                          rid=ticket.rid, src=int(src)):
                    r = self.engine.admit_ticket(ticket)
            except Exception as exc:  # noqa: BLE001 — nack, never wedge
                # An admission refusal (geometry mismatch, engine
                # draining) is a NACK, not corruption: the sender gets
                # a typed answer this round and falls back locally —
                # no flight dump, the bytes were fine.
                self.engine.stats["migration_nacked"] += 1
                self.engine.obs.event(
                    "migrate_nack", src=int(src), rid=ticket.rid,
                    reason=str(exc))
                acks.append({"rid": ticket.rid, "src": int(src),
                             "dest": dest, "ok": False,
                             "why": str(exc)})
                continue
            if self.on_admit is not None:
                self.on_admit(int(src), ticket, r)
            acks.append({"rid": ticket.rid, "src": int(src),
                         "dest": dest, "ok": True, "why": ""})
        return acks

    # -- release phase -------------------------------------------------

    def release_acks(self, ack_entries: list) -> None:
        """Resolve this host's pending tickets against the gathered
        acks.  Acked: done (export already vacated; the sender's
        published prefix pages remain as evictable local cache).
        Nacked or unacknowledged (dropped/quarantined transfer): retry
        up to ``retries`` with ``backoff_s`` linear backoff, then fall
        back to LOCAL re-admission and record a typed
        :class:`MigrationFailed` — the request continues on this host
        exactly like a pressure-vacate resume, so a dead link never
        wedges the arena or loses a request."""
        status = {(e["src"], e["rid"]): e for e in ack_entries
                  if e.get("src") == self.rank}
        pending, self._pending = self._pending, []
        for p in pending:
            st = status.get((self.rank, p.ticket.rid))
            if st is not None and st["ok"]:
                self.engine.obs.event("migrate_release",
                                      rid=p.ticket.rid, dest=p.dest,
                                      attempts=p.attempts)
                continue
            if p.attempts <= self.retries:
                if self.backoff_s:
                    time.sleep(self.backoff_s * p.attempts)
                p.attempts += 1
                self.engine.stats["migration_retries"] += 1
                self._outbox.append(p)
                continue
            why = st["why"] if st is not None else "no ack (transfer lost)"
            err = MigrationFailed(
                f"migration of request {p.ticket.rid} to host {p.dest} "
                f"failed after {p.attempts} attempts: {why}",
                rid=p.ticket.rid, dest=p.dest, attempts=p.attempts)
            self.failures.append(err)
            self.engine.stats["migration_failed"] += 1
            self.engine.obs.event("migrate_failed", rid=p.ticket.rid,
                                  dest=p.dest, attempts=p.attempts,
                                  why=why)
            r = self.engine.admit_ticket(p.ticket)
            if self.on_admit is not None:
                self.on_admit(self.rank, p.ticket, r)

    @property
    def pending(self) -> int:
        """Tickets staged or awaiting acks — a host is migration-idle
        only when this is zero."""
        return len(self._outbox) + len(self._pending)

    # -- the verified collective path ----------------------------------

    def round(self, *, done: bool = False) -> bool:
        """One four-phase migration round over the REAL multi-host
        collective seam; every live host must call it together.
        Returns True once every host passed ``done=True`` with an
        empty outbox — the joint termination decision, so no host
        leaves the loop while a peer still has tickets in flight.

        Every collective below is unconditional, and the adopt arm's
        quarantine handler contains no collective and no early exit —
        the properties JAX's protocol verifier proves of its twin (not
        ported yet: ROADMAP.md Queue 1).  With a ``watchdog``
        attached, each phase runs under a NAMED scoped deadline
        (:meth:`_wd`): a peer SIGKILLed mid-offer leaves the survivors
        blocked in the transfer gather forever, and the hang report
        must name that phase instead of a generic timeout."""
        blob = self.outbox_blob()
        with self._wd("migrate_offer"), \
                self.engine.obs.span("migrate_offer_phase", seq=self.seq):
            sizes = gather_host_values(len(blob))
            dones = gather_host_values(
                1 if (done and not self.pending) else 0)
        with self._wd("transfer"), \
                self.engine.obs.span("migrate_transfer", seq=self.seq,
                                     nbytes=len(blob)):
            blobs = gather_host_blobs(blob)
        ack_entries: list = []
        with self._wd("adopt"):
            for src, b in enumerate(blobs):
                if src == self.rank or not b:
                    continue
                try:
                    ack_entries.extend(self.admit_blob(src, b))
                except TransferCorrupt as exc:
                    # Quarantine WITHOUT leaving the round: the ack
                    # gather below is a rendezvous every peer is
                    # already committed to — an early exit here would
                    # strand the sender in phase 3 forever.
                    self._quarantine(src, b, exc)
        with self._wd("release"):
            acks = gather_host_blobs(
                _pack_acks(self.rank, ack_entries, self.seq))
            merged: list = []
            for b in acks:
                merged.extend(_unpack_acks(b))
            self.release_acks(merged)
            sealed = all_hosts_ok(True, value=self.seq)
        self.seq += 1
        del sizes, sealed
        return min(dones) == 1


# -- in-process cluster simulation ------------------------------------


class ClusterRequest:
    """Cluster-level handle that FOLLOWS a request across hosts: the
    engine-level :class:`~tpudp_torch.serve.engine.Request` it points at is
    swapped on every migration/failover (rebinding is the cluster's
    job — engine handles are host-local by design).  ``snap`` is the
    failover journal entry: (tokens, generator state, accounting) as of the
    last completed cluster tick, refreshed by the cluster and used to
    rebuild the request when its host dies without a goodbye."""

    def __init__(self, cluster, handle, host: int):
        self.cluster = cluster
        self.handle = handle
        self.host = host
        self.prompt = np.asarray(handle.prompt, np.int32)
        self.snap = ([], None, 0, 0, 0, 0)
        self.failovers = 0
        self.cancel_pending = False

    def cancel(self) -> bool:
        """Cancel wherever the request currently lives.  The
        migrate-vs-cancel race resolves deterministically in favour of
        the cancel: if the ticket is mid-flight (exported but not yet
        admitted — the engine-level cancel finds nothing local), the
        cancel is recorded and applied the moment a receiver admits
        the ticket, so the request finishes ``CANCELLED`` either way.
        Returns False only when the request already finished."""
        if self.done:
            return False
        h = self.cluster.hosts[self.host]
        if h.alive and h.engine.cancel(self.handle):
            return True
        self.cancel_pending = True
        return True

    @property
    def tokens(self) -> list:
        return list(self.handle.tokens)

    @property
    def done(self) -> bool:
        return self.handle.done

    @property
    def ok(self) -> bool:
        return self.handle.ok

    @property
    def finish_reason(self):
        return self.handle.finish_reason

    @property
    def migrations(self) -> int:
        return self.handle.migrations

    def result(self) -> np.ndarray:
        """Drive the cluster until this request finishes; return the
        full prompt+completion sequence (raises like
        :meth:`Request.result` on a non-success finish)."""
        while not self.handle.done:
            self.cluster.tick()
        if not self.handle.ok:
            from tpudp_torch.serve.engine import RequestFailed

            raise RequestFailed(self.handle)
        return np.concatenate(
            [self.prompt, np.asarray(self.handle.tokens, np.int32)])


class DisaggCluster:
    """One prefill engine + N decode engines wired into a
    disaggregated arena, in ONE process.  Every transfer goes through
    the REAL pack/crc/admit/ack state machine of :class:`DisaggHost`
    (the hosts are driven phase-locked with direct blob delivery in
    place of the collective gathers), so quarantine, retry/backoff,
    :class:`MigrationFailed` fallback and the accounting are the same
    code the two-process path runs — which is what lets tier-1
    exercise SIGKILL failover and wire faults deterministically.

    Policy: requests submit to the prefill host; once a request has
    emitted its first token (prefill done, generator advanced once) it is
    handed off to the decode host with the most free slots.
    :meth:`kill_host` abandons a decode engine mid-stream (no drain,
    no goodbye) and redistributes its journaled requests across the
    survivors — the continuation is bit-exact because the journal
    carries exactly the vacate/resume state (tokens + generator state).
    :meth:`rebalance` drains pressure-hot decode hosts by migrating
    their most-recently-admitted slots."""

    def __init__(self, engines, *, prefill: int = 0, retries: int = 2,
                 backoff_s: float = 0.0, faults=(), watchdog=None):
        if len(engines) < 2:
            raise ValueError("a disaggregated arena needs >= 2 engines "
                             "(one prefill + at least one decode host)")
        self.prefill = int(prefill)
        self._kill_faults = tuple(f for f in faults
                                  if hasattr(f, "should_kill"))
        wire = tuple(f for f in faults if hasattr(f, "on_send"))
        self.hosts = [
            DisaggHost(eng, rank=i, n_hosts=len(engines),
                       role=("prefill" if i == self.prefill
                             else "decode"),
                       faults=wire, retries=retries,
                       backoff_s=backoff_s,
                       on_admit=self._make_rebind(i),
                       watchdog=watchdog)
            for i, eng in enumerate(engines)]
        self.requests: list[ClusterRequest] = []
        self._by_key: dict[tuple[int, int], ClusterRequest] = {}
        self.dead: set[int] = set()
        self.quarantined: set[int] = set()
        self.events: list[dict] = []
        self.ticks = 0

    def _make_rebind(self, host_rank: int):
        def rebind(src, ticket, request):
            creq = self._by_key.pop((src, ticket.rid), None)
            if creq is not None:
                creq.handle = request
                creq.host = host_rank
                if creq.cancel_pending:
                    # the migrate-vs-cancel race: cancel landed while
                    # the ticket was in flight — apply it now, on the
                    # engine that just admitted the request
                    self.hosts[host_rank].engine.cancel(request)
        return rebind

    # -- submission / policy -------------------------------------------

    def submit(self, prompt, max_new_tokens: int, **kw) -> ClusterRequest:
        """Queue one request on the prefill host; returns the
        cluster-level handle that follows it across hosts."""
        h = self.hosts[self.prefill]
        r = h.engine.submit(prompt, max_new_tokens, **kw)
        creq = ClusterRequest(self, r, self.prefill)
        self.requests.append(creq)
        return creq

    def decode_ranks(self) -> list[int]:
        """Decode hosts eligible for NEW placement: alive and not
        canary-quarantined (a quarantined engine still joins rounds —
        its step is a no-op — but nothing new lands on it)."""
        return [h.rank for h in self.hosts
                if h.alive and h.rank != self.prefill
                and not getattr(h.engine, "quarantined", False)]

    def live_hosts(self) -> list[DisaggHost]:
        return [h for h in self.hosts if h.alive]

    def _free_slots(self, rank: int) -> int:
        eng = self.hosts[rank].engine
        return eng.num_slots - eng.slots_in_use - eng.queue_depth

    def _journal(self) -> None:
        """Refresh every live request's failover journal entry: tokens
        + the slot's generator state as of the step that just ran
        (between steps it is the state as of the last committed token —
        exactly the vacate/resume carry, read without vacating)."""
        for creq in self.requests:
            if creq.done or not self.hosts[creq.host].alive:
                continue
            r = creq.handle
            eng = self.hosts[creq.host].engine
            if r._slot is not None and eng._slots[r._slot] is r:
                key = eng._gens[r._slot].get_state().numpy().copy()
            else:
                key = (None if r._resume_key is None
                       else r._resume_key.numpy().copy())
            creq.snap = (list(r.tokens), key, r.migrations,
                         r.preemptions, r.draft_proposed,
                         r.draft_accepted)

    def _handoff(self) -> None:
        """Stage every prefill-host request that has emitted its first
        token (prefill complete, TTFT already measured where the
        prompt landed) to the decode host with the most free slots."""
        h = self.hosts[self.prefill]
        if not h.alive:
            return
        for r in list(h.engine._slots):
            if (r is None or r.done or not r.tokens
                    or r._nfill != r._fill.size):
                continue
            ranks = self.decode_ranks()
            if not ranks:
                return
            dest = max(ranks, key=lambda k: (self._free_slots(k), -k))
            creq = self._creq_of(r)
            if creq is None:
                continue
            t = h.stage(dest, r)
            self._by_key[(h.rank, t.rid)] = creq
            self.events.append({"kind": "handoff", "rid": t.rid,
                                "from": h.rank, "to": dest,
                                "tick": self.ticks})

    def _creq_of(self, handle) -> ClusterRequest | None:
        for creq in self.requests:
            if creq.handle is handle:
                return creq
        return None

    # -- the phase-locked round ----------------------------------------

    def _round(self) -> None:
        """One migration round across every live host — the same four
        phases as :meth:`DisaggHost.round`, with direct blob delivery
        standing in for the collective gathers (and the
        sender-SIGKILL-mid-offer fault applied between offer and
        transfer, the torn-transfer case receivers must quarantine)."""
        live = self.live_hosts()
        blobs = {h.rank: h.outbox_blob() for h in live}
        for h in list(live):
            if any(f.should_kill(h.rank, h.seq)
                   for f in self._kill_faults):
                if blobs.get(h.rank):
                    # died mid-send: peers receive a truncated blob
                    blobs[h.rank] = blobs[h.rank][: len(blobs[h.rank])
                                                  // 2]
                self.kill_host(h.rank)
        live = self.live_hosts()
        acks: list = []
        for h in live:
            for src, b in blobs.items():
                if src == h.rank or not b:
                    continue
                try:
                    acks.extend(h.admit_blob(src, b))
                except TransferCorrupt as exc:
                    h._quarantine(src, b, exc)
        for h in live:
            h.release_acks(acks)
            h.seq += 1

    def tick(self) -> None:
        """One cluster iteration: step every live engine, evacuate any
        engine whose canary just condemned it, refresh the failover
        journal, hand off prefill-complete requests, run one migration
        round."""
        for h in self.live_hosts():
            h.engine.step()
        self.ticks += 1
        for h in self.live_hosts():
            if (getattr(h.engine, "quarantined", False)
                    and h.rank not in self.quarantined):
                self.evacuate(h.rank)
        self._journal()
        self._handoff()
        self._round()

    def run_until_complete(self, max_ticks: int = 100_000) -> None:
        """Drive the cluster until every tracked request finishes.
        ``max_ticks`` is the wedge guard: the soak harness's contract
        is that no fault may stall completion, so exceeding it raises
        instead of spinning."""
        while any(not c.done for c in self.requests):
            if self.ticks >= max_ticks:
                stuck = [c.handle.id for c in self.requests
                         if not c.done]
                raise RuntimeError(
                    f"cluster wedged: requests {stuck} unfinished "
                    f"after {self.ticks} ticks")
            self.tick()

    # -- failover ------------------------------------------------------

    def kill_host(self, rank: int) -> list[ClusterRequest]:
        """SIGKILL a decode host mid-stream: the engine is ABANDONED
        (no drain, no page release — its pool simply ceases to exist)
        and the survivors vote to redistribute its journaled requests.
        The vote rides the same ``all_hosts_ok``/``gather_host_values``
        machinery as the pod path (identity collectives in-process);
        assignment is deterministic rank-ordered round-robin, so every
        survivor derives the same placement.  Rebuilt tickets carry no
        pages (the dead pool is gone) — receivers re-prefill, which is
        deterministic, so the continuation stays bit-exact."""
        if rank == self.prefill:
            raise ValueError(
                "killing the prefill host is not a failover scenario "
                "this arena recovers from (no journaled prompts would "
                "survive); kill a decode host")
        h = self.hosts[rank]
        if not h.alive:
            return []
        h.alive = False
        self.dead.add(rank)
        survivors = self.decode_ranks() or [self.prefill]
        agreed = all_hosts_ok(True, value=rank)
        views = gather_host_values(len(survivors))
        if not agreed or min(views) != max(views):
            raise RuntimeError(
                f"failover vote diverged for host {rank}")
        orphans = [c for c in self.requests
                   if c.host == rank and not c.done]
        moved = []
        for i, creq in enumerate(
                sorted(orphans, key=lambda c: c.handle.id)):
            dest = survivors[i % len(survivors)]
            tokens, key, migs, preempts, dp, da = creq.snap
            ticket = MigrationTicket(
                rid=creq.handle.id, model=creq.handle._ms.name,
                prompt=creq.prompt, tokens=tuple(tokens),
                max_new_tokens=creq.handle.max_new_tokens,
                temperature=creq.handle.temperature,
                top_k=creq.handle.top_k, top_p=creq.handle.top_p,
                seed=creq.handle.seed, eos_id=creq.handle.eos_id,
                deadline_s=None, tenant=creq.handle.tenant,
                migrations=migs + 1, preemptions=preempts,
                draft_proposed=dp, draft_accepted=da,
                resume_key=key, page_tokens=0, pages=())
            eng = self.hosts[dest].engine
            r2 = eng.admit_ticket(ticket)
            eng.obs.event("failover", rid=ticket.rid,
                          from_host=rank, to_host=dest,
                          tokens=len(tokens))
            eng.stats["failover_resumes"] += 1
            creq.handle = r2
            creq.host = dest
            creq.failovers += 1
            if creq.cancel_pending:
                eng.cancel(r2)
            moved.append(creq)
            self.events.append({"kind": "failover",
                                "rid": ticket.rid, "from": rank,
                                "to": dest, "tick": self.ticks})
        return moved

    def evacuate(self, rank: int) -> list[ClusterRequest]:
        """Migrate every live request OFF a canary-quarantined engine
        (:meth:`tick` calls this the tick the engine condemns itself;
        also callable directly).  Unlike :meth:`kill_host` the host
        process is still running — but its chips are SUSPECT, so
        nothing it could export is trusted: tickets are rebuilt from
        the cluster's own failover-journal snapshot of each stream
        (committed tokens + the slot's generator state as of the last
        clean tick — the journal refreshes AFTER the evacuation check,
        so the snapshot predates the condemning step) with NO pages,
        and receivers re-prefill — which is deterministic, so the
        continuation is bit-exact for greedy and sampled requests
        alike (the generator state is the sampler's whole state).  The
        quarantined engine keeps its wreckage: it stopped
        emitting the moment the canary mismatched, and it stays out of
        :meth:`decode_ranks` so nothing new lands on it."""
        h = self.hosts[rank]
        if rank in self.quarantined or not h.alive:
            return []
        self.quarantined.add(rank)
        survivors = [k for k in self.decode_ranks() if k != rank]
        if not survivors and rank != self.prefill:
            survivors = [self.prefill]
        if not survivors:
            raise RuntimeError(
                f"no healthy host left to evacuate host {rank} to")
        orphans = [c for c in self.requests
                   if c.host == rank and not c.done]
        moved = []
        for i, creq in enumerate(
                sorted(orphans, key=lambda c: c.handle.id)):
            r = creq.handle
            tokens, key, migs, preempts, dp, da = creq.snap
            dest = survivors[i % len(survivors)]
            ticket = MigrationTicket(
                rid=r.id, model=r._ms.name, prompt=creq.prompt,
                tokens=tuple(int(t) for t in tokens),
                max_new_tokens=r.max_new_tokens,
                temperature=r.temperature, top_k=r.top_k,
                top_p=r.top_p, seed=r.seed, eos_id=r.eos_id,
                deadline_s=None, tenant=r.tenant,
                migrations=migs + 1, preemptions=preempts,
                draft_proposed=dp, draft_accepted=da,
                resume_key=key, page_tokens=0, pages=())
            deng = self.hosts[dest].engine
            r2 = deng.admit_ticket(ticket)
            deng.obs.event("evacuate", rid=ticket.rid, from_host=rank,
                           to_host=dest, tokens=len(ticket.tokens))
            deng.stats["evacuation_resumes"] += 1
            creq.handle = r2
            creq.host = dest
            if creq.cancel_pending:
                deng.cancel(r2)
            moved.append(creq)
            self.events.append({"kind": "evacuate", "rid": ticket.rid,
                                "from": rank, "to": dest,
                                "tick": self.ticks})
        return moved

    # -- explicit migration / rebalancing ------------------------------

    def _migrate_once(self, creq: ClusterRequest,
                      dest: int) -> MigrationFailed | None:
        """Run one migration to completion and REPORT the outcome
        instead of raising it.  The branch-free result lets
        :meth:`rebalance` record a failed move without an
        exception-guarded arm around the collective-bearing rounds —
        by the time this returns, the request is live somewhere
        (``dest`` on success, back on its source host via the local
        fallback on failure) and every round's rendezvous has
        completed."""
        src = self.hosts[creq.host]
        if not self.hosts[dest].alive:
            raise ValueError(f"host {dest} is dead")
        if dest == creq.host:
            raise ValueError(
                f"request {creq.handle.id} already lives on host "
                f"{dest}")
        before = len(src.failures)
        t = src.stage(dest, creq.handle)
        self._by_key[(src.rank, t.rid)] = creq
        self.events.append({"kind": "migrate", "rid": t.rid,
                            "from": src.rank, "to": dest,
                            "tick": self.ticks})
        for _ in range(src.retries + 2):
            if not src.pending:
                break
            self._round()
        if len(src.failures) > before:
            return src.failures[-1]
        return None

    def migrate(self, creq: ClusterRequest, dest: int) -> None:
        """Explicitly migrate one live request to host ``dest`` (the
        rebalance primitive and the edge-race test surface).  Runs
        migration rounds until the ticket resolves.  Raises
        :class:`MigrationFailed` only AFTER the request is safely
        re-admitted on its current host (the local fallback) — the
        caller learns the link is bad; the request never stops."""
        err = self._migrate_once(creq, dest)
        if err is not None:
            raise err

    def rebalance(self, *, free_page_frac: float = 0.25,
                  max_moves: int = 2) -> list[dict]:
        """Drain pressure-hot decode hosts: any live decode host whose
        page pool's free fraction sits below ``free_page_frac``
        migrates its most-recently-admitted slots (the least sunk
        cost — the same victim rule as local pressure-vacate) to the
        decode host with the most free pages.  A failed move is
        absorbed by :class:`MigrationFailed`'s local fallback — the
        hot host stays hot but correct, and the caller sees the move
        recorded as failed."""
        moves = []
        for rank in self.decode_ranks():
            eng = self.hosts[rank].engine
            pools = eng.metrics().get("page_pools", [])
            if not pools:
                continue
            free = min(p["free_pages"] / max(1, p["num_pages"])
                       for p in pools)
            if free >= free_page_frac:
                continue
            others = [k for k in self.decode_ranks() if k != rank]
            if not others:
                continue
            dest = max(others, key=lambda k: (sum(
                p["free_pages"] for p in
                self.hosts[k].engine.metrics().get("page_pools", [])),
                -k))
            victims = sorted(
                (r for r in eng._slots if r is not None and not r.done),
                key=lambda r: -r._order)[:max_moves]
            for r in victims:
                creq = self._creq_of(r)
                if creq is None:
                    continue
                rec = {"kind": "rebalance", "rid": r.id, "from": rank,
                       "to": dest, "tick": self.ticks, "ok": True}
                err = self._migrate_once(creq, dest)
                if err is not None:
                    rec["ok"] = False
                    rec["why"] = str(err)
                moves.append(rec)
                self.events.append(rec)
        return moves

    # -- oracles -------------------------------------------------------

    def check(self) -> None:
        """``check_paged()`` on every SURVIVING host — the no-leak
        oracle the soak harness runs after every storm (dead hosts are
        abandoned wholesale; their pools are not leaks, they are
        wreckage)."""
        for h in self.live_hosts():
            h.engine.check_paged()

    def stats(self) -> dict:
        return {h.rank: dict(h.engine.stats) for h in self.hosts}

