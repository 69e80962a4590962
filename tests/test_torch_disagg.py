"""Disaggregated serving in the port (``tpudp_torch.serve.disagg``, the
engine's ``export_ticket``/``admit_ticket``, ``PagePool.read_page``/
``write_page``, the transfer faults and the host collectives) against
the JAX package, case for case with tests/test_disagg.py:

  * the wire format is JAX's byte for byte, each package unpacks the
    other's blob, torn and corrupt blobs are refused;
  * a migrated request's greedy tokens equal JAX's unmigrated engine's
    (greedy, so JAX ``generate()``'s) — mid-stream, queued, across a
    fused window, speculating, twice, with shared prefix pages, over an
    int8 pool — and a sampled one continues the port's own unmigrated
    run;
  * the cluster: handoff, failover, every transfer fault, rebalance,
    the typed failure with local fallback, the canary evacuation, with
    ``check()`` clean after each; the watchdog-armed round phases; and
    ``DisaggHost.round`` over a gloo world of 2.

JAX's protocol-verifier and migration model-checker tests run against
``tpudp_torch/serve/disagg.py`` in ``tests/test_torch_protocol.py``.  On
the CPU the engines run the kernels' plain versions.  Tiny geometries, one intra-op
thread.
"""

import contextlib
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.llama import llama_small as jax_llama_small
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.serve import Engine as JaxEngine
from tpudp.serve import disagg as jdg
from tpudp_torch.models import gpt2, llama
from tpudp_torch.serve import (DisaggCluster, Engine, FinishReason,
                               MigrationFailed, NgramDrafter, TenantClass,
                               TransferCorrupt)
from tpudp_torch.serve import disagg as dg
from tpudp_torch.serve.disagg import (DisaggHost, MigrationTicket,
                                      corrupt_page_bytes, pack_batch,
                                      unpack_batch)
from tpudp_torch.serve.faults import (BitFlipLogits, CorruptPagePayload,
                                      DroppedTransfer, SenderKilledMidOffer,
                                      SlowLink)
from tpudp_torch.utils import checkpoint as ck

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dp_worker as w  # noqa: E402

TINY = w.DISAGG_CFG
LLAMA_GQA = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=4,
                 num_kv_heads=2, d_model=32)
SEED = w.DISAGG_MODEL_SEED


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return gpt2.build(gpt2.GPT2Config(**TINY), SEED, "cpu")


class _JaxReference:
    """JAX's unmigrated greedy tokens, from one JAX engine (its programs
    compile once for every prompt length; greedy, it is ``generate()``)."""

    def __init__(self):
        tree = gpt2.random_params(gpt2.GPT2Config(**TINY), seed=SEED)
        self.engine = JaxEngine(jax_gpt2_small(**TINY),
                                jax.tree_util.tree_map(jnp.asarray, tree),
                                num_slots=4, max_len=64, prefill_chunk=8,
                                kv_pages=32)
        self.cache = {}

    def __call__(self, prompt, n) -> list:
        key = (tuple(int(t) for t in prompt), n)
        if key not in self.cache:
            h = self.engine.submit(np.asarray(prompt, np.int32), n)
            self.engine.run_until_complete()
            self.cache[key] = list(h.tokens)
        return self.cache[key]


@pytest.fixture(scope="module")
def reference():
    return _JaxReference()


def _assert_parity(reference, prompt, n, handle):
    assert list(handle.tokens) == reference(prompt, n)


def _paged(model, **kw):
    base = dict(num_slots=2, max_len=64, prefill_chunk=8, kv_pages=16)
    base.update(kw)
    return Engine(model, device="cpu", **base)


# -- the wire format ---------------------------------------------------------

def _ticket(pkg, rid=7, pages=(), resume=True, resume_dtype=np.uint32):
    rng = np.random.default_rng(rid)
    return pkg.MigrationTicket(
        rid=rid, model=None,
        prompt=rng.integers(0, 61, size=11).astype(np.int32),
        tokens=(3, 1, 4), max_new_tokens=8, temperature=0.8, top_k=5,
        top_p=0.9, seed=42, eos_id=None, deadline_s=None, tenant=None,
        migrations=1, preemptions=2, draft_proposed=3, draft_accepted=1,
        resume_key=(rng.integers(0, 255, size=16).astype(resume_dtype)
                    if resume else None),
        page_tokens=8, pages=tuple(pages))


_FP_PAGE = {"k": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
            "v": np.ones((2, 3, 4), np.float32) * 0.5}
_INT8_PAGE = {"k": np.arange(24, dtype=np.int8).reshape(2, 3, 4),
              "v": -np.ones((2, 3, 4), np.int8),
              "k_scale": np.full((2, 3), 0.25, np.float32),
              "v_scale": np.linspace(0, 1, 6, dtype=np.float32).reshape(2,
                                                                        3)}
WIRE_CASES = {
    "pages": lambda pkg: [(2, _ticket(pkg, pages=[_FP_PAGE, _FP_PAGE]))],
    "pageless-keyless": lambda pkg: [(0, _ticket(pkg, rid=9,
                                                 resume=False))],
    "generator-state": lambda pkg: [(1, _ticket(pkg, rid=3,
                                                resume_dtype=np.uint8))],
    "int8-batch": lambda pkg: [(1, _ticket(pkg, rid=4, pages=[_INT8_PAGE])),
                               (2, _ticket(pkg, rid=5))],
    "empty": lambda pkg: [],
}


@pytest.mark.parametrize("case", list(WIRE_CASES))
def test_pack_batch_byte_equal_to_jax(case):
    """The same tickets pack to the same bytes in both packages, and each
    unpacks the other's blob to the same fields."""
    mine = pack_batch(WIRE_CASES[case](dg), seq=5, src=1)
    theirs = jdg.pack_batch(WIRE_CASES[case](jdg), seq=5, src=1)
    assert mine == theirs
    for blob, unpack in ((theirs, unpack_batch), (mine, jdg.unpack_batch)):
        seq, src, out = unpack(blob)
        assert (seq, src) == (5, 1)
        for (dest, t), (wdest, want) in zip(out, WIRE_CASES[case](dg)):
            assert dest == wdest and t.rid == want.rid
            assert t.tokens == want.tokens
            np.testing.assert_array_equal(t.prompt, want.prompt)
            if want.resume_key is None:
                assert t.resume_key is None
            else:
                np.testing.assert_array_equal(t.resume_key, want.resume_key)
                assert t.resume_key.dtype == want.resume_key.dtype
            assert len(t.pages) == len(want.pages)
            for got_page, want_page in zip(t.pages, want.pages):
                assert set(got_page) == set(want_page)
                for name in want_page:
                    np.testing.assert_array_equal(got_page[name],
                                                  want_page[name])
                    assert got_page[name].dtype == want_page[name].dtype


def test_pack_unpack_roundtrip_bit_exact():
    t = _ticket(dg, pages=[_FP_PAGE, _FP_PAGE])
    seq, src, [(dest, t2)] = unpack_batch(pack_batch([(2, t)], seq=5,
                                                     src=1))
    assert (seq, src, dest) == (5, 1, 2) and t2.rid == t.rid
    np.testing.assert_array_equal(t2.prompt, t.prompt)
    np.testing.assert_array_equal(t2.resume_key, t.resume_key)
    assert t2.tokens == t.tokens
    assert (t2.migrations, t2.preemptions) == (1, 2)
    assert (t2.draft_proposed, t2.draft_accepted) == (3, 1)
    for name in ("k", "v"):
        np.testing.assert_array_equal(t2.pages[0][name], _FP_PAGE[name])
    _, _, [(_, t3)] = unpack_batch(pack_batch(
        [(0, _ticket(dg, rid=9, resume=False))], seq=0, src=2))
    assert t3.resume_key is None and t3.pages == ()


def test_unpack_rejects_torn_and_corrupt():
    blob = pack_batch([(1, _ticket(dg))], seq=0, src=0)
    for bad in (blob[: len(blob) // 2], b"XXXX" + blob[4:],
                blob[:4] + (99).to_bytes(2, "big") + blob[6:],
                blob[:-1] + bytes([blob[-1] ^ 0xFF]), b""):
        with pytest.raises(TransferCorrupt):
            unpack_batch(bad)


def test_corrupt_page_bytes_passes_framing_fails_page_crc():
    page = {"k": np.zeros((2, 2), np.float32)}
    blob = pack_batch([(1, _ticket(dg, pages=[page]))], seq=0, src=0)
    evil = corrupt_page_bytes(blob)
    assert evil == jdg.corrupt_page_bytes(blob)
    with pytest.raises(TransferCorrupt, match="payload crc"):
        unpack_batch(evil)
    with pytest.raises(ValueError, match="no payload"):
        corrupt_page_bytes(pack_batch([], seq=0, src=0))


def test_host_collectives_are_the_identity_at_one_rank(monkeypatch):
    """One process: no collective is dispatched."""
    import torch.distributed as dist

    def boom(*a, **k):
        raise AssertionError("a collective was dispatched")

    monkeypatch.setattr(dist, "all_gather", boom)
    assert ck.gather_host_blobs(b"abc") == [b"abc"]
    assert ck.gather_host_values(7) == [7]
    assert ck.all_hosts_ok(True, value=3) is True
    assert ck.all_hosts_ok(False) is False


def test_page_payload_read_write(model):
    """A page's slice of every pool buffer (int8 scales included) under
    JAX's field names; writing needs an exclusive page and every field."""
    for kv_dtype, fields in ((None, ["k", "v"]),
                             ("int8", ["k", "v", "k_scale", "v_scale"])):
        eng = _paged(model, kv_dtype=kv_dtype)
        pool = eng.page_pool
        eng.generate_many([np.arange(1, 18, dtype=np.int32)], 2)
        page = next(iter(pool._rc))
        payload = pool.read_page(page)
        assert list(payload) == fields
        fresh = pool.alloc()
        pool.write_page(fresh, payload)
        for name, buf in zip(pool.pages._fields, pool.pages):
            assert torch.equal(buf[:, fresh], buf[:, page])
        pool.share(fresh)
        with pytest.raises(ValueError, match="exclusive"):
            pool.write_page(fresh, payload)
        pool.release(fresh)
        if kv_dtype:
            with pytest.raises(ValueError, match="k_scale"):
                pool.write_page(fresh, {k: payload[k] for k in ("k", "v")})
        with pytest.raises(ValueError, match="unallocated"):
            pool.read_page(pool._free[0])
        pool.release(fresh)
        eng.check_paged()


# -- engine-level export/admit -------------------------------------------------

def test_export_admit_midstream_parity_and_accounting(model, reference):
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, 61, size=19).astype(np.int32)
    a, b = _paged(model), _paged(model)
    h = a.submit(prompt, 8)
    for _ in range(4):
        a.step()
    assert h.tokens and not h.done
    ticket = a.export_ticket(h)
    assert ticket.pages and ticket.resume_key.dtype == np.uint8
    assert h.finish_reason is None
    h2 = b.admit_ticket(ticket)
    b.run_until_complete()
    _assert_parity(reference, prompt, 8, h2)
    assert h2.migrations == 1 and h2.preemptions == 0
    assert a.stats["migrated_out"] == 1 and "migrated_in" not in a.stats
    assert b.stats["migrated_in"] == 1
    assert b.stats["migrated_in_pages"] == len(ticket.pages)
    assert b.stats["prefix_hit_tokens"] == 8 * len(ticket.pages)
    a.run_until_complete()
    a.check_paged()
    b.check_paged()
    names = [r["name"] for r in a.obs.snapshot()]
    assert "migrate_out" in names
    assert "migrate_in" in [r["name"] for r in b.obs.snapshot()]


def test_export_admit_sampled_parity(model):
    rng = np.random.default_rng(22)
    prompt = rng.integers(0, 61, size=13).astype(np.int32)
    kw = dict(temperature=0.8, top_k=7, seed=123)
    ref = _paged(model)
    hr = ref.submit(prompt, 8, **kw)
    ref.run_until_complete()
    a, b = _paged(model), _paged(model)
    h = a.submit(prompt, 8, **kw)
    for _ in range(4):
        a.step()
    h2 = b.admit_ticket(a.export_ticket(h))
    b.run_until_complete()
    assert h2.tokens == hr.tokens
    a.check_paged()
    b.check_paged()


def test_export_queued_request_is_tokens_only(model, reference):
    rng = np.random.default_rng(23)
    prompt = rng.integers(0, 61, size=9).astype(np.int32)
    a, b = _paged(model, num_slots=1), _paged(model)
    a.submit(rng.integers(0, 61, size=9).astype(np.int32), 4)
    h = a.submit(prompt, 6)
    ticket = a.export_ticket(h)
    assert ticket.pages == () and ticket.resume_key is None
    assert ticket.tokens == ()
    h2 = b.admit_ticket(ticket)
    b.run_until_complete()
    _assert_parity(reference, prompt, 6, h2)
    a.run_until_complete()
    a.check_paged()
    b.check_paged()


def test_export_finished_and_geometry_mismatch_raise(model):
    rng = np.random.default_rng(24)
    prompt = rng.integers(0, 61, size=9).astype(np.int32)
    a = _paged(model)
    h = a.submit(prompt, 4)
    a.run_until_complete()
    with pytest.raises(ValueError, match="already finished"):
        a.export_ticket(h)
    h2 = a.submit(prompt, 6)
    a.step()
    ticket = a.export_ticket(h2)
    c = _paged(model, prefill_chunk=4, max_len=48, kv_pages=12)
    with pytest.raises(ValueError, match="prefill_chunk"):
        c.admit_ticket(ticket)
    small = _paged(model, max_len=12, kv_pages=4)
    with pytest.raises(ValueError, match="max_len"):
        small.admit_ticket(ticket)
    tenanted = _paged(model, tenants={"default": TenantClass()})
    with pytest.raises(ValueError, match="model"):
        tenanted.admit_ticket(MigrationTicket(**{**ticket.__dict__,
                                                 "model": "other"}))
    with pytest.raises(ValueError, match="tenant"):
        _paged(model).admit_ticket(MigrationTicket(**{**ticket.__dict__,
                                                      "tenant": "gold"}))
    a.check_paged()


def test_finish_reason_never_grows_migrated(model):
    assert {m.value for m in FinishReason} == {
        "complete", "eos", "cancelled", "deadline", "error", "shed"}
    rng = np.random.default_rng(25)
    a, b = _paged(model), _paged(model)
    h = a.submit(rng.integers(0, 61, size=9).astype(np.int32), 6)
    a.step()
    t = a.export_ticket(h)
    assert h.finish_reason is None and not h.done
    h2 = b.admit_ticket(t)
    b.run_until_complete()
    assert h2.finish_reason is FinishReason.COMPLETE


def test_migration_distinct_from_pressure_and_preemption(model):
    rng = np.random.default_rng(26)
    prompts = [rng.integers(0, 61, size=9 + 3 * i).astype(np.int32)
               for i in range(5)]
    eng = Engine(model, device="cpu", num_slots=3, max_len=48,
                 prefill_chunk=8, kv_pages=6)
    handles = [eng.submit(p, 6) for p in prompts]
    eng.run_until_complete()
    assert eng.stats["page_pressure_vacates"] > 0
    assert "migrated_out" not in eng.stats
    assert "migrated_in" not in eng.stats
    assert all(h.migrations == 0 for h in handles)
    eng.check_paged()
    tenants = {"default": TenantClass(priority=0)}
    a = _paged(model, tenants=tenants)
    b = _paged(model, tenants=tenants)
    h = a.submit(rng.integers(0, 61, size=11).astype(np.int32), 6)
    a.step()
    h2 = b.admit_ticket(a.export_ticket(h))
    b.run_until_complete()
    assert h2.migrations == 1 and h2.preemptions == 0
    assert a.stats["migrated_out"] == 1
    assert a.stats.get("page_pressure_vacates", 0) == 0
    assert a.stats.get("preempted", 0) == 0
    assert a.tenant_stats["default"]["migrated_out"] == 1
    assert b.tenant_stats["default"]["migrated_in"] == 1
    assert "page_pressure_vacates" not in b.tenant_stats["default"]


def test_migrate_vs_cancel_race(model):
    rng = np.random.default_rng(27)
    a, b = _paged(model), _paged(model)
    h = a.submit(rng.integers(0, 61, size=11).astype(np.int32), 6)
    a.step()
    t = a.export_ticket(h)
    assert a.cancel(h) is False
    assert h.finish_reason is None
    h2 = b.admit_ticket(t)
    assert b.cancel(h2) is True
    assert h2.finish_reason is FinishReason.CANCELLED
    b.run_until_complete()
    a.run_until_complete()
    a.check_paged()
    b.check_paged()
    cl = DisaggCluster([_paged(model) for _ in range(2)], prefill=0)
    creq = cl.submit(rng.integers(0, 61, size=9).astype(np.int32), 16)
    while creq.host == 0 and not creq.done:
        cl.tick()
    assert creq.host == 1 and not creq.done
    t = cl.hosts[1].stage(0, creq.handle)
    cl._by_key[(1, t.rid)] = creq
    assert creq.cancel() is True
    assert creq.cancel_pending
    cl.run_until_complete()
    assert creq.finish_reason is FinishReason.CANCELLED
    assert len(creq.tokens) < 16
    cl.check()


def test_migrate_mid_fused_window_parity(model, reference):
    """The export lands on a window edge (the scheduler yields only
    between committed windows): the carried generator state is the
    post-window one, the continuation exact, and the device counters
    count each committed step once."""
    rng = np.random.default_rng(28)
    prompt = rng.integers(0, 61, size=9).astype(np.int32)
    a = _paged(model, max_len=48, decode_fuse=4, kv_pages=12)
    b = _paged(model, max_len=48, decode_fuse=4, kv_pages=12)
    h = a.submit(prompt, 6)
    for _ in range(2):
        a.step()
    assert a.stats.get("fused_windows", 0) > 0
    h2 = b.admit_ticket(a.export_ticket(h))
    b.run_until_complete()
    _assert_parity(reference, prompt, 6, h2)
    dev = b.metrics()["device_counters"]
    assert dev["slot_steps"] == b.stats["active_slot_steps"]
    a.check_paged()
    b.check_paged()


def test_migrate_speculating_slot_parity(model, reference):
    rng = np.random.default_rng(29)
    prompt = np.tile(rng.integers(0, 61, size=4), 8)[:26].astype(np.int32)

    def mk():
        return _paged(model, speculate_k=2, drafter=NgramDrafter())

    a, b = mk(), mk()
    h = a.submit(prompt, 8)
    for _ in range(4):
        a.step()
    assert h.tokens and not h.done
    t = a.export_ticket(h)
    assert t.draft_proposed >= 0
    h2 = b.admit_ticket(t)
    b.run_until_complete()
    _assert_parity(reference, prompt, 8, h2)
    assert h2.draft_proposed >= t.draft_proposed
    a.check_paged()
    b.check_paged()


def test_double_migration_parity(model, reference):
    rng = np.random.default_rng(30)
    prompt = rng.integers(0, 61, size=17).astype(np.int32)
    a, b, c = (_paged(model) for _ in range(3))
    h = a.submit(prompt, 9)
    for _ in range(4):
        a.step()
    hb = b.admit_ticket(a.export_ticket(h))
    for _ in range(2):
        b.step()
    hc = c.admit_ticket(b.export_ticket(hb))
    c.run_until_complete()
    _assert_parity(reference, prompt, 9, hc)
    assert hc.migrations == 2
    assert (a.stats["migrated_out"], b.stats["migrated_out"]) == (1, 1)
    assert (b.stats["migrated_in"], c.stats["migrated_in"]) == (1, 1)
    for e in (a, b, c):
        e.run_until_complete()
        e.check_paged()


def test_migrate_with_shared_prefix_refs(model, reference):
    rng = np.random.default_rng(31)
    shared = rng.integers(0, 61, size=24).astype(np.int32)
    pa = np.concatenate([shared,
                         rng.integers(0, 61, size=3).astype(np.int32)])
    pb = np.concatenate([shared,
                         rng.integers(0, 61, size=5).astype(np.int32)])
    a = _paged(model, kv_pages=24)
    b = _paged(model, kv_pages=24)
    warm = a.submit(np.concatenate(
        [shared, rng.integers(0, 61, size=1).astype(np.int32)]), 2)
    a.run_until_complete()
    ha = a.submit(pa, 8)
    hb = a.submit(pb, 8)
    for _ in range(4):
        a.step()
    a.check_paged()
    h2 = b.admit_ticket(a.export_ticket(ha))
    a.check_paged()
    a.run_until_complete()
    b.run_until_complete()
    _assert_parity(reference, pa, 8, h2)
    _assert_parity(reference, pb, 8, hb)
    _assert_parity(reference, warm.prompt, 2, warm)
    a.check_paged()
    b.check_paged()


def test_int8_pool_migrates_with_scales():
    """LLaMA-GQA over int8 pools: the ticket carries each page's int8
    payloads and float32 scales, and the migrated request's greedy tokens
    equal JAX's unmigrated int8 engine's."""
    tree = jax.tree_util.tree_map(
        lambda a: a * 5 if a.ndim == 2 else a,
        llama.random_params(llama.LlamaConfig(**LLAMA_GQA), seed=23))
    lmodel = llama.Llama(llama.LlamaConfig(**LLAMA_GQA))
    lmodel.load_state_dict(llama.params_from_jax(tree))
    kw = dict(num_slots=2, max_len=48, prefill_chunk=8, kv_pages=12,
              kv_dtype="int8")
    rng = np.random.default_rng(32)
    prompt = rng.integers(0, 61, size=19).astype(np.int32)
    jeng = JaxEngine(jax_llama_small(**LLAMA_GQA),
                     jax.tree_util.tree_map(jnp.asarray, tree),
                     paged_attn="einsum", **kw)
    want = jeng.submit(prompt, 8)
    jeng.run_until_complete()
    a = Engine(lmodel, device="cpu", **kw)
    b = Engine(lmodel, device="cpu", **kw)
    h = a.submit(prompt, 8)
    for _ in range(4):
        a.step()
    t = a.export_ticket(h)
    assert len(t.pages) == 2
    assert {k: v.dtype for k, v in t.pages[0].items()} == {
        "k": np.int8, "v": np.int8, "k_scale": np.float32,
        "v_scale": np.float32}
    assert t.pages[0]["k"].shape[-2] == 2  # kv_heads wide
    h2 = b.admit_ticket(unpack_batch(pack_batch([(1, t)], seq=0,
                                                src=0))[2][0][1])
    b.run_until_complete()
    assert h2.tokens == want.tokens
    assert b.stats["migrated_in_pages"] == 2
    a.run_until_complete()
    a.check_paged()
    b.check_paged()


# -- the cluster --------------------------------------------------------------

def _colocated(model, jobs):
    eng = _paged(model, num_slots=8, kv_pages=24)
    handles = [eng.submit(p, n, **kw) for p, n, kw in jobs]
    eng.run_until_complete()
    eng.check_paged()
    return [list(h.tokens) for h in handles]


def _cluster_jobs(rng, n=4):
    jobs = []
    for i in range(n):
        kw = {} if i % 2 == 0 else dict(temperature=0.8, top_k=7,
                                        seed=100 + i)
        jobs.append((rng.integers(0, 61, size=9 + 2 * i)
                     .astype(np.int32), 6 + i % 3, kw))
    return jobs


def _cluster(model, n=3, **kw):
    return DisaggCluster([_paged(model, num_slots=4, kv_pages=24)
                          for _ in range(n)], prefill=0, **kw)


def _greedy_parity(reference, jobs, creqs):
    for (p, n, kw), c in zip(jobs, creqs):
        if not kw:
            assert c.tokens == reference(p, n)


def test_cluster_handoff_bit_exact_vs_colocated(model, reference):
    rng = np.random.default_rng(32)
    jobs = _cluster_jobs(rng)
    want = _colocated(model, jobs)
    cl = _cluster(model)
    creqs = [cl.submit(p, n, **kw) for p, n, kw in jobs]
    cl.run_until_complete()
    assert [c.tokens for c in creqs] == want
    _greedy_parity(reference, jobs, creqs)
    handoffs = [e for e in cl.events if e["kind"] == "handoff"]
    assert len(handoffs) == len(jobs)
    assert all(c.host != cl.prefill for c in creqs)
    assert cl.hosts[0].engine.stats["migrated_out"] == len(jobs)
    cl.check()


def test_cluster_failover_kill_decode_host_bit_exact(model, reference):
    rng = np.random.default_rng(33)
    jobs = _cluster_jobs(rng, n=4)
    want = _colocated(model, jobs)
    cl = _cluster(model)
    creqs = [cl.submit(p, n, **kw) for p, n, kw in jobs]
    while not any(c.host == 2 and c.tokens and not c.done for c in creqs):
        cl.tick()
    victims = [c for c in creqs if c.host == 2 and not c.done]
    moved = cl.kill_host(2)
    assert set(moved) == set(victims) and all(
        c.failovers == 1 and c.host != 2 for c in victims)
    cl.run_until_complete()
    assert [c.tokens for c in creqs] == want
    _greedy_parity(reference, jobs, creqs)
    assert sum(h.engine.stats.get("failover_resumes", 0)
               for h in cl.live_hosts()) == len(victims)
    assert len([e for e in cl.events if e["kind"] == "failover"]) == len(
        victims)
    cl.check()


@pytest.mark.parametrize("fault_name", ["dropped", "corrupt", "slow",
                                        "sender_killed"])
def test_cluster_transfer_faults_no_wedge_no_leak(model, reference,
                                                  fault_name, tmp_path):
    rng = np.random.default_rng(34)
    jobs = _cluster_jobs(rng, n=3)
    want = _colocated(model, jobs)
    fault = {
        "dropped": DroppedTransfer(rank=0, at_seqs=range(0, 40)),
        "corrupt": CorruptPagePayload(rank=0, at_seqs=range(0, 3)),
        "slow": SlowLink(delay_s=0.001, rank=0),
        "sender_killed": SenderKilledMidOffer(rank=2, at_seq=2),
    }[fault_name]
    engines = [_paged(model, num_slots=4, kv_pages=24,
                      flight_dir=str(tmp_path / f"h{i}")) for i in range(3)]
    cl = DisaggCluster(engines, prefill=0, retries=1, faults=(fault,))
    creqs = [cl.submit(p, n, **kw) for p, n, kw in jobs]
    cl.run_until_complete(max_ticks=3000)
    assert [c.tokens for c in creqs] == want
    _greedy_parity(reference, jobs, creqs)
    assert fault.fired
    stats = {h.rank: h.engine.stats for h in cl.hosts}
    if fault_name == "dropped":
        assert stats[0]["migration_retries"] > 0
        assert stats[0]["migration_failed"] > 0
        assert cl.hosts[0].failures and isinstance(
            cl.hosts[0].failures[0], MigrationFailed)
    if fault_name == "corrupt":
        assert sum(s.get("quarantined_transfers", 0)
                   for s in stats.values()) > 0
        dumps = [n for i in (1, 2) if os.path.isdir(tmp_path / f"h{i}")
                 for n in os.listdir(tmp_path / f"h{i}")]
        assert any("transfer_quarantined" in n for n in dumps)
    if fault_name == "sender_killed":
        assert cl.dead == {2}
    cl.check()


def test_cluster_rebalance_drains_hot_host(model, reference):
    rng = np.random.default_rng(35)
    jobs = _cluster_jobs(rng, n=4)
    want = _colocated(model, jobs)
    cl = _cluster(model)
    creqs = [cl.submit(p, n, **kw) for p, n, kw in jobs]
    while not any(c.host in (1, 2) and not c.done
                  and c.handle._slot is not None for c in creqs):
        cl.tick()
    moves = cl.rebalance(free_page_frac=1.1, max_moves=1)
    assert moves and all(m["ok"] for m in moves)
    assert {m["kind"] for m in moves} == {"rebalance"}
    assert all(m["from"] != m["to"] and m["from"] != cl.prefill
               for m in moves)
    cl.run_until_complete()
    assert [c.tokens for c in creqs] == want
    _greedy_parity(reference, jobs, creqs)
    assert any(c.migrations >= 2 for c in creqs)
    assert all(e["kind"] != "failover" for e in cl.events)
    cl.check()


def test_cluster_migrate_failure_typed_and_falls_back(model, reference):
    rng = np.random.default_rng(36)
    prompt = rng.integers(0, 61, size=11).astype(np.int32)
    cl = _cluster(model, retries=1, faults=(
        DroppedTransfer(rank=1, at_seqs=range(0, 200)),))
    creq = cl.submit(prompt, 6)
    while creq.host != 1 and not creq.done:
        cl.tick()
    assert creq.host == 1 and not creq.done
    with pytest.raises(MigrationFailed) as ei:
        cl.migrate(creq, 2)
    assert ei.value.dest == 2 and ei.value.attempts >= 2
    assert creq.host == 1
    stats = cl.hosts[1].engine.stats
    assert stats["migration_failed"] >= 1
    assert stats["migrated_in"] == 2 and stats["migrated_out"] == 1
    cl.run_until_complete()
    assert creq.tokens == reference(prompt, 6)
    cl.check()
    with pytest.raises(ValueError, match="already lives"):
        cl.migrate(creq, creq.host)


def test_cluster_guards(model):
    cl = DisaggCluster([_paged(model) for _ in range(2)], prefill=0)
    with pytest.raises(ValueError, match="prefill host"):
        cl.kill_host(0)
    with pytest.raises(ValueError, match=">= 2 engines"):
        DisaggCluster([cl.hosts[0].engine])
    cl.kill_host(1)
    with pytest.raises(ValueError, match="dead"):
        cl.migrate(cl.submit(np.arange(5, dtype=np.int32), 2), 1)


def test_canary_quarantine_evacuates_live_requests_bit_exact(
        model, reference, tmp_path):
    """A canary-only bit flip condemns decode host 1; the cluster
    evacuates its live requests from the journal (no pages) and every
    output, greedy and sampled, equals a clean cluster's, the greedy ones
    JAX's unmigrated run too; the condemned engine leaves placement and
    its flight record lands."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 61, size=4).astype(np.int32)
               for _ in range(4)]

    def mk(canary_hook=None, flight=None):
        kw = dict(device="cpu", num_slots=4, max_len=32, prefill_chunk=8)
        engs = [Engine(model, **kw),
                Engine(model, canary_every_s=0.0, canary_new_tokens=4,
                       token_fault_hook=canary_hook, flight_dir=flight,
                       **kw),
                Engine(model, canary_every_s=0.0, canary_new_tokens=4,
                       **kw)]
        return engs, DisaggCluster(engs)

    def run(cluster):
        hs = [cluster.submit(prompts[0], 10),
              cluster.submit(prompts[1], 10),
              cluster.submit(prompts[2], 10, temperature=0.8, top_k=7,
                             seed=5),
              cluster.submit(prompts[3], 10, temperature=0.8, top_p=0.9,
                             seed=9)]
        cluster.run_until_complete()
        return [h.result() for h in hs]

    _, clean = mk()
    want = run(clean)
    assert not clean.quarantined
    inj = BitFlipLogits([(5, None, 3)], vocab=61, canary_only=True)
    flight = str(tmp_path / "flight")
    engs, cl = mk(canary_hook=inj, flight=flight)
    got = run(cl)
    assert cl.quarantined == {1}
    assert engs[1].quarantined and engs[1].quarantine_reason
    assert inj.fired and inj.fired[0][0] == 5
    evac = [e for e in cl.events if e["kind"] == "evacuate"]
    assert evac and all(e["from"] == 1 for e in evac)
    assert sum(e.stats["evacuation_resumes"] for e in engs) == len(evac)
    for w_, g in zip(want, got):
        np.testing.assert_array_equal(w_, g)
    for p, g in zip(prompts[:2], got[:2]):  # the greedy requests
        assert list(g[len(p):]) == reference(p, 10)
    assert 1 not in cl.decode_ranks()
    assert engs[1].flight.dumps == 1
    assert any("canary_quarantine" in n for n in os.listdir(flight))
    cl.check()


def test_evacuation_trusts_journal_not_suspect_device_memory(model,
                                                              reference):
    """Poison the condemned engine's generators and a committed tail
    token after the last journal refresh: the journal-sourced rebuild
    still finishes every stream equal to a clean cluster's, the greedy
    one JAX's unmigrated run too."""
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 61, size=4).astype(np.int32)
               for _ in range(2)]

    def mk():
        engs = [Engine(model, device="cpu", num_slots=4, max_len=32,
                       prefill_chunk=8) for _ in range(2)]
        return engs, DisaggCluster(engs)

    def submit(cl):
        return [cl.submit(prompts[0], 10),
                cl.submit(prompts[1], 10, temperature=0.8, top_k=7,
                          seed=5)]

    _, clean = mk()
    want = [h.result() for h in submit(clean)]
    engs, cl = mk()
    hs = submit(cl)
    for _ in range(60):
        cl.tick()
        if all(h.host == 1 and len(h.tokens) >= 2 for h in hs):
            break
    assert all(h.host == 1 and not h.done for h in hs)
    assert all(c.snap[0] for c in hs)
    for g in engs[1]._gens:
        g.manual_seed(999)
    for h in hs:
        h.handle.tokens[-1] = (h.handle.tokens[-1] + 1) % 61
    engs[1]._quarantined = True
    engs[1].quarantine_reason = "test: condemned"
    cl.run_until_complete()
    assert cl.quarantined == {1}
    assert [e for e in cl.events if e["kind"] == "evacuate"]
    for w_, h in zip(want, hs):
        np.testing.assert_array_equal(w_, h.result())
    assert hs[0].tokens == reference(prompts[0], 10)


def test_quarantined_engine_excluded_from_placement(model):
    engs = [_paged(model, num_slots=4, kv_pages=24) for _ in range(3)]
    cl = DisaggCluster(engs)
    assert cl.decode_ranks() == [1, 2]
    engs[1]._quarantined = True
    assert cl.decode_ranks() == [2]


# -- watchdog-armed round phases ---------------------------------------------

class _RecordingWatchdog:
    """Records which named regions ``DisaggHost.round`` arms."""

    def __init__(self):
        self.names = []

    def step(self, timeout_s=None, name="step"):
        self.names.append(name)
        return contextlib.nullcontext()


_PHASES = ["disagg.migrate_offer", "disagg.transfer", "disagg.adopt",
           "disagg.release"]


def test_round_arms_watchdog_phases_in_order(model):
    wd = _RecordingWatchdog()
    h = DisaggHost(_paged(model), rank=0, n_hosts=1, watchdog=wd)
    assert h.round(done=True)
    assert wd.names == _PHASES
    assert h.round(done=True)
    assert wd.names == _PHASES * 2
    assert {"migrate_offer_phase", "migrate_transfer"} <= set(
        h.engine.metrics()["spans"])


def test_round_phases_armed_through_torn_transfer(model, monkeypatch):
    sender = DisaggHost(_paged(model, num_slots=4, kv_pages=24), rank=1,
                        n_hosts=2)
    r = sender.engine.submit(np.arange(4, dtype=np.int32), 6)
    while not r.tokens:
        sender.engine.step()
    sender.stage(0, r)
    blob = sender.outbox_blob()
    torn = blob[: len(blob) // 2]
    wd = _RecordingWatchdog()
    h = DisaggHost(_paged(model, num_slots=4, kv_pages=24), rank=0,
                   n_hosts=2, watchdog=wd)
    calls = {"n": 0}

    def fake_blob_gather(b):
        calls["n"] += 1
        if calls["n"] == 1:
            return [bytes(b), torn]
        return [bytes(b), dg._pack_acks(1, [], 0)]

    monkeypatch.setattr(dg, "gather_host_values", lambda v: [int(v)] * 2)
    monkeypatch.setattr(dg, "gather_host_blobs", fake_blob_gather)
    monkeypatch.setattr(dg, "all_hosts_ok", lambda ok, value=0: bool(ok))
    assert h.round(done=True)
    assert wd.names == _PHASES
    assert h.engine.stats["quarantined_transfers"] == 1
    assert h.engine.stats["migrated_in"] == 0
    assert "migrate_quarantine" in [x["name"]
                                    for x in h.engine.obs.snapshot()]
    h.engine.check_paged()


def test_round_hang_raises_named_phase(model, monkeypatch):
    from tpudp_torch.utils.watchdog import StepHangError, Watchdog

    real_gather = dg.gather_host_blobs

    def wedged_gather(b):
        time.sleep(0.3)
        return real_gather(b)

    monkeypatch.setattr(dg, "gather_host_blobs", wedged_gather)
    wd = Watchdog(timeout_s=0.05, kill=False, poll_s=0.01).start()
    try:
        h = DisaggHost(_paged(model), rank=0, n_hosts=1, watchdog=wd)
        with pytest.raises(StepHangError) as ei:
            h.round(done=True)
        assert "disagg.transfer" in str(ei.value)
        assert (wd.last_hang or {}).get("region") == "disagg.transfer"
    finally:
        wd.stop()


# -- two processes -----------------------------------------------------------

def test_two_process_round_quarantine_and_parity(tmp_path, reference):
    """``DisaggHost.round`` over a gloo world of 2: rank 0 prefills and
    stages, rank 1 decodes; rank 0's first transfer is bit-flipped, rank 1
    quarantines it (a flight dump on the receiver, every phase's span
    recorded on both sides) without leaving the round, the retry
    delivers, and the migrated tokens equal JAX's unmigrated engine's.
    The host collectives gather in rank order, padded blobs sliced."""
    r0, r1 = (res["disagg"] for res in w.run_world(tmp_path, 2,
                                                    ["disagg"]))
    for r in (r0, r1):
        assert r["blobs"] == [[], [0, 1, 2]]
        assert r["values"] == [10, 11]
        assert r["ok"] is True and r["split"] is False
    assert len(r1["admitted"]) == 2
    for prompt, n, tokens, ok in r1["admitted"]:
        assert ok and tokens == reference(prompt, n)
    assert [(p.tolist(), n) for p, n in w.disagg_jobs()] == [
        (p, n) for p, n, _, _ in r1["admitted"]]
    assert r1["stats"].get("quarantined_transfers", 0) >= 1
    assert r0["stats"]["migrated_out"] == 2
    assert r0["stats"]["migration_retries"] >= 1
    assert r1["stats"]["migrated_in"] == 2
    assert {"migrate_offer_phase", "migrate_transfer"} <= (
        set(r0["spans"]) & set(r1["spans"]))
    assert "migrate_adopt" in r1["spans"]
    dumps = os.listdir(tmp_path / "flight1")
    assert any("transfer_quarantined" in n for n in dumps)
    assert r1["flight_dumps"] >= 1 and r0["flight_dumps"] == 0
