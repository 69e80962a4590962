"""The fused windows of ``Engine(decode_fuse=N)`` — the port of
``tpudp/serve/engine.py``'s ``_fused_decode_math`` (a ``lax.while_loop``
of up to N decode iterations on the device, fetched once a window) and
``_fused_spec_math`` (the same loop over draft -> verify -> accept
iterations, the draft model on the device).

On the card a window is one CUDA graph of a whole iteration —
embedding, every layer's matmuls, page writes and paged attention (K4 or
K4-int8 through the block table for a decode iteration; the draft
model's prefill and steps, then K5 or K5-int8 for a speculation
iteration's ``k + 1`` verify window), the head, sampling or acceptance
and the carry updates — replayed up to N times with no host sync in
between, then one fetch.  Off the card the same iteration runs eagerly
in a Python loop: that loop is the window's plain version, and the CPU
tests hold it against the JAX engine.

The graph reads and writes static buffers only: the host fills the
inputs with ``copy_`` from pinned host tensors before each window (no
copy from pageable memory happens inside the graph, whose address would
be baked into it), and reads the outputs back as one tensor.  It is
captured once per window object, at its first window: the geometry
(slots, table width, window length) is fixed, K4's and K5's grids are
sized from the table's capacity (``paged_attention.decode_schedule``,
``window_schedule``), not from the depths, and their split scratch is
sized by the warm-up.  The graph also holds the addresses of the KV
store (and of the draft model's cache), so the engine never reallocates
them: its step-failure containment resets them in place.

Early exit.  JAX's loop stops once no row runs.  A graph cannot stop
without a host sync, so the host replays ``min(N, largest budget)``
iterations (each running row commits at least one token an iteration);
a row that has stopped (EOS, budget) is masked: it commits nothing, its
length stays and its K/V writes go to the scratch page (paged) or past
its own length (dense, never visible).  ``iters`` counts only the
iterations in which a row ran, as JAX's does.

Generators.  Every slot's ``torch.Generator`` is registered with the
graph (``CUDAGraph.register_generator_state``), so a replayed iteration
draws from the same Philox offsets as a single step, and
``manual_seed`` / ``set_state`` between windows move the replays too.
Unlike JAX's per-row key discipline, every slot draws at every
iteration, running or not (a branch on device values cannot be
captured), by the same amount each time: one ``torch.multinomial`` a
decode iteration; ``k`` uniforms and one ``torch.multinomial`` a
speculation iteration, as a host-drafted verify step of ``k`` drafts.
That is harmless only while two things hold: a row at temperature 0
never uses its draws, and a row that stops running inside a window
belongs to a request that retires at that window's commit (EOS or
budget), so its generator is reseeded at the next admission
(``manual_seed``, or ``set_state`` of a vacated request's saved state)
before it draws for anyone again.

Device counters.  Each iteration adds its row of the engine's
``OBS_DEVICE_COUNTERS`` (``counts``, the model state's tensor, whose
address the graph holds) on the device: iterations in which a row ran,
tokens committed, running rows, drafts accepted and rows stopped at
their EOS — JAX's loop body's counts.  An iteration in which no row runs
adds zeros, so the masked tail of a window and the capture's warm-up
(no row running) count nothing, and every replay counts once.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudp_torch.models.generate import KVCache, draft_greedy
from tpudp_torch.ops.paged_attention import GraphLaunches
from tpudp_torch.ops.sampling import sample_rows, verify_rows

#: The inputs the host loads before each window: name -> dtype.
_INPUTS = {"last": torch.int64, "lens": torch.int32, "running": torch.bool,
           "temps": torch.float32, "top_k": torch.int64,
           "top_p": torch.float32, "budgets": torch.int64,
           "eos": torch.int64, "table": torch.int32, "hist": torch.int64}


def add_counts(counts, steps, tokens, slot_steps, accepted=None,
               eos_exits=None) -> None:
    """Add one step's row to an engine's ``OBS_DEVICE_COUNTERS`` tensor on
    the device: ``steps`` a 0-d tensor, the others tensors summed (None:
    0).  No value is read back and no host value is copied in, so it
    runs inside a captured graph too."""
    zero = counts.new_zeros(())
    counts.add_(torch.stack([
        x.sum().to(counts.dtype) if x is not None else zero
        for x in (steps, tokens, slot_steps, accepted, eos_exits)]))


class CaptureError(RuntimeError):
    """A window's CUDA graph could not be captured.  It is a fault of the
    program, not of a step, so the engine does not contain it."""


class _GraphWindow:
    """Static buffers, the load-replay-fetch cycle and the capture that a
    window's iteration (:meth:`iterate`, in a subclass) runs in.

    ``shapes`` gives each input's shape (see :data:`_INPUTS`) and
    ``outputs`` each output's, in the order they are fetched: one int64
    tensor holds them all."""

    def __init__(self, *, shapes: dict, outputs: dict, n_steps: int,
                 generators, device, counts):
        self.n_steps = n_steps
        self.generators = list(generators)
        self.device = torch.device(device)
        self.counts = counts  # the engine's OBS_DEVICE_COUNTERS tensor
        self.inputs = {name: torch.zeros(shape, dtype=_INPUTS[name],
                                         device=self.device)
                       for name, shape in shapes.items()}
        on_card = self.device.type == "cuda"
        # Pinned twins: the host writes them, the window copies from them.
        self._staging = ({name: torch.zeros(buf.shape, dtype=buf.dtype,
                                            pin_memory=True)
                          for name, buf in self.inputs.items()}
                         if on_card else None)
        sizes = [int(np.prod(shape)) for shape in outputs.values()]
        self.result = torch.zeros(sum(sizes), dtype=torch.int64,
                                  device=self.device)
        self.outputs = {}
        at = 0
        for (name, shape), size in zip(outputs.items(), sizes):
            self.outputs[name] = self.result[at:at + size].view(shape)
            at += size
        self.graph = None
        self.launches = GraphLaunches()
        self.captures = 0
        self.replays = 0

    def iterate(self) -> None:
        raise NotImplementedError

    def _run(self, values: dict, steps: int) -> dict:
        """Load ``values`` (numpy arrays by input name), run ``steps <=
        n_steps`` iterations — graph replays on the card, the eager loop
        off it — and fetch once: returns the outputs as numpy arrays."""
        if not 1 <= steps <= self.n_steps:
            raise ValueError(f"a window runs 1..{self.n_steps} iterations, "
                             f"got {steps}")
        self._load(values)
        if self.device.type == "cuda":
            if self.graph is None:
                self._capture()
            for _ in range(steps):
                self.graph.replay()
            self.replays += steps
            self.launches.replayed(steps)
        else:
            for _ in range(steps):
                self.iterate()
        res = self.result.cpu().numpy().copy()  # the window's one fetch
        out, at = {}, 0
        for name, buf in self.outputs.items():
            out[name] = res[at:at + buf.numel()].reshape(buf.shape)
            at += buf.numel()
        return out

    def _load(self, values: dict) -> None:
        for name, buf in self.inputs.items():
            src = torch.from_numpy(np.ascontiguousarray(values[name]))
            if self._staging is None:
                buf.copy_(src)
            else:
                # The previous window's fetch waited for the stream, so no
                # copy from this staging tensor is still in flight.
                stage = self._staging[name]
                stage.copy_(src)
                buf.copy_(stage, non_blocking=True)
        self.result.zero_()

    def _capture(self) -> None:
        """Warm up on a side stream, then capture one iteration (PyTorch's
        recipe).  The warm-up runs with no row running — nothing commits,
        page writes go to the scratch page — to load each kernel library,
        make its once-a-device shared-memory opt-in, size the kernels'
        split scratch and cuBLAS's workspace on the capture stream; then
        the generators and the running mask get back the values they had.
        A failed capture raises :class:`CaptureError`: there is no eager
        fallback on the card."""
        running = self.inputs["running"]
        mask = running.clone()
        saved = [g.get_state() for g in self.generators]
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        running.zero_()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.cuda.stream(stream):
                for _ in range(2):
                    self.iterate()
            torch.cuda.current_stream(self.device).wait_stream(stream)
            with self.launches.capturing():
                with torch.cuda.graph(graph, stream=stream):
                    self.iterate()
        except Exception as exc:
            raise CaptureError(f"capturing the window's iteration failed: "
                               f"{type(exc).__name__}: {exc}") from exc
        finally:
            running.copy_(mask)
            for g, state in zip(self.generators, saved):
                g.set_state(state)
        self.result.zero_()
        self.graph = graph
        self.captures += 1


def _input_shapes(num_slots: int, table_pages: int | None) -> dict:
    shapes = {name: (num_slots,) for name in _INPUTS
              if name not in ("table", "hist")}
    if table_pages is not None:
        shapes["table"] = (num_slots, table_pages)
    return shapes


class FusedWindow(_GraphWindow):
    """One engine's decode window: up to N decode iterations.

    ``forward(tokens (S, 1), lens (S,) int32, running (S,) bool, table)``
    returns ``(S, 1, vocab)`` float32 logits and writes the K/V of the
    running rows' tokens at ``lens`` in place (``table`` is the window's
    ``(S, table_pages)`` int32 block table, or None for the dense arena).
    ``generators`` holds one generator per slot, on ``device``; ``counts``
    the engine's device counters."""

    def __init__(self, forward, *, num_slots: int, n_steps: int,
                 table_pages: int | None, generators, device, counts):
        super().__init__(
            shapes=_input_shapes(num_slots, table_pages),
            outputs={"out": (num_slots, n_steps), "n_emit": (num_slots,),
                     "iters": ()},
            n_steps=n_steps, generators=generators, device=device,
            counts=counts)
        self.forward = forward
        self._cols = torch.arange(n_steps, device=self.device)

    def iterate(self) -> None:
        """One decode iteration over the static buffers — JAX's loop body,
        line for line: forward, sample, commit where running, count, and
        stop a row at its EOS or budget."""
        b, o = self.inputs, self.outputs
        running, last = b["running"], b["last"]
        logits = self.forward(last[:, None], b["lens"], running,
                              b.get("table"))
        toks = sample_rows(logits[:, 0], b["temps"], b["top_k"], b["top_p"],
                           self.generators)
        toks = torch.where(running, toks, last)
        b["lens"] += running
        n_emit = o["n_emit"]
        col = (self._cols[None, :] == n_emit[:, None]) & running[:, None]
        o["out"].copy_(torch.where(col, toks[:, None], o["out"]))
        n_emit += running
        o["iters"] += running.any()
        hit_eos = running & (toks == b["eos"])
        add_counts(self.counts, running.any(), running, running,
                   eos_exits=hit_eos)
        running &= ~hit_eos & (n_emit < b["budgets"])
        last.copy_(toks)

    def run(self, values: dict, steps: int):
        """One window: returns ``(out (S, N), n_emit (S,), iters)``."""
        o = self._run(values, steps)
        return o["out"], o["n_emit"], int(o["iters"])


#: The draft history's prefill runs in q-chunks of at most this many
#: tokens (the largest divisor of the history's width up to it): one
#: chunk's score tiles are live at a time, ``(S, heads, chunk, W + k)``.
DRAFT_CHUNK = 128


class FusedSpecWindow(_GraphWindow):
    """One engine's fused speculation window: up to N draft -> verify ->
    accept iterations of ``k`` drafts each.

    ``forward(tokens (S, k + 1), lens, running, table)`` is the target's
    verify forward (K/V of the window written at ``lens .. lens + k``
    before attending, as :class:`FusedWindow`'s).  ``draft_model`` is
    the draft model; its KV store, a ``KVCache`` of ``(S, hist_len +
    k)``, is allocated here once and refilled by every iteration from the
    ``(S, hist_len)`` token history ``hist``, which the window extends
    with each commit (``tpudp_torch.models.generate.draft_greedy``).
    ``counts``: the engine's device counters."""

    def __init__(self, forward, draft_model, *, num_slots: int,
                 n_steps: int, k: int, hist_len: int,
                 table_pages: int | None, generators, device, counts):
        w = k + 1
        super().__init__(
            shapes={**_input_shapes(num_slots, table_pages),
                    "hist": (num_slots, hist_len)},
            outputs={"out": (num_slots, n_steps * w),
                     "n_emit": (num_slots,), "n_win": (num_slots,),
                     "n_acc": (num_slots,), "takes": (num_slots, n_steps),
                     "iters": ()},
            n_steps=n_steps, generators=generators, device=device,
            counts=counts)
        self.forward = forward
        self.draft_model = draft_model
        self.k = k
        self.chunk = next(c for c in range(min(hist_len, DRAFT_CHUNK), 0, -1)
                          if hist_len % c == 0)
        self.draft_cache = KVCache.zeros(draft_model.config, num_slots,
                                         hist_len + k, self.device)
        self._cols = torch.arange(n_steps * w, device=self.device)
        self._steps = torch.arange(n_steps, device=self.device)
        self._wcols = torch.arange(w, device=self.device)
        self._hcols = torch.arange(hist_len, device=self.device)

    def draft(self) -> torch.Tensor:
        """The iteration's ``(S, k)`` drafts from the history."""
        b = self.inputs
        return draft_greedy(self.draft_model, b["hist"], self.draft_cache,
                            b["lens"], self.k, self.chunk)

    def iterate(self) -> None:
        """One speculation iteration over the static buffers — JAX's loop
        body, line for line: draft, verify the ``k + 1`` window through
        the target, accept (:func:`verify_rows`), cut each row at its
        first EOS and its budget, scatter the taken tokens into ``out``
        and ``hist``, count, and stop a row at its EOS or budget."""
        b, o = self.inputs, self.outputs
        running, last, lens = b["running"], b["last"], b["lens"]
        w = self.k + 1
        drafts = self.draft()
        logits = self.forward(torch.cat([last[:, None], drafts], dim=1),
                              lens, running, b.get("table"))
        toks, n_w = verify_rows(logits, drafts, b["temps"], b["top_k"],
                                b["top_p"], self.generators)
        jidx = self._wcols[None, :]
        valid = jidx < n_w[:, None]
        eos_at = torch.where(valid & (toks == b["eos"][:, None]), jidx,
                             w).amin(dim=1)
        n_emit = o["n_emit"]
        take = torch.minimum(n_w, torch.minimum(eos_at + 1,
                                                b["budgets"] - n_emit))
        take = torch.where(running, take, 0)
        # Taken tokens land in out at columns [n_emit, n_emit + take) and
        # in hist at positions [lens + 1, lens + 1 + take): the next
        # iteration's draft context.
        rel = self._cols[None, :] - n_emit[:, None]
        put = (rel >= 0) & (rel < take[:, None])
        vals = torch.gather(toks, 1, rel.clamp(0, w - 1))
        o["out"].copy_(torch.where(put, vals, o["out"]))
        rel_h = self._hcols[None, :] - (lens.long() + 1)[:, None]
        put_h = (rel_h >= 0) & (rel_h < take[:, None])
        vals_h = torch.gather(toks, 1, rel_h.clamp(0, w - 1))
        b["hist"].copy_(torch.where(put_h, vals_h, b["hist"]))
        last_new = torch.gather(toks, 1, (take - 1).clamp(min=0)[:, None])
        last.copy_(torch.where(running, last_new[:, 0], last))
        lens += take.to(lens.dtype)
        n_emit += take
        # A row runs from the window's first iteration until it stops, so
        # n_win is the iteration it is in: takes[s, i] is what row s took
        # in iteration i (the order fuse_stream replays).
        at = (self._steps[None, :] == o["n_win"][:, None]) & running[:, None]
        o["takes"].copy_(torch.where(at, take[:, None], o["takes"]))
        o["n_win"] += running
        acc = torch.where(running, n_w - 1, 0)
        o["n_acc"] += acc
        o["iters"] += running.any()
        hit_eos = running & (take == eos_at + 1)
        add_counts(self.counts, running.any(), take, running, acc, hit_eos)
        running &= ~hit_eos & (n_emit < b["budgets"])

    def run(self, values: dict, steps: int) -> dict:
        """One window: returns ``out (S, N (k + 1))``, ``n_emit``,
        ``n_win`` (iterations each row ran), ``n_acc`` (drafts each row
        accepted), ``takes (S, N)`` (tokens each row took an iteration)
        and ``iters``, as numpy."""
        return self._run(values, steps)
