"""The fused decode window of ``Engine(decode_fuse=N)`` — the port of
``tpudp/serve/engine.py``'s ``_fused_decode_math`` (a ``lax.while_loop``
of up to N decode iterations on the device, fetched once a window).

On the card a window is one CUDA graph of a whole decode iteration —
embedding, every layer's matmuls, page writes and paged attention (K4 or
K4-int8 through the block table), the head, sampling and the carry
updates — replayed up to N times with no host sync in between, then one
fetch.  Off the card the same iteration runs eagerly in a Python loop:
that loop is the window's plain version, and the CPU tests hold it
against the JAX engine.

The graph reads and writes static buffers only: the host fills the
inputs with ``copy_`` from pinned host tensors before each window (no
copy from pageable memory happens inside the graph, whose address would
be baked into it), and reads ``out``, ``n_emit`` and ``iters`` back as
one tensor.  It is captured once per engine, at its first window: the
geometry (slots, table width, window length) is fixed, K4's grid is
sized from the table's capacity (``paged_attention.decode_schedule``),
not from the depths, and its split scratch is sized by the warm-up.

Early exit.  JAX's loop stops once no row runs.  A graph cannot stop
without a host sync, so the host replays ``min(N, largest budget)``
iterations; a row that has stopped (EOS, budget) is masked: it commits
nothing, its length stays and its K/V write goes to the scratch page
(paged) or to its own next position (dense, never visible).  ``iters``
counts only the iterations in which a row ran, as JAX's does.

Generators.  Every slot's ``torch.Generator`` is registered with the
graph (``CUDAGraph.register_generator_state``), so a replayed iteration
draws from the same Philox offsets as a single decode step, and
``manual_seed`` / ``set_state`` between windows move the replays too.
Unlike JAX's per-row key discipline, every slot draws at every
iteration, running or not (a branch on device values cannot be
captured).  That is harmless only while two things hold: a row at
temperature 0 never uses its draw, and a row that stops running inside a
window belongs to a request that retires at that window's commit (EOS or
budget), so its generator is reseeded at the next admission
(``manual_seed``, or ``set_state`` of a vacated request's saved state)
before it draws for anyone again.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudp_torch.ops.paged_attention import GraphLaunches
from tpudp_torch.ops.sampling import sample_rows

#: The inputs the host loads before each window: name -> dtype.
_INPUTS = {"last": torch.int64, "lens": torch.int32, "running": torch.bool,
           "temps": torch.float32, "top_k": torch.int64,
           "top_p": torch.float32, "budgets": torch.int64,
           "eos": torch.int64, "table": torch.int32}


class FusedWindow:
    """One engine's window: static buffers, the iteration body and, on a
    CUDA device, its graph.

    ``forward(tokens (S, 1), lens (S,) int32, running (S,) bool, table)``
    returns ``(S, 1, vocab)`` float32 logits and writes the K/V of the
    running rows' tokens at ``lens`` in place (``table`` is the window's
    ``(S, table_pages)`` int32 block table, or None for the dense arena).
    ``generators`` holds one generator per slot, on ``device``."""

    def __init__(self, forward, *, num_slots: int, n_steps: int,
                 table_pages: int | None, generators, device):
        self.forward = forward
        self.n_steps = n_steps
        self.generators = list(generators)
        self.device = torch.device(device)
        s = num_slots
        shapes = {name: (s,) for name in _INPUTS if name != "table"}
        if table_pages is not None:
            shapes["table"] = (s, table_pages)
        self.inputs = {name: torch.zeros(shape, dtype=_INPUTS[name],
                                         device=self.device)
                       for name, shape in shapes.items()}
        on_card = self.device.type == "cuda"
        # Pinned twins: the host writes them, the window copies from them.
        self._staging = ({name: torch.zeros(buf.shape, dtype=buf.dtype,
                                            pin_memory=True)
                          for name, buf in self.inputs.items()}
                         if on_card else None)
        # out (S, N), n_emit (S,) and iters, fetched as one tensor.
        self.result = torch.zeros(s * n_steps + s + 1, dtype=torch.int64,
                                  device=self.device)
        self.out = self.result[:s * n_steps].view(s, n_steps)
        self.n_emit = self.result[s * n_steps:-1]
        self.iters = self.result[-1]
        self._cols = torch.arange(n_steps, device=self.device)
        self.graph = None
        self.launches = GraphLaunches()
        self.captures = 0
        self.replays = 0

    # -- the iteration ---------------------------------------------------

    def iterate(self) -> None:
        """One decode iteration over the static buffers — JAX's loop body,
        line for line: forward, sample, commit where running, count, and
        stop a row at its EOS or budget."""
        b = self.inputs
        running, last = b["running"], b["last"]
        logits = self.forward(last[:, None], b["lens"], running,
                              b.get("table"))
        toks = sample_rows(logits[:, 0], b["temps"], b["top_k"], b["top_p"],
                           self.generators)
        toks = torch.where(running, toks, last)
        b["lens"] += running
        col = (self._cols[None, :] == self.n_emit[:, None]) & running[:, None]
        self.out.copy_(torch.where(col, toks[:, None], self.out))
        self.n_emit += running
        self.iters += running.any()
        running &= (toks != b["eos"]) & (self.n_emit < b["budgets"])
        last.copy_(toks)

    # -- a window --------------------------------------------------------

    def run(self, values: dict, steps: int):
        """Load ``values`` (numpy arrays by input name), run ``steps <=
        n_steps`` iterations — graph replays on the card, the eager loop
        off it — and fetch once: returns ``(out (S, N), n_emit (S,),
        iters)`` as numpy / int."""
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
        s, n = self.out.shape
        return res[:s * n].reshape(s, n), res[s * n:-1], int(res[-1])

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
        make its once-a-device shared-memory opt-in, size K4's split
        scratch and cuBLAS's workspace on the capture stream; then the
        generators and the running mask get back the values they had.  A
        failed capture raises: there is no eager fallback on the card."""
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
        finally:
            running.copy_(mask)
            for g, state in zip(self.generators, saved):
                g.set_state(state)
        self.result.zero_()
        self.graph = graph
        self.captures += 1
