"""The port's hazard rules — the counterparts of ``tpudp/analysis/
rules.py``, aimed at what goes wrong in PyTorch on a card.

Repo knowledge lives in the tables below (which defs are hot paths,
which are captured into a CUDA graph, which attributes a graph owns),
so the rules hold even where a file stops advertising them; fixture
files opt in through markers instead: ``# tpudp: hot-path`` or ``#
tpudp: captured`` on a def line or the line above it, and ``# tpudp:
collective-module``, ``# tpudp: kernel-module`` or ``# tpudp:
program-module`` in a file's first lines.

Stdlib only (see :mod:`tpudp_torch.analysis.core`).
"""

from __future__ import annotations

import ast
import re

from .core import Module, Rule, mentions, ordered_walk

# -- repo-aware configuration -----------------------------------------------

#: Host code on the per-token and per-step critical path, where an
#: unannounced host sync is a latency regression: repo-relative path ->
#: def qualnames (defs nested in them run on the path too).
HOT_PATHS = {
    "tpudp_torch/serve/engine.py": {
        "Engine.step", "Engine._run_prefill_chunk", "Engine._run_decode",
        "Engine._run_decode_fused", "Engine._run_spec_fused",
        "Engine._run_verify", "Engine._run_verify_tree",
        "Engine._gather_drafts", "Engine._commit",
    },
    "tpudp_torch/trainer.py": {"Trainer.train_epoch", "Trainer.evaluate"},
}

#: Dotted roots that hold device values inside hot paths (the host-sync
#: rule's taint seeds), per file.
DEVICE_ROOTS = {
    "tpudp_torch/serve/engine.py": {"ms.obs_counts"},
    "tpudp_torch/trainer.py": {"self.state.loss_sum", "self.state.sdc_fp",
                               "self.state.obs_norms"},
}

#: Calls whose results are device values (taint seeds), by terminal
#: name: the step programs and the forwards they run.
DEVICE_CALLS = {
    "train_step", "eval_step", "_forward_paged", "_forward_cached",
    "_forward_tree", "_forward_tree_paged", "_decode_math", "sample_tokens",
    "verify_tokens", "verify_tree_tokens", "_sample_row", "_to_device",
    "_tree_verify",
}

#: The bodies captured into a CUDA graph (replayed with no Python in
#: between), and what they call in other modules: path -> qualnames.
#: Within a file, a def a captured def calls is captured too.
CAPTURED = {
    "tpudp_torch/serve/fused.py": {"FusedWindow.iterate",
                                   "FusedSpecWindow.iterate"},
    "tpudp_torch/ops/sampling.py": {"sample_rows", "verify_rows"},
    "tpudp_torch/models/generate.py": {"draft_greedy"},
}

#: Device values inside a captured body: the window's static buffers.
CAPTURED_ROOTS = {"self.inputs", "self.outputs", "self.counts",
                  "self.result", "self.draft_cache"}

#: Host clocks, RNGs and process identity (resolved dotted prefixes).
NONDET_PREFIXES = ("time.", "random.", "numpy.random.", "datetime.",
                   "uuid.", "secrets.", "os.urandom", "os.getpid")

#: torch's RNG calls: each must name its ``generator=`` inside a captured
#: body (the graph registers those generators' states; the default
#: generator's offset would be frozen into the replay).
TORCH_RNG_FUNCS = {"rand", "randn", "randint", "rand_like", "randn_like",
                   "randint_like", "multinomial", "bernoulli", "normal",
                   "randperm", "poisson"}
TORCH_RNG_METHODS = {"uniform_", "normal_", "exponential_", "random_",
                     "geometric_", "cauchy_", "log_normal_", "bernoulli_",
                     "multinomial"}

#: Host syncs.
SYNC_FUNCS = {"float", "int", "bool"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
SYNC_BARRIERS = {"torch.cuda.synchronize"}

#: Attributes a captured window owns: its static outputs and inputs, and
#: the device counters its replays accumulate into.  A reference taken
#: from one is overwritten by the next replay.
GRAPH_OWNED = {"outputs", "result", "inputs", "counts", "obs_counts"}
#: Calls that replay a captured window.
REPLAY_CALLS = {"replay", "run", "_run", "_run_window"}

#: Modules whose host-side order feeds collectives, leaf or parameter
#: order or checkpoint manifests.
COLLECTIVE_MODULE_PREFIXES = (
    "tpudp_torch/parallel/", "tpudp_torch/resilience.py",
    "tpudp_torch/mesh.py", "tpudp_torch/utils/consistency.py",
    "tpudp_torch/utils/checkpoint.py", "tpudp_torch/sdc.py",
    "tpudp_torch/train.py",
)

#: The collectives: ``parallel/collectives.py``'s (terminal names), the
#: ``torch.distributed`` calls, and the host protocol helpers every rank
#: must reach together.
COLLECTIVE_HELPERS = {
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all", "shift",
    "send", "recv", "copy_to_group", "reduce_from_group",
    "gather_from_group", "gather_to_split", "all_to_all_autograd",
    "ring_shift", "all_reduce_mean", "gather_host_values",
    "gather_host_blobs", "all_hosts_ok", "coordinated_any",
    "_vote", "_coordinated_recover", "mean_over",
}
DIST_CALLS = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "reduce_scatter_tensor", "reduce_scatter", "all_to_all_single",
    "all_to_all", "broadcast", "barrier", "monitored_barrier", "send",
    "recv", "isend", "irecv", "batch_isend_irecv", "gather", "scatter",
    "all_gather_object", "broadcast_object_list",
}

#: Rank-dependent condition sources for the collective rule.
DIVERGENT_PREFIXES = ("os.", "time.", "glob.", "random.", "numpy.random.",
                      "socket.", "shutil.", "tempfile.", "pathlib.")
DIVERGENT_ATTRS = {"get_rank", "rank", "process_index", "exists", "isfile",
                   "isdir", "listdir", "errno", "pid", "getmtime", "stat"}
DIVERGENT_BUILTINS = {"open", "input"}

#: Modules whose step-program factories (``make_*_step``) and CUDA-graph
#: capture sites must be registered in ``programs.py``, and whose
#: ``self._device(kind, ...)`` calls must name a registered kind.
PROGRAM_SCOPE_PREFIXES = ("tpudp_torch/train.py",
                          "tpudp_torch/parallel/schedule.py",
                          "tpudp_torch/serve/")
FACTORY_RE = re.compile(r"^make_\w*_step$")

#: Modules whose extension launches must sit in a counted wrapper.
KERNEL_SCOPE_PREFIXES = ("tpudp_torch/ops/",)

#: The obs recorder's allocating calls (the allocation-free ones are
#: ``begin``/``end``/``count``).
OBS_ALLOC_METHODS = {"span", "event"}


def _in_scope(mod: Module, prefixes, marker: str) -> bool:
    if marker in mod.markers:
        return True
    return any(mod.rel.endswith(p) if p.endswith(".py") else p in mod.rel
               for p in prefixes)


def _marked(mod: Module, fn, marker: str) -> bool:
    start = fn.decorator_list[0].lineno if fn.decorator_list else fn.lineno
    return any(f"tpudp: {marker}" in mod.comments.get(line, "")
               for line in range(max(1, start - 1), fn.lineno + 1))


def _table(mod: Module, table: dict) -> set:
    for path, quals in table.items():
        if mod.rel.endswith(path):
            return set(quals)
    return set()


def _nested_in(mod: Module, roots: set) -> set:
    """``roots`` and every def nested in one of them."""
    out = set(roots)
    for fn in mod.functions:
        cur = mod.enclosing_function(fn)
        while cur is not None:
            if cur in roots:
                out.add(fn)
                break
            cur = mod.enclosing_function(cur)
    return out


def _hot_functions(mod: Module) -> set:
    """The hot-path defs of ``mod``: the table's, those marked ``#
    tpudp: hot-path``, and the defs nested in either."""
    table = _table(mod, HOT_PATHS)
    roots = {fn for fn, qual in mod.functions.items()
             if qual in table or _marked(mod, fn, "hot-path")}
    return _nested_in(mod, roots)


def _callee_name(node: ast.Call) -> str | None:
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _captured_functions(mod: Module) -> set:
    """The captured defs of ``mod``: the table's and the marked ones,
    then, to a fixpoint, every def of the module they call (by name, or
    as ``self.<name>``)."""
    table = _table(mod, CAPTURED)
    out = {fn for fn, qual in mod.functions.items()
           if qual in table or _marked(mod, fn, "captured")}
    by_name: dict[str, list] = {}
    for fn in mod.functions:
        by_name.setdefault(fn.name, []).append(fn)
    todo = list(out)
    while todo:
        fn = todo.pop()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                for callee in by_name.get(_callee_name(node) or "", ()):
                    if callee not in out:
                        out.add(callee)
                        todo.append(callee)
    return _nested_in(mod, out)


def _assign_targets(node) -> list:
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    flat = []
    for t in targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            flat.extend(t.elts)
        else:
            flat.append(t)
    return flat


def _host_read(node) -> bool:
    """Is ``node`` a read to the host (its result a host value)?"""
    return isinstance(node, ast.Call) and (
        (isinstance(node.func, ast.Attribute)
         and node.func.attr in SYNC_METHODS)
        or (isinstance(node.func, ast.Name) and node.func.id in SYNC_FUNCS))


def _pairs(node: ast.Assign) -> list:
    """``(target, value)`` pairs of an assignment, element-wise for
    ``a, b = x, y``."""
    out = []
    for t in node.targets:
        if (isinstance(t, (ast.Tuple, ast.List))
                and isinstance(node.value, (ast.Tuple, ast.List))
                and len(t.elts) == len(node.value.elts)):
            out += list(zip(t.elts, node.value.elts))
        elif isinstance(t, (ast.Tuple, ast.List)):
            out += [(e, node.value) for e in t.elts]
        else:
            out.append((t, node.value))
    return out


def _device_call(mod: Module, node) -> bool:
    """Does ``node`` hold a call that mints a device value (``torch.*``,
    a step program or forward)?"""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        dotted = mod.dotted(sub.func) or ""
        if dotted.startswith("torch.") and not dotted.startswith(
                ("torch.cuda.", "torch.distributed.")):
            return True
        if _callee_name(sub) in DEVICE_CALLS:
            return True
    return False


def _taint(mod: Module, fn, seeds: set) -> set:
    """Dotted names of ``fn`` that hold device values: ``seeds``, then
    (in source order) every assignment target whose value mentions one
    or calls a device-minting function."""
    tainted = set(seeds)
    for node in ordered_walk(fn):
        if not isinstance(node, (ast.Assign, ast.AugAssign, ast.For)):
            continue
        value = node.iter if isinstance(node, ast.For) else node.value
        targets = ([node.target] if isinstance(node, ast.For)
                   else _assign_targets(node))
        hit = not _host_read(value) and (mentions(mod, value, tainted)
                                         or _device_call(mod, value))
        for t in targets:
            for sub in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                        else [t]):
                dotted = mod.raw_dotted(sub)
                if dotted is None:
                    continue
                if hit:
                    tainted.add(dotted)
                elif not isinstance(node, ast.AugAssign):
                    tainted.discard(dotted)
    return tainted


def _tensor_params(fn) -> set:
    """The parameters of ``fn`` annotated as tensors (the device values a
    captured callee receives; a model, a config or a count is host)."""
    return {a.arg for a in fn.args.posonlyargs + fn.args.args
            + fn.args.kwonlyargs
            if a.annotation is not None
            and "Tensor" in ast.unparse(a.annotation)}


# -- the rules ----------------------------------------------------------------


class CaptureNondeterminism(Rule):
    """Host clocks, host RNGs and the default torch generator inside a
    captured window's body.

    A CUDA graph records the kernels one eager pass launched: a value a
    Python call returned while capturing (``time.time()``,
    ``random.random()``, ``np.random``) is frozen into every replay, and
    a torch RNG call without ``generator=`` draws from the default
    generator, whose offset the graph does not advance for the engine's
    per-slot generators.  Pass host values in through the window's
    static inputs, and draw from the registered per-slot generators.
    """

    name = "capture-nondeterminism"
    summary = ("host clock/RNG call, or a torch RNG call without "
               "generator=, inside a captured window's body")

    def check(self, mod: Module):
        for fn in _captured_functions(mod):
            for node in ordered_walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                dotted = mod.dotted(node.func) or ""
                if any(dotted == p.rstrip(".") or dotted.startswith(p)
                       for p in NONDET_PREFIXES):
                    yield self.finding(
                        mod, node,
                        f"{dotted}() inside captured `{fn.name}` is frozen "
                        f"into every replay; load it into the window's "
                        f"static inputs")
                    continue
                rng = (dotted.startswith("torch.")
                       and dotted.split(".")[-1] in TORCH_RNG_FUNCS) or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in TORCH_RNG_METHODS
                    and not dotted.startswith("torch."))
                if rng and not any(kw.arg == "generator"
                                   for kw in node.keywords):
                    yield self.finding(
                        mod, node,
                        f"{_callee_name(node)}() without generator= inside "
                        f"captured `{fn.name}` draws from the default "
                        f"generator; pass the slot's registered generator")


class CaptureBranch(Rule):
    """Python control flow on a tensor value inside a captured body.

    ``if x.any():`` reads the tensor back while capturing (a sync that
    fails inside a capture, or succeeds eagerly and then freezes the
    branch taken): every replay runs that branch whatever the values.
    Branch on the device with ``torch.where`` or a mask.
    """

    name = "capture-branch"
    summary = ("Python if/while/and/or/ternary on a tensor inside a "
               "captured body — the graph freezes the branch taken")

    def check(self, mod: Module):
        for fn in _captured_functions(mod):
            tainted = _taint(mod, fn, _tensor_params(fn) | CAPTURED_ROOTS)
            for node in ordered_walk(fn):
                tests = []
                if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    tests = [node.test]
                elif isinstance(node, ast.BoolOp):
                    tests = node.values
                elif isinstance(node, ast.Assert):
                    tests = [node.test]
                if any(mentions(mod, t, tainted) for t in tests):
                    kind = type(node).__name__.lower()
                    yield self.finding(
                        mod, node,
                        f"Python `{kind}` on a tensor in captured "
                        f"`{fn.name}` — the graph replays the branch taken "
                        f"at capture; use torch.where or a mask")


class HostSync(Rule):
    """A device-to-host read on a hot path.

    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and
    ``float()``/``int()``/``bool()`` of a device tensor wait for the
    card to drain its queue: one round trip per call on the per-token or
    per-step path.  ``torch.cuda.synchronize`` and an event's or a
    stream's ``synchronize()`` are the same barrier.  Every intended one
    (the step's one fetch) carries a visible ``lint-ok(host-sync)`` with
    its reason, so a new one cannot arrive unnoticed.
    """

    name = "host-sync"
    summary = ("device->host read (.item()/.tolist()/.cpu()/.numpy()/"
               "float()) or a synchronize() on a hot path")

    def _sync(self, mod, node, tainted) -> str | None:
        if not isinstance(node, ast.Call):
            return None
        dotted = mod.dotted(node.func) or ""
        if dotted in SYNC_BARRIERS:
            return f"{dotted}()"
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "synchronize"):
            return ".synchronize()"
        if (isinstance(node.func, ast.Name) and node.func.id in SYNC_FUNCS
                and node.args and mentions(mod, node.args[0], tainted)):
            return f"{node.func.id}()"
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in SYNC_METHODS
                and mentions(mod, node.func.value, tainted)):
            return f".{node.func.attr}()"
        return None

    def check(self, mod: Module):
        roots = _table(mod, DEVICE_ROOTS)
        for fn in _hot_functions(mod):
            tainted = _taint(mod, fn, roots)
            for node in ordered_walk(fn):
                desc = self._sync(mod, node, tainted)
                if desc is not None:
                    yield self.finding(
                        mod, node,
                        f"{desc} forces a device->host sync on the "
                        f"`{fn.name}` hot path — one round trip per call")


class UseAfterReplay(Rule):
    """A reference into a captured window's storage read after a later
    replay.

    A CUDA graph writes its outputs (and the device counters it
    accumulates into) at fixed addresses; a tensor taken from them
    without a copy aliases that storage, so the next replay of the same
    window overwrites what it holds.  Copy it off (``.clone()``, a
    fetch) before the window runs again.
    """

    name = "use-after-replay"
    summary = ("read of a captured window's static output or counters "
               "after a later replay, with no copy taken")

    def _alias_of(self, mod, value) -> str | None:
        """The graph-owned root ``value`` aliases, or None (a copy)."""
        node = value
        while True:
            if isinstance(node, ast.Subscript):
                node = node.value
            elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr in (
                        "view", "reshape", "narrow", "detach", "get"):
                node = node.func.value
            else:
                break
        if isinstance(node, ast.Attribute) and node.attr in GRAPH_OWNED:
            return mod.raw_dotted(node)
        return None

    def check(self, mod: Module):
        for fn in mod.functions:
            aliases: dict[str, tuple] = {}  # var -> (root, line)
            replays: list[tuple] = []  # (line, receiver)
            for node in ordered_walk(fn):
                if isinstance(node, ast.Assign):
                    root = self._alias_of(mod, node.value)
                    for t in _assign_targets(node):
                        dotted = mod.raw_dotted(t)
                        if dotted is None:
                            continue
                        if root is not None:
                            aliases[dotted] = (root, node.lineno)
                        else:
                            aliases.pop(dotted, None)
                elif (isinstance(node, ast.Call)
                      and isinstance(node.func, ast.Attribute)
                      and node.func.attr in REPLAY_CALLS):
                    replays.append((node.lineno,
                                    mod.raw_dotted(node.func.value) or ""))
                elif (isinstance(node, ast.Name)
                      and isinstance(node.ctx, ast.Load)
                      and node.id in aliases):
                    root, line = aliases[node.id]
                    owner = root.rsplit(".", 1)[0]
                    if any(line < r < node.lineno and (
                            recv == owner or recv.startswith(owner + ".")
                            or owner.startswith(recv + ".") or not recv)
                           for r, recv in replays):
                        yield self.finding(
                            mod, node,
                            f"`{node.id}` aliases `{root}` (line {line}) "
                            f"and is read after a later replay of its "
                            f"window — copy it off first")
                        del aliases[node.id]


class DivergentCollective(Rule):
    """A collective called under rank-dependent control flow.

    A collective is a rendezvous: every rank of its group must make
    the same sequence.  One under ``if dist.get_rank() == 0``, in an
    ``except`` handler, or behind a filesystem or clock condition is
    reached by some ranks and not others — a hang until the watchdog,
    not an exception.  Take per-rank outcomes through a vote (every
    rank reaches it; the decision is collective) and suppress here with
    the reason.  The protocol verifier is this rule's interprocedural,
    path-sensitive generalization.
    """

    name = "divergent-collective"
    summary = ("collective (parallel/collectives.py or torch.distributed) "
               "under rank-dependent control flow — a hang")

    def _is_collective(self, mod, node) -> bool:
        dotted = mod.dotted(node.func) or ""
        if dotted.startswith("torch.distributed."):
            return dotted.split(".")[-1] in DIST_CALLS
        return _callee_name(node) in COLLECTIVE_HELPERS

    def _divergent(self, mod, node, tainted) -> bool:
        if isinstance(node, ast.Call):
            if self._is_collective(mod, node):
                return False  # a vote's result is rank-uniform
            dotted = mod.dotted(node.func) or ""
            if any(dotted.startswith(p) for p in DIVERGENT_PREFIXES) or \
                    dotted in DIVERGENT_BUILTINS:
                return True
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in DIVERGENT_ATTRS):
                return True
        elif isinstance(node, (ast.Name, ast.Attribute)):
            dotted = mod.raw_dotted(node)
            if dotted and dotted in tainted:
                return True
            if isinstance(node, ast.Attribute) and \
                    node.attr in DIVERGENT_ATTRS:
                return True
        return any(self._divergent(mod, c, tainted)
                   for c in ast.iter_child_nodes(node))

    def _under(self, mod, node, fn, tainted) -> bool:
        cur = mod.parents.get(node)
        while cur is not None and cur is not fn:
            if isinstance(cur, ast.ExceptHandler):
                return True
            if isinstance(cur, (ast.If, ast.While)) and \
                    self._divergent(mod, cur.test, tainted):
                return True
            cur = mod.parents.get(cur)
        return False

    def check(self, mod: Module):
        for fn in mod.functions:
            tainted: set[str] = set()
            changed = True
            while changed:
                changed = False
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Assign):
                        continue
                    under = self._under(mod, node, fn, tainted)
                    for t, v in _pairs(node):
                        dotted = mod.raw_dotted(t)
                        if dotted is None or dotted in tainted:
                            continue
                        if under or self._divergent(mod, v, tainted):
                            tainted.add(dotted)
                            changed = True
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and self._is_collective(mod, node)):
                    continue
                if mod.enclosing_function(node) is not fn:
                    continue  # a nested def is checked on its own
                at = node  # reported at its statement: the rendezvous
                while not isinstance(at, ast.stmt):
                    at = mod.parents[at]
                cur, prev = mod.parents.get(node), node
                while cur is not None and cur is not fn:
                    if isinstance(cur, ast.ExceptHandler):
                        yield self.finding(
                            mod, at,
                            "collective inside an except handler — a "
                            "fault is per-rank, so the ranks that did not "
                            "fault never reach the rendezvous")
                        break
                    if (isinstance(cur, (ast.If, ast.While))
                            and prev is not cur.test
                            and self._divergent(mod, cur.test, tainted)):
                        yield self.finding(
                            mod, at,
                            "collective under a rank-dependent condition "
                            "— ranks taking different branches hang the "
                            "rendezvous")
                        break
                    prev, cur = cur, mod.parents.get(cur)


class UnorderedIteration(Rule):
    """Iteration over a set where the order matters.

    A set's order depends on hashing (``PYTHONHASHSEED`` for strings):
    two ranks walking the same set can call collectives, order leaves
    or write manifest entries in different orders.  Sort it first.
    Unsorted ``os.listdir`` in these modules is the same hazard.
    """

    name = "unordered-iteration"
    summary = ("set iteration (or unsorted os.listdir) where order feeds "
               "collectives, leaf order or checkpoint manifests")

    def _is_set(self, mod, node) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        return isinstance(node, ast.Call) and mod.dotted(node.func) in (
            "set", "frozenset")

    def check(self, mod: Module):
        scoped = _in_scope(mod, COLLECTIVE_MODULE_PREFIXES,
                           "collective-module")
        captured = _captured_functions(mod)
        for node in ast.walk(mod.tree):
            iters = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters = [node.iter]
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                                   ast.DictComp)):
                iters = [g.iter for g in node.generators]
            for it in iters:
                if not self._is_set(mod, it):
                    continue
                if scoped or mod.enclosing_function(node) in captured:
                    yield self.finding(
                        mod, it,
                        "set iteration order depends on hashing; ranks "
                        "can walk it in different orders — sort it first")
        if not scoped:
            return
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Call)
                    and mod.dotted(node.func) == "os.listdir"):
                cur, in_sorted = mod.parents.get(node), False
                while cur is not None and not isinstance(cur, ast.stmt):
                    if isinstance(cur, ast.Call) and \
                            mod.dotted(cur.func) == "sorted":
                        in_sorted = True
                        break
                    cur = mod.parents.get(cur)
                if not in_sorted:
                    yield self.finding(
                        mod, node,
                        "os.listdir order is filesystem-dependent; wrap it "
                        "in sorted() so every rank walks the same order")


class UnregisteredProgram(Rule):
    """A step program the audit does not pin.

    The audit (``programs.py``) runs every registered step program at a
    pinned geometry and locks its kernel launches, host reads and
    collectives.  A step-program factory (``make_*_step``), a CUDA-graph
    capture site or an engine device call (``self._device(kind, ...)``)
    that no registry entry names can change without a lock diff.
    """

    name = "unregistered-program"
    summary = ("make_*_step factory, torch.cuda.graph capture site or "
               "engine device-call kind with no entry in programs.py")

    def check(self, mod: Module):
        if not _in_scope(mod, PROGRAM_SCOPE_PREFIXES, "program-module"):
            return
        from .programs import CAPTURE_SITES, DEVICE_KINDS, FACTORIES

        rel = mod.rel
        factories = {q for key, _ in FACTORIES.items()
                     for path, q in [key.split(":", 1)] if rel.endswith(path)}
        captures = {q for key in CAPTURE_SITES
                    for path, q in [key.split(":", 1)] if rel.endswith(path)}
        for fn, qual in mod.functions.items():
            if (FACTORY_RE.match(fn.name) and "." not in qual
                    and qual not in factories):
                yield self.finding(
                    mod, fn,
                    f"step-program factory `{qual}` has no entry in "
                    f"tpudp_torch/analysis/programs.py FACTORIES — its "
                    f"program is not pinned by the audit")
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = mod.dotted(node.func) or ""
            if dotted == "torch.cuda.graph":
                fn = mod.enclosing_function(node)
                qual = mod.functions.get(fn, "<module>")
                if qual not in captures:
                    yield self.finding(
                        mod, node,
                        f"CUDA-graph capture in `{qual}` has no entry in "
                        f"programs.py CAPTURE_SITES")
            elif (_callee_name(node) == "_device" and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and node.args[0].value not in DEVICE_KINDS):
                yield self.finding(
                    mod, node,
                    f"device call of kind {node.args[0].value!r} names no "
                    f"program in programs.py DEVICE_KINDS")


class UnregisteredKernel(Rule):
    """An extension launch outside a counted, census-named wrapper.

    Every hand-written kernel launches through a wrapper that adds one
    to its ``.launches`` and that the audit's kernel census names
    (``programs.KERNEL_CENSUS``): that count is how ``chip_smoke.py``
    proves a path ran its kernels, and how the lock pins the launches
    of each step program.  A launch outside one is invisible to both.
    """

    name = "unregistered-kernel"
    summary = ("extension launch (_build.launcher(...)) outside a "
               "wrapper that counts .launches and the kernel census names")

    def check(self, mod: Module):
        if not _in_scope(mod, KERNEL_SCOPE_PREFIXES, "kernel-module"):
            return
        from .programs import KERNEL_CENSUS

        def counts(fn) -> bool:
            return any(isinstance(n, ast.AugAssign)
                       and isinstance(n.target, ast.Attribute)
                       and n.target.attr == "launches"
                       for n in ast.walk(fn))

        by_name: dict[str, list] = {}
        for fn in mod.functions:
            by_name.setdefault(fn.name, []).append(fn)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Call)
                    and _callee_name(node.func) == "launcher"):
                continue
            fn = mod.enclosing_function(node)
            if fn is None:
                yield self.finding(mod, node, "kernel launch at module "
                                              "level, in no wrapper")
                continue
            if fn.name in KERNEL_CENSUS:
                wrappers = [fn]
            else:  # a launch helper: its callers are the wrappers
                wrappers = [mod.enclosing_function(c)
                            for c in ast.walk(mod.tree)
                            if isinstance(c, ast.Call)
                            and _callee_name(c) == fn.name]
                if not wrappers and counts(fn):
                    wrappers = [fn]
            if not wrappers or None in wrappers:
                yield self.finding(
                    mod, node,
                    f"`{fn.name}` launches a kernel but no census wrapper "
                    f"calls it")
                continue
            for w in wrappers:
                if w.name not in KERNEL_CENSUS:
                    yield self.finding(
                        mod, node,
                        f"kernel launched from `{w.name}`, which the "
                        f"audit's kernel census (programs.KERNEL_CENSUS) "
                        f"does not name")
                elif not (counts(w) or counts(fn)):
                    yield self.finding(
                        mod, node,
                        f"`{w.name}` launches a kernel without counting "
                        f"it in .launches")


class ObsInHotPath(Rule):
    """An allocating telemetry call on a hot path.

    The recorder's ``span(...)`` and ``event(...)`` build a dict and a
    context manager a call: fine at admission or a recovery decision, a
    per-token allocation inside ``Engine.step`` or ``_run_decode``.  The
    allocation-free ``begin``/``end``/``count`` API
    (``tpudp_torch/obs/record.py``) is the one for those paths.
    """

    name = "obs-in-hot-path"
    summary = ("allocating obs recorder call (.span()/.event()) on a hot "
               "path — use begin()/end()/count()")

    def check(self, mod: Module):
        for fn in _hot_functions(mod):
            for node in ordered_walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in OBS_ALLOC_METHODS):
                    yield self.finding(
                        mod, node,
                        f".{node.func.attr}() allocates per call on the "
                        f"`{fn.name}` hot path — record through begin()/"
                        f"end()/count(), or move it off the path")


RULES = [
    CaptureNondeterminism(),
    CaptureBranch(),
    HostSync(),
    UseAfterReplay(),
    DivergentCollective(),
    UnorderedIteration(),
    UnregisteredProgram(),
    UnregisteredKernel(),
    ObsInHotPath(),
]

RULES_BY_NAME = {r.name: r for r in RULES}
