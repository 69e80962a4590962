"""The cross-rank protocol verifier and the model checkers — the port of
``tpudp/analysis/protocol.py``: statically prove rank-uniform collective
sequences through the port's multi-process modules.

A fault that only one rank sees, or a per-rank fact (a filesystem
listing, a clock, the rank itself) that decides whether a rank enters a
rendezvous, leaves its peers parked in a collective forever.  The hazard
is path-shaped — the probe lives in one function, the collective in
another — so the verifier has three ingredients:

  * an **interprocedural call graph** over the multi-process modules
    (:data:`PROTOCOL_MODULES`), summarizing per function whether it
    transitively issues a rendezvous (``has_collectives``) and whether
    its return value is a per-rank fact (``host_local_return`` — e.g.
    ``latest_step_dir`` returns a filesystem listing);
  * **bounded path enumeration** per function (``cfg.py``): every
    acyclic path records its ordered collective sites and the branch
    decisions that led there, and at every branch whose predicate is
    *host-local* the verifier compares the collective sequences of the
    arms — they must be identical, because ranks may take different
    arms;
  * **bounded model checkers**: the vote/park machine of
    ``tpudp_torch/resilience.py`` (:class:`VoteSpec` /
    :func:`explore_vote_machine`) and the migration handshake of
    ``tpudp_torch/serve/disagg.py`` (:class:`MigrationSpec` /
    :func:`explore_migration_machine`), each spec extracted from the
    live source.

A rendezvous is a ``torch.distributed`` collective (``all_reduce``,
``all_gather``, ``all_gather_object``, ``broadcast``, ``barrier``,
``gather``, ``scatter``, ``reduce_scatter`` and their ``_tensor`` forms)
or one of the repo's helpers the port kept under JAX's names
(``all_hosts_ok``, ``gather_host_values``, ``gather_host_blobs``,
``coordinated_any``, ``_vote``, ...), all matched by terminal name.
Rank-uniform predicates — vote and gather results,
``torch.distributed.get_world_size()``, static config, arguments,
constants — are never compared.  Host-local ones are filesystem probes,
clocks, RNG, ``torch.distributed.get_rank()``, exception occurrence,
and anything data-flow tainted by those.  Findings anchor at a concrete
collective site (or the early ``return``/``raise``), so the
``# tpudp: lint-ok(rule)`` suppressions apply; a suppression naming a
protocol rule that matches nothing is reported.

Pure stdlib: it imports neither torch nor jax.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from collections import deque

from .cfg import MAX_PATHS as _MAX_PATHS
from .cfg import MAX_SEQ as _MAX_SEQ
from .cfg import PathEnumerator
from .core import (PROTOCOL_MODULES, PROTOCOL_RULE_NAMES, Finding,
                   Module, iter_python_files)

#: Rendezvous calls, matched by terminal name: torch.distributed's
#: collectives and the repo's cross-rank helpers (JAX's names).  Fixture
#: files opt into the verifier's scope with a ``# tpudp:
#: protocol-module`` marker in their first lines.
COLLECTIVE_HELPERS = {
    "all_reduce", "all_gather", "all_gather_object", "broadcast",
    "barrier", "gather", "scatter", "reduce_scatter",
    "all_gather_into_tensor", "reduce_scatter_tensor",
    "gather_host_values", "gather_host_blobs", "all_hosts_ok",
    "coordinated_any", "commit_after_all_hosts",
    "verify_across_processes", "_vote", "_coordinated_recover",
}

#: Calls whose RESULT is rank-uniform by construction, whatever per-rank
#: facts fed them — the sanctioned way to turn a local fact into a
#: collective decision.  Classification stops descending here.
UNIFORM_RESULT_CALLS = {
    "all_hosts_ok", "coordinated_any", "gather_host_values",
    "gather_host_blobs", "all_ranks_ok", "reduce_outcomes",
    "_vote", "_coordinated_recover", "_sdc_gather",
    "restore_emergency_voted", "restore_latest_verified",
    "verify_across_processes", "commit_after_all_hosts", "world_size",
    "_all_reduce",
}
UNIFORM_RESULT_DOTTED = {"torch.distributed.get_world_size",
                         "torch.distributed.is_initialized",
                         "torch.distributed.is_available"}

#: Host-local sources: calls/attribute probes whose value differs per
#: rank.  (`os.path.join` and friends are pure — only the probing subset
#: of `os` is listed.)
HOST_LOCAL_DOTTED = {
    "os.listdir", "os.scandir", "os.walk", "os.stat", "os.getpid",
    "os.urandom", "os.times", "open", "input",
    "torch.distributed.get_rank",
}
HOST_LOCAL_PREFIXES = ("time.", "random.", "numpy.random.", "socket.",
                       "uuid.", "secrets.", "glob.", "tempfile.")
HOST_LOCAL_ATTRS = {"get_rank", "exists", "isfile", "isdir",
                    "listdir", "scandir", "getmtime", "stat", "glob",
                    "iglob", "walk"}


def _terminal_name(func: ast.AST) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


@dataclasses.dataclass
class FnInfo:
    """Interprocedural summary for one function def."""

    mod: Module
    fn: ast.AST
    qual: str
    has_collectives: bool = False
    host_local_return: str | None = None  # reason, or None
    taint: dict | None = None  # cached AFTER the summary fixpoint


class ModuleSet:
    """The analyzed modules plus the cross-module function index and
    fixpoint summaries."""

    def __init__(self, modules: list[Module]):
        self.modules = modules
        self.infos: dict[int, FnInfo] = {}
        self.by_name: dict[str, list[FnInfo]] = {}
        self.by_qual: dict[tuple[str, str], FnInfo] = {}
        self._summaries_final = False
        for mod in modules:
            for fn, qual in mod.functions.items():
                info = FnInfo(mod, fn, qual)
                self.infos[id(fn)] = info
                self.by_name.setdefault(fn.name, []).append(info)
                self.by_qual[(mod.rel, qual)] = info
        self._summarize()
        self._summaries_final = True

    # -- call resolution ------------------------------------------------

    def resolve(self, mod: Module, caller_qual: str,
                call: ast.Call) -> list[FnInfo]:
        """Candidate callee summaries for a call.  ``self.m()`` resolves
        within the caller's class; a bare name prefers same-module defs;
        an attribute call on an arbitrary object resolves by terminal
        name only when unambiguous across the module set."""
        name = _terminal_name(call.func)
        if name is None:
            return []
        if isinstance(call.func, ast.Attribute):
            # only `self.m()` resolves through an attribute — methods
            # on arbitrary objects would have to match by terminal name
            # alone, which is both unsound (`it.close()` is not
            # `AsyncCheckpointWriter.close`) and unstable across
            # analyzed-file sets
            if (isinstance(call.func.value, ast.Name)
                    and call.func.value.id == "self"
                    and "." in caller_qual):
                cls_prefix = caller_qual.rsplit(".", 1)[0]
                hit = self.by_qual.get((mod.rel, f"{cls_prefix}.{name}"))
                if hit is not None:
                    return [hit]
            return []
        cands = self.by_name.get(name, [])
        local = [c for c in cands if c.mod is mod]
        if local:
            return local
        if len(cands) == 1:
            return cands
        # ambiguous cross-module bare name: only trust a UNANIMOUS
        # summary
        if cands and all(c.has_collectives for c in cands):
            return cands[:1]
        return []

    # -- site / predicate classification --------------------------------

    def site_label(self, mod: Module, caller_qual: str,
                   call: ast.Call) -> str | None:
        """Non-None when the call is a cross-host rendezvous: the token
        that enters the path's collective sequence."""
        name = _terminal_name(call.func)
        if name in COLLECTIVE_HELPERS:
            return name
        for info in self.resolve(mod, caller_qual, call):
            if info.has_collectives:
                return f"->{name}"
        return None

    def host_local_reason(self, mod: Module, caller_qual: str, expr,
                          tainted: dict[str, str]) -> str | None:
        """Why ``expr`` evaluates through per-host state, or None.
        Descends the expression; a uniform-result call is a hard stop
        (its arguments may be per-host — that is its purpose)."""
        if expr is None or isinstance(expr, ast.Constant):
            return None
        if isinstance(expr, ast.Call):
            dotted = mod.dotted(expr.func)
            name = _terminal_name(expr.func)
            if (name in UNIFORM_RESULT_CALLS
                    or dotted in UNIFORM_RESULT_DOTTED):
                return None
            if dotted in HOST_LOCAL_DOTTED:
                return f"{dotted}()"
            if dotted and any(dotted.startswith(p)
                              for p in HOST_LOCAL_PREFIXES):
                return f"{dotted}()"
            if (isinstance(expr.func, ast.Attribute)
                    and expr.func.attr in HOST_LOCAL_ATTRS):
                return f".{expr.func.attr}()"
            for info in self.resolve(mod, caller_qual, expr):
                if info.host_local_return:
                    return (f"{name}() returns a per-host fact "
                            f"({info.host_local_return})")
            parts = [*expr.args, *[kw.value for kw in expr.keywords]]
            if isinstance(expr.func, ast.Attribute):
                parts.append(expr.func.value)
            for p in parts:
                r = self.host_local_reason(mod, caller_qual, p, tainted)
                if r:
                    return r
            return None
        if isinstance(expr, (ast.Name, ast.Attribute)):
            dotted = mod.raw_dotted(expr)
            if dotted is not None:
                for t, reason in tainted.items():
                    if dotted == t or dotted.startswith(t + "."):
                        return f"`{t}` ({reason})"
                return None
        for child in ast.iter_child_nodes(expr):
            r = self.host_local_reason(mod, caller_qual, child, tainted)
            if r:
                return r
        return None

    def function_taint(self, mod: Module, info: FnInfo) -> dict[str, str]:
        """name -> reason for every local name data-flow tainted by a
        host-local source (monotone fixpoint; reassignment never clears
        — a name that EVER held per-host state stays suspect, the
        conservative direction for a rendezvous check).

        Cached per function once the summary fixpoint settled (the
        taint depends on callee summaries, which only grow DURING
        :meth:`_summarize`; afterwards the ASTs are immutable) — the
        watcher polls verify_paths, so the repeated whole-AST fixpoints
        are worth skipping."""
        if info.taint is not None:
            return info.taint
        tainted: dict[str, str] = {}

        def taint_targets(targets, value, reason_prefix=""):
            if value is None:
                return False
            reason = self.host_local_reason(mod, info.qual, value, tainted)
            if not reason:
                return False
            reason = reason_prefix + reason
            hit = False
            flat = []
            for t in targets:
                flat.extend(t.elts if isinstance(
                    t, (ast.Tuple, ast.List)) else [t])
            for t in flat:
                dotted = mod.raw_dotted(t)
                if dotted is not None and dotted not in tainted:
                    tainted[dotted] = reason
                    hit = True
            return hit

        changed = True
        while changed:
            changed = False
            for node in ast.walk(info.fn):
                if isinstance(node, ast.Assign):
                    changed |= taint_targets(node.targets, node.value)
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                    changed |= taint_targets([node.target], node.value)
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    # iterating a per-host iterable binds per-host items
                    # (`for name in os.listdir(root)` taints `name`)
                    changed |= taint_targets(
                        [node.target], node.iter,
                        reason_prefix="iterated from ")
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        if item.optional_vars is not None:
                            changed |= taint_targets(
                                [item.optional_vars], item.context_expr)
        if self._summaries_final:
            info.taint = tainted
        return tainted

    # -- fixpoint summaries ---------------------------------------------

    def _summarize(self) -> None:
        changed = True
        while changed:
            changed = False
            for info in self.infos.values():
                if not info.has_collectives:
                    for node in ast.walk(info.fn):
                        if isinstance(node, ast.Call) and self.site_label(
                                info.mod, info.qual, node) is not None:
                            info.has_collectives = True
                            changed = True
                            break
                if info.host_local_return is None:
                    r = self._returns_host_local(info)
                    if r:
                        info.host_local_return = r
                        changed = True

    def _returns_host_local(self, info: FnInfo) -> str | None:
        tainted = self.function_taint(info.mod, info)
        for node in ast.walk(info.fn):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            if info.mod.enclosing_function(node) is not info.fn:
                continue
            r = self.host_local_reason(info.mod, info.qual, node.value,
                                       tainted)
            if r:
                return r
            # control-sensitivity: a return under a host-local branch
            # returns a per-host fact even when its value is clean
            # (`if not os.path.isdir(p): return None`)
            cur = info.mod.parents.get(node)
            while cur is not None and cur is not info.fn:
                if isinstance(cur, (ast.If, ast.While)):
                    r = self.host_local_reason(info.mod, info.qual,
                                               cur.test, tainted)
                    if r:
                        return f"returned under a branch on {r}"
                cur = info.mod.parents.get(cur)
        return None


# -- the path-sensitive divergence check --------------------------------


def _label_seq(enum, seq):
    return tuple(enum.sites[s].label for s in seq)


def _seqset(enum, entries):
    # compare SETS of LABEL sequences: two paths through one arm with
    # the same rendezvous sequence are one behavior, not two — and two
    # ARMS spelling the identical collective sequence at different call
    # sites (`gather(1)` vs `gather(2)`) rendezvous identically, so
    # they must compare equal (site indices are per-node and would
    # always differ)
    return tuple(sorted({_label_seq(enum, e[0]) for e in entries}))


def _verify_function(modset: ModuleSet, mod: Module,
                     info: FnInfo) -> tuple[list[Finding], bool]:
    """(findings, truncated) — ``truncated`` is True when path or
    sequence bounds were hit and coverage is therefore partial."""
    if not info.has_collectives:
        return [], False
    tainted = modset.function_taint(mod, info)

    def site_label(call):
        return modset.site_label(mod, info.qual, call)

    def classify(expr):
        r = modset.host_local_reason(mod, info.qual, expr, tainted)
        return ("host-local", r) if r else ("uniform", "")

    enum = PathEnumerator(site_label, classify)
    paths = enum.run(info.fn)
    findings: list[Finding] = []
    seen: set[tuple] = set()
    for guard in enum.guards:
        if guard.cls != "host-local":
            continue
        # partition paths that reached this guard by their decision
        # prefix (identical prefix => identical collective prefix), then
        # compare the arms' downstream sequences
        groups: dict[tuple, dict[int, list]] = {}
        for p in paths:
            for i, (gid, arm) in enumerate(p.decisions):
                if gid == guard.gid:
                    groups.setdefault(p.decisions[:i], {}).setdefault(
                        arm, []).append((p.seq, p.exit, p.exit_node))
                    break
        for buckets in groups.values():
            arms = sorted(buckets)
            # ALL pairs, not each-vs-first: two handler arms can
            # rendezvous in different orders while each diverges from
            # the normal path only at an already-reviewed site
            for i, arm_a in enumerate(arms):
                for arm_b in arms[i + 1:]:
                    findings.extend(_diverging_arms(
                        mod, enum, guard, buckets[arm_a],
                        buckets[arm_b], seen))
    return findings, enum.truncated


def _first_site(enum, entries, labels):
    """The EXECUTION-ORDER-first concrete call node across ``entries``
    whose label is in ``labels`` (site indices follow discovery order,
    which follows statement order) — findings anchor where the
    divergence first bites, not at an alphabetically arbitrary label."""
    best = None
    for seq, _, _ in entries:
        for idx in seq:
            if enum.sites[idx].label in labels:
                if best is None or idx < best:
                    best = idx
    return enum.sites[best] if best is not None else None


def _diverging_arms(mod, enum, guard, a, b, seen):
    if _seqset(enum, a) == _seqset(enum, b):
        return []
    labels_a = {lab for seq, _, _ in a for lab in _label_seq(enum, seq)}
    labels_b = {lab for seq, _, _ in b for lab in _label_seq(enum, seq)}

    def mk(rule, node, detail):
        key = (rule, getattr(node, "lineno", 1))
        if key in seen:
            return []
        # the suppression check lives HERE, not post-hoc: a suppressed
        # anchor absorbs ITS divergence (and marks the suppression
        # used) while other divergent sequence pairs at the same guard
        # keep their own anchors — a reviewed single-host arm must not
        # bury an unreviewed swap in a sibling arm
        if mod.suppressions.allows(getattr(node, "lineno", 1), rule):
            seen.add(key)
            return []
        seen.add(key)
        where = (f"branch at line {guard.line} "
                 f"({guard.reason or 'per-host state'})")
        return [Finding(rule, mod.rel, getattr(node, "lineno", 1),
                        getattr(node, "col_offset", 0),
                        f"{detail} — {where}; every host must issue the "
                        f"same ordered collective sequence, or guard the "
                        f"divergence with a host-uniform predicate "
                        f"(vote/allgather result)")]

    if guard.kind == "loop":
        extra = ((labels_a | labels_b) - (labels_a & labels_b)) \
            or (labels_a | labels_b)
        anchor = _first_site(enum, a + b, extra)
        return mk("protocol-divergent-loop", anchor.node,
                  f"collective `{anchor.label}` inside a loop whose "
                  f"trip count is host-local: hosts iterating different "
                  f"counts issue different rendezvous sequences")
    if labels_a != labels_b and (labels_a <= labels_b
                                 or labels_b <= labels_a):
        small, big = (a, b) if labels_a <= labels_b else (b, a)
        missing = (labels_b - labels_a) or (labels_a - labels_b)
        anchor = _first_site(enum, big, missing)
        exits = {e for _, e, _ in small}
        if exits and exits <= {"return", "raise"}:
            exit_node = next(n for _, e, n in small
                             if e in ("return", "raise") and n is not None)
            # anchor at the exit only when it sits inside the guarded
            # region — a path that merely BYPASSES the arm may exit far
            # away, and the suppressible decision is the guard itself
            g0 = guard.line
            g1 = getattr(guard.node, "end_lineno", g0)
            exit_line = getattr(exit_node, "lineno", 0)
            where_node = exit_node if g0 <= exit_line <= g1 else guard.node
            return mk("protocol-early-exit", where_node,
                      f"early {'/'.join(sorted(exits))} skips collective "
                      f"`{anchor.label}` (line {anchor.line}) that the "
                      f"fall-through path still issues: a peer taking the "
                      f"other arm parks alone in the rendezvous")
        return mk("protocol-divergent-entry", anchor.node,
                  f"collective `{anchor.label}` is issued on one arm of a "
                  f"host-local branch and never on the other: entry into "
                  f"the rendezvous is decided per-host")
    # both arms issue collectives, but the sequences differ: each
    # sequence one arm can produce and the other cannot is its own
    # candidate divergence, anchored at the first site where it departs
    # from the other arm's closest behavior — so one reviewed
    # (suppressed) divergent pair does not mask an unreviewed one
    uniq_a = {}
    for seq, _, _ in a:
        uniq_a.setdefault(_label_seq(enum, seq), seq)
    uniq_b = {}
    for seq, _, _ in b:
        uniq_b.setdefault(_label_seq(enum, seq), seq)
    only_a = sorted(k for k in uniq_a if k not in uniq_b)
    only_b = sorted(k for k in uniq_b if k not in uniq_a)
    # pair unmatched behaviors one-to-one (each pair is ONE divergence
    # fact with ONE anchor — so a reviewed pair's suppression absorbs
    # exactly that pair, while an unreviewed swap in a sibling pair
    # keeps its own anchor); when one side has no unmatched behavior,
    # pair against its closest (minimal) behavior instead
    pairs = []
    if only_a and only_b:
        for la, lb in zip(only_a, only_b):
            pairs.append((la, uniq_a[la], lb, uniq_b[lb], "b"))
        # surplus behaviors on either side are witnessed by the zipped
        # pairs above (the arms already provably diverge)
    elif only_a:
        ref = min(uniq_b)
        for la in only_a:
            pairs.append((la, uniq_a[la], ref, uniq_b[ref], "a"))
    else:
        ref = min(uniq_a)
        for lb in only_b:
            pairs.append((ref, uniq_a[ref], lb, uniq_b[lb], "b"))
    out = []
    for la, ia, lb, ib, prefer in pairs:
        anchor = None
        for i in range(max(len(la), len(lb))):
            ta = la[i] if i < len(la) else None
            tb = lb[i] if i < len(lb) else None
            if ta != tb:
                cand = []
                if prefer == "b":
                    cand = [(ib, i, len(lb)), (ia, i, len(la))]
                else:
                    cand = [(ia, i, len(la)), (ib, i, len(lb))]
                for iseq, pos, n in cand:
                    if pos < n:
                        anchor = enum.sites[iseq[pos]]
                        break
                break
        if anchor is None:
            idxs = ib or ia
            anchor = enum.sites[idxs[0]] if idxs else _first_site(
                enum, a + b, labels_a | labels_b)
        out.extend(mk(
            "protocol-order-divergence", anchor.node,
            f"collective order diverges across the arms of a "
            f"host-local branch ({list(la)} vs {list(lb)}): hosts "
            f"taking different arms rendezvous in different orders "
            f"and deadlock"))
    return out


def verify_paths(paths: list[str], root: str,
                 report_useless: bool = True):
    """Run the protocol verifier over every .py under ``paths`` that is
    in scope (PROTOCOL_MODULES, or carries a ``# tpudp:
    protocol-module`` marker).  Returns ``(findings, errors)`` as JAX's
    ``verify_paths`` does — suppressed hits removed, plus a
    ``useless-suppression`` finding for every suppression naming a
    protocol rule that matched nothing."""
    from .core import in_protocol_scope

    modules: list[Module] = []
    errors: list[str] = []
    for path, rel in iter_python_files(paths, root):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            if not in_protocol_scope(rel, _head_markers(source)):
                continue
            modules.append(Module(path, rel, source))
        except (SyntaxError, UnicodeDecodeError) as exc:
            errors.append(f"{rel}: parse failed: {exc}")
    modset = ModuleSet(modules)
    findings: list[Finding] = []
    for mod in modules:
        for fn in mod.functions:
            info = modset.infos[id(fn)]
            # suppression filtering happened inside the comparison
            # (mk's in-check absorption), so these are final
            fn_findings, truncated = _verify_function(modset, mod, info)
            findings.extend(fn_findings)
            if truncated:
                # silent under-coverage must be visible: a truncated
                # function fails the gate like a parse error does
                errors.append(
                    f"{mod.rel}: `{info.qual}` exceeded the path/"
                    f"sequence bounds (MAX_PATHS={_MAX_PATHS}, "
                    f"MAX_SEQ={_MAX_SEQ}) — protocol verification of "
                    f"it is incomplete; split the function or raise "
                    f"the bounds")
        if report_useless:
            for line, rule_name in mod.suppressions.unused():
                if rule_name in PROTOCOL_RULE_NAMES:
                    findings.append(Finding(
                        "useless-suppression", mod.rel, line, 0,
                        f"lint-ok({rule_name}) suppresses nothing — "
                        f"remove it (or the protocol divergence it "
                        f"excused is gone)"))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, errors


def _head_markers(source: str) -> set[str]:
    """Markers in the first 5 lines, extracted with EXACTLY the same
    machinery as ``Module.markers`` (real comment tokens + MARKER_RE),
    so a marker spelled with trailing text is in scope too."""
    from .core import MARKER_RE, comment_tokens

    head = "\n".join(source.splitlines()[:5])
    return {m.group(1)
            for _line, text in comment_tokens(head).items()
            for m in [MARKER_RE.search(text)] if m}


# -- the vote/park state-machine model checker --------------------------

OK, FAULT = 0, 1

RUN, VOTE, PARK, DONE, CRASH, TEXIT = "run", "vote", "park", "done", \
    "crash", "texit"
TERMINAL = {DONE, CRASH, TEXIT}


@dataclasses.dataclass(frozen=True)
class VoteSpec:
    """The agreed-action protocol as a checkable spec.

    ``completion_park``: a host that finishes cleanly parks at a
    completion vote (joins every later round) instead of exiting —
    the fix for the late-faulter-with-no-partner deadlock.
    ``bounded_timeout``: a vote that can never complete (peer crashed
    or departed) hard-exits (VOTE_TIMEOUT_EXIT) instead of waiting
    forever.  Both are extracted from the live source by
    :func:`extract_vote_spec`."""

    n_hosts: int = 2
    max_faults: int = 1
    max_crashes: int = 1
    completion_park: bool = True
    bounded_timeout: bool = True


def explore_vote_machine(spec: VoteSpec) -> dict:
    """Exhaustive BFS over bounded host interleavings.  Returns
    ``{"states": n, "violations": [...]}`` where each violation is
    ``{"kind": "deadlock" | "spurious-timeout", "state": ...}`` —
    deadlock = a non-final state with no enabled transition;
    spurious-timeout = a healthy pod (zero crashes so far) losing a
    host to the vote timeout, i.e. the protocol itself stranded a
    live voter."""
    # host state: (RUN, faults_left, rounds) | (VOTE, rounds+1) |
    # (PARK, rounds+1) | terminal markers
    init = tuple((RUN, spec.max_faults, 0) for _ in range(spec.n_hosts))
    queue = deque([(init, 0)])
    seen = {(init, 0)}
    violations = []

    def waiting(h):
        return h[0] in (VOTE, PARK)

    while queue:
        state, crashes = queue.popleft()
        nexts = []
        # joint vote resolution: the allgather answers only when EVERY
        # configured host is waiting at the same seq — a crashed or
        # departed (done-without-park) peer never answers, and the
        # survivors' only way out is the bounded timeout
        if all(waiting(h) for h in state):
            seqs = {h[1] for h in state}
            if len(seqs) == 1:
                worst = FAULT if any(h[0] == VOTE for h in state) else OK
                new = []
                for h in state:
                    if h[0] == VOTE:
                        new.append((RUN, h[2], h[1]))
                    elif h[0] == PARK:
                        new.append((RUN, h[2], h[1]) if worst == FAULT
                                   else (DONE,))
                    else:
                        new.append(h)
                nexts.append((tuple(new), crashes))
        for i, h in enumerate(state):
            if h[0] == RUN:
                _, faults, rounds = h
                if faults > 0:  # a fault: call a vote round
                    nexts.append((_swap(state, i,
                                        (VOTE, rounds + 1, faults - 1)),
                                  crashes))
                # clean finish
                fin = (PARK, rounds + 1, faults) if spec.completion_park \
                    else (DONE,)
                nexts.append((_swap(state, i, fin), crashes))
            if h[0] not in TERMINAL and crashes < spec.max_crashes:
                nexts.append((_swap(state, i, (CRASH,)), crashes + 1))
            if waiting(h) and spec.bounded_timeout:
                # the timeout only FIRES when the vote can never
                # complete: some peer is terminal (crashed, exited, or
                # done-without-parking)
                if any(p[0] in TERMINAL for j, p in enumerate(state)
                       if j != i):
                    nexts.append((_swap(state, i, (TEXIT,)), crashes))
                    if crashes == 0:
                        violations.append({
                            "kind": "spurious-timeout",
                            "state": _render(state),
                            "detail": f"host {i} times out of a vote "
                                      f"with every peer alive — a "
                                      f"healthy pod loses a host"})
        if not nexts and any(h[0] not in TERMINAL for h in state):
            violations.append({
                "kind": "deadlock", "state": _render(state),
                "detail": "live hosts wait at a rendezvous no peer "
                          "will ever join"})
        for n in nexts:
            if n not in seen:
                seen.add(n)
                queue.append(n)
    return {"states": len(seen), "violations": violations}


def _swap(state, i, h):
    return state[:i] + (h,) + state[i + 1:]


def _render(state):
    return tuple("/".join(str(x) for x in h) for h in state)


def extract_vote_spec(source: str, *, n_hosts: int = 2,
                      max_faults: int = 2,
                      max_crashes: int = 1) -> VoteSpec:
    """Extract the protocol's two load-bearing properties from the live
    ``tpudp_torch/resilience.py`` source: does a clean finisher park at a
    completion vote (``self._vote(OUTCOME_OK)`` on ``Supervisor.run``'s
    success path), and is the vote wait bounded (``vote_timeout_s``
    plus a hard exit in ``Supervisor._vote``)?  The returned spec is
    what :func:`explore_vote_machine` proves deadlock-free — so
    deleting either property from the source is caught by the model
    checker, not just by review."""
    tree = ast.parse(source)
    completion_park = False
    defs = {node.name: node for node in ast.walk(tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}
    if "run" in defs:
        for call in ast.walk(defs["run"]):
            if (isinstance(call, ast.Call)
                    and _terminal_name(call.func) == "_vote"
                    and call.args
                    and isinstance(call.args[0], ast.Name)
                    and call.args[0].id == "OUTCOME_OK"):
                completion_park = True
    # The vote's wait: `_vote` and the module's functions it calls (the
    # bounded gather it shares with the SDC check), transitively.
    body, todo = [], ["_vote"] if "_vote" in defs else []
    while todo:
        fn = defs[todo.pop()]
        body.append(fn)
        for n in ast.walk(fn):
            name = (_terminal_name(n.func) if isinstance(n, ast.Call)
                    else None)
            if name in defs and defs[name] not in body \
                    and name not in todo:
                todo.append(name)
    nodes = [n for fn in body for n in ast.walk(fn)]
    has_timeout = any(
        isinstance(n, (ast.Name, ast.Attribute))
        and (getattr(n, "id", None) == "vote_timeout_s"
             or getattr(n, "attr", None) == "vote_timeout_s")
        for n in nodes)
    has_exit = any(isinstance(n, ast.Call) and _terminal_name(n.func) == "_exit"
                   for n in nodes)
    bounded_timeout = has_timeout and has_exit
    return VoteSpec(n_hosts=n_hosts, max_faults=max_faults,
                    max_crashes=max_crashes,
                    completion_park=completion_park,
                    bounded_timeout=bounded_timeout)


# -- the migration-handshake state-machine model checker ----------------

# Phases of one tpudp_torch/serve/disagg.py migration round, in rendezvous
# order.  OFFER/TRANSFER/ACK/SEAL are collective barriers every live
# host joins; ADOPT is the receiver-local work between TRANSFER and
# ACK where a corrupt payload is discovered.
OFFER, TRANSFER, ADOPT, ACK, SEAL = ("offer", "transfer", "adopt",
                                     "ack", "seal")


@dataclasses.dataclass(frozen=True)
class MigrationSpec:
    """The offer → transfer → adopt-ack → release handshake as a
    checkable spec.

    ``quarantine_acks``: a receiver that unpacks a corrupt or torn
    transfer quarantines it and STILL joins the ack gather (nacking
    the ticket) instead of leaving the round — without it the sender
    parks alone at phase 3.  ``release_on_ack``: the sender resolves
    its pending tickets only after the ack gather, so staged state is
    released exactly once per outcome.  ``fallback_local``: a ticket
    that exhausts its retries is re-admitted LOCALLY, so a dead link
    degrades to a pressure-vacate resume instead of wedging the
    request and leaking its staged pages.  All three are extracted
    from the live ``tpudp_torch/serve/disagg.py`` source by
    :func:`extract_migration_spec`."""

    n_transfers: int = 2
    max_faults: int = 2
    max_retries: int = 1
    quarantine_acks: bool = True
    release_on_ack: bool = True
    fallback_local: bool = True


def explore_migration_machine(spec: MigrationSpec) -> dict:
    """Exhaustive BFS over one sender/receiver pair driving
    ``n_transfers`` tickets through migration rounds, with up to
    ``max_faults`` adversarial transfer corruptions injected at any
    round.  Returns ``{"states": n, "violations": [...]}`` where each
    violation is one of:

      * ``orphaned-rendezvous`` — one host leaves a round while its
        peer is still committed to a later barrier of the SAME round
        (the sender parks alone at the ack gather forever);
      * ``wedge`` — a ticket that can never resolve: retries
        exhausted, no local fallback, so the round loop never reaches
        the joint ``done`` decision;
      * ``page-leak`` — the run completes but staged sender state was
        never released.

    State: (tickets_left, attempts, faults_left, staged).  Rounds are
    lock-step (every barrier is a collective), so the only
    nondeterminism is the adversary's corrupt/clean choice per round —
    the bounded space is explored exhaustively."""
    init = (spec.n_transfers, 0, spec.max_faults, 0)
    queue = deque([init])
    seen = {init}
    violations = []

    def viol(kind, state, detail):
        violations.append({"kind": kind, "state": state,
                           "detail": detail})

    while queue:
        state = queue.popleft()
        tickets, attempts, faults, staged = state
        if tickets == 0:
            if staged:
                viol("page-leak", state,
                     f"{staged} staged page(s) never released after "
                     f"the final round — export leaked on the sender")
            continue
        nexts = []
        # adversary choice per round: deliver clean, or corrupt the
        # payload (while it still has faults in budget)
        for corrupt in ((False, True) if faults > 0 else (False,)):
            if not corrupt:
                # clean delivery: receiver adopts, acks ok; sender
                # releases on the ack (or keeps the staged state
                # forever if release_on_ack was deleted)
                new_staged = 0 if spec.release_on_ack else staged + 1
                nexts.append((tickets - 1, 0, faults, new_staged))
                continue
            nfaults = faults - 1
            if not spec.quarantine_acks:
                # receiver bails out of the round between TRANSFER and
                # ACK; the sender is already committed to the ack
                # gather and parks alone — terminal
                viol("orphaned-rendezvous", state,
                     "receiver exits the round on a corrupt transfer; "
                     "sender parks alone at the ack gather (phase "
                     f"{ACK!r} of the same round)")
                continue
            # quarantined: nack comes back on the ack gather
            if attempts < spec.max_retries:
                nexts.append((tickets, attempts + 1, nfaults, staged))
            elif spec.fallback_local:
                # retries exhausted: local re-admission resolves the
                # ticket (as failed) and releases the staged state
                nexts.append((tickets - 1, 0, nfaults,
                              0 if spec.release_on_ack else staged + 1))
            else:
                # no retry budget, no fallback: the ticket re-enters
                # the outbox forever and the joint done vote never
                # fires — terminal
                viol("wedge", state,
                     f"ticket out of retries with no local fallback — "
                     f"the round loop never reaches the joint "
                     f"{SEAL!r} with done=1")
        for n in nexts:
            if n not in seen:
                seen.add(n)
                queue.append(n)
    return {"states": len(seen), "violations": violations}


def extract_migration_spec(source: str, *, n_transfers: int = 2,
                           max_faults: int = 2,
                           max_retries: int = 1) -> MigrationSpec:
    """Extract the handshake's three load-bearing properties from the
    live ``tpudp_torch/serve/disagg.py`` source: does ``DisaggHost.round``'s
    ``TransferCorrupt`` handler stay in the round (no ``return`` /
    ``raise`` — it must still reach the ack gather), does ``round``
    resolve pending tickets via ``release_acks`` only AFTER the ack
    gather (the last ``gather_host_blobs``), and does ``release_acks``
    fall back to local ``admit_ticket`` when a ticket dies?  The
    returned spec is what :func:`explore_migration_machine` proves
    orphan/wedge/leak-free — deleting any property from the source is
    caught by the model checker, not just by review."""
    tree = ast.parse(source)
    quarantine_acks = False
    release_on_ack = False
    fallback_local = False
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name == "round":
            for handler in (h for n in ast.walk(node)
                            if isinstance(n, ast.Try)
                            for h in n.handlers):
                if (_terminal_name(handler.type) != "TransferCorrupt"):
                    continue
                leaves = any(isinstance(n, (ast.Return, ast.Raise))
                             for b in handler.body for n in ast.walk(b))
                quarantine_acks = not leaves
            gathers = [n.lineno for n in ast.walk(node)
                       if isinstance(n, ast.Call)
                       and _terminal_name(n.func) == "gather_host_blobs"]
            releases = [n.lineno for n in ast.walk(node)
                        if isinstance(n, ast.Call)
                        and _terminal_name(n.func) == "release_acks"]
            release_on_ack = bool(gathers and releases
                                  and min(releases) > max(gathers))
        if node.name == "release_acks":
            fallback_local = any(
                isinstance(n, ast.Call)
                and _terminal_name(n.func) == "admit_ticket"
                for n in ast.walk(node))
    return MigrationSpec(n_transfers=n_transfers, max_faults=max_faults,
                         max_retries=max_retries,
                         quarantine_acks=quarantine_acks,
                         release_on_ack=release_on_ack,
                         fallback_local=fallback_local)
