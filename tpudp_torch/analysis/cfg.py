"""Bounded path enumeration over function ASTs — the control-flow
substrate of the protocol verifier (``protocol.py``), the port's copy of
``tpudp/analysis/cfg.py``.

Python functions are structured (no goto), so instead of a generic
basic-block CFG this enumerates *paths* directly from the AST: every
acyclic route through a function body, each recording

  * ``seq`` — the ordered collective *sites* the path issues (site = a
    call the caller classified as a cross-host rendezvous, directly or
    through an interprocedural summary),
  * ``decisions`` — the ordered ``(guard_id, arm)`` choices taken at
    every branch point (``if``/ternary, loop entry, ``except`` arm),
  * ``exit`` — how the path leaves the function (``fall``, ``return``,
    ``raise``), with the exiting statement for anchoring findings.

The verifier then partitions paths by their decision prefix and
compares collective sequences *across the arms of each guard* — the
path-sensitive generalization of the linter's lexical
divergent-collective rule.

Loop abstraction: every loop contributes a guard with two arms — zero
iterations or exactly one (``while True`` only the one).  This is the
abstraction that makes enumeration finite; it is deliberately lenient
(hosts that iterate the *same* number of times always compare equal)
and still catches the class that matters: a loop whose trip count is
host-local and whose body holds a rendezvous.

Exception abstraction: each ``except`` arm is a guard alternative
entered with *none* of the try body executed (the earliest-raise
approximation).  A handler whose entire body is a bare ``raise`` is
transparent — re-raising is propagation, not a protocol decision.

Pure stdlib: it imports neither torch nor jax.
"""

from __future__ import annotations

import ast
import dataclasses

#: Path-explosion bounds.  On overflow enumeration stops adding new
#: alternatives (keeps the first arms); the verifier reports the
#: function as truncated so silent under-coverage is visible.
MAX_PATHS = 2048
MAX_SEQ = 64


@dataclasses.dataclass(frozen=True)
class Site:
    """One collective call site."""

    index: int
    label: str
    node: ast.AST

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 1)


@dataclasses.dataclass(frozen=True)
class Guard:
    """One branch point: an ``if``/ternary test, a loop entry, or an
    ``except`` arm set.  ``kind`` is 'if' | 'loop' | 'except';
    ``cls``/``reason`` are the caller's host-uniformity classification
    of the predicate."""

    gid: int
    kind: str
    node: ast.AST
    cls: str      # 'uniform' | 'host-local'
    reason: str

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 1)


@dataclasses.dataclass(frozen=True)
class Path:
    seq: tuple            # of site indices, in issue order
    decisions: tuple      # of (gid, arm)
    exit: str             # 'fall' | 'return' | 'raise' | 'break' | 'continue'
    exit_node: ast.AST | None = None


class _Partial:
    __slots__ = ("seq", "decisions")

    def __init__(self, seq=(), decisions=()):
        self.seq = seq
        self.decisions = decisions

    def add_site(self, idx) -> bool:
        """False when the sequence bound was hit (site dropped) — the
        enumerator marks itself truncated so the caller can report the
        partial coverage instead of silently under-verifying."""
        if len(self.seq) < MAX_SEQ:
            self.seq = self.seq + (idx,)
            return True
        return False

    def fork(self, gid, arm):
        p = _Partial(self.seq, self.decisions + ((gid, arm),))
        return p

    def finish(self, exit_kind, node=None):
        return Path(self.seq, self.decisions, exit_kind, node)


class PathEnumerator:
    """Enumerate paths through one function.

    The caller provides two callbacks:

      * ``site_label(call_node) -> str | None`` — non-None when the
        call is a rendezvous (directly a collective, or a summary says
        the callee transitively issues one); the string is the sequence
        token.
      * ``classify(expr_node) -> (cls, reason)`` — host-uniformity of a
        branch predicate / loop iterable ('uniform' or 'host-local').
    """

    def __init__(self, site_label, classify):
        self._site_label = site_label
        self._classify = classify
        self.sites: list[Site] = []
        self.guards: list[Guard] = []
        self.truncated = False
        self._site_by_node: dict[int, int] = {}

    # -- construction ---------------------------------------------------

    def _site(self, node, label) -> int:
        key = id(node)
        if key not in self._site_by_node:
            self._site_by_node[key] = len(self.sites)
            self.sites.append(Site(len(self.sites), label, node))
        return self._site_by_node[key]

    def _guard(self, kind, node) -> Guard:
        cls, reason = ("uniform", "")
        if kind == "except":
            cls, reason = "host-local", "exception occurrence is per-host"
        else:
            test = node.test if isinstance(
                node, (ast.If, ast.IfExp, ast.While)) else getattr(
                    node, "iter", node)
            cls, reason = self._classify(test)
        g = Guard(len(self.guards), kind, node, cls, reason)
        self.guards.append(g)
        return g

    # -- expression scanning -------------------------------------------

    def _expr_sites(self, expr, partials):
        """Append the collective sites an expression issues, in source
        order, to every partial.  EVERY collective-bearing ternary
        forks (their arms are real control flow — one suffices to
        decide rendezvous entry per-host); everything else is scanned
        linearly."""
        if expr is None:
            return partials
        ternaries = [n for n in ast.walk(expr) if isinstance(n, ast.IfExp)
                     and self._has_site(n)]
        if not ternaries:
            self._scan_linear(expr, partials)
            return partials
        # outermost collective-bearing ternaries, in source order;
        # ones nested inside another are handled by the outer's arms
        all_inside = set()
        for t in ternaries:
            for sub in ast.walk(t):
                if sub is not t:
                    all_inside.add(id(sub))
        top = sorted((t for t in ternaries if id(t) not in all_inside),
                     key=lambda n: (n.lineno, n.col_offset))
        skip = set()
        for t in top:
            skip.update(map(id, ast.walk(t)))
        self._scan_linear(expr, partials, skip=skip)
        for t in top:
            partials = self._expr_sites(t.test, partials)
            guard = self._guard("if", t)
            out = []
            for arm, sub in ((0, t.body), (1, t.orelse)):
                forked = [p.fork(guard.gid, arm) for p in partials]
                out.extend(self._expr_sites(sub, forked))
            partials = self._cap(out)
        return partials

    def _has_site(self, expr) -> bool:
        return any(isinstance(n, ast.Call)
                   and self._site_label(n) is not None
                   for n in ast.walk(expr))

    def _scan_linear(self, expr, partials, skip=frozenset()):
        # EVALUATION order, not source order: arguments evaluate before
        # their call (`f(g(x))` issues g's rendezvous first), so sites
        # are emitted post-order.
        def visit(node):
            if id(node) in skip:
                return
            for child in ast.iter_child_nodes(node):
                visit(child)
            if isinstance(node, ast.Call):
                label = self._site_label(node)
                if label is not None:
                    idx = self._site(node, label)
                    for p in partials:
                        if not p.add_site(idx):
                            self.truncated = True

        visit(expr)

    def _cap(self, partials):
        if len(partials) > MAX_PATHS:
            self.truncated = True
            return partials[:MAX_PATHS]
        return partials

    # -- transparency ---------------------------------------------------

    def _walk_skip_defs(self, stmts):
        stack = list(stmts)
        while stack:
            n = stack.pop()
            yield n
            for c in ast.iter_child_nodes(n):
                if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                    continue
                stack.append(c)

    def _transparent(self, bodies, allow_break=False) -> bool:
        """A branch region with no rendezvous sites and no control-flow
        exits contributes nothing to any path's collective sequence —
        skipping the fork entirely keeps path counts linear in the
        number of RELEVANT branches (a 600-line CLI main would
        otherwise blow MAX_PATHS on branches the verifier does not care
        about).  ``allow_break``: break/continue are internal to a loop
        being tested as one unit, but inside an If's arms they redirect
        flow around later sites and must keep the fork."""
        for body in bodies:
            for n in self._walk_skip_defs(body):
                if isinstance(n, (ast.Return, ast.Raise)):
                    return False
                if not allow_break and isinstance(
                        n, (ast.Break, ast.Continue)):
                    return False
                if isinstance(n, ast.Call) \
                        and self._site_label(n) is not None:
                    return False
        return True

    # -- statement walk -------------------------------------------------

    def run(self, fn: ast.AST) -> list[Path]:
        finished, falling = self._block(fn.body, [_Partial()])
        return finished + [p.finish("fall") for p in falling]

    def _block(self, body, partials):
        finished = []
        cur = partials
        for stmt in body:
            if not cur:
                break
            done, cur = self._stmt(stmt, cur)
            finished.extend(done)
            cur = self._cap(cur)
        return finished, cur

    def _stmt(self, stmt, partials):
        """Returns (finished_paths, continuing_partials)."""
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return [], partials  # nested defs analyzed on their own
        if isinstance(stmt, ast.Return):
            partials = self._expr_sites(stmt.value, partials)
            return [p.finish("return", stmt) for p in partials], []
        if isinstance(stmt, ast.Raise):
            partials = self._expr_sites(stmt.exc, partials)
            return [p.finish("raise", stmt) for p in partials], []
        if isinstance(stmt, (ast.Break, ast.Continue)):
            kind = "break" if isinstance(stmt, ast.Break) else "continue"
            return [p.finish(kind, stmt) for p in partials], []
        if isinstance(stmt, ast.If):
            partials = self._expr_sites(stmt.test, partials)
            if self._transparent([stmt.body, stmt.orelse]):
                return [], partials  # no sites, no exits: nothing to fork
            guard = self._guard("if", stmt)
            finished, out = [], []
            for arm, body in ((0, stmt.body), (1, stmt.orelse)):
                forked = [p.fork(guard.gid, arm) for p in partials]
                if body:
                    done, cont = self._block(body, forked)
                    finished.extend(done)
                    out.extend(cont)
                else:
                    out.extend(forked)
            return finished, self._cap(out)
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            return self._loop(stmt, partials)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, partials)
        if isinstance(stmt, ast.Match):
            return self._match(stmt, partials)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                partials = self._expr_sites(item.context_expr, partials)
            return self._block(stmt.body, partials)
        # plain statement: scan its expressions for sites
        for field in ("value", "test", "exc"):
            sub = getattr(stmt, field, None)
            if isinstance(sub, ast.AST):
                partials = self._expr_sites(sub, partials)
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            pass  # value already scanned above
        elif isinstance(stmt, ast.Expr):
            pass
        return [], partials

    def _loop(self, stmt, partials):
        always = (isinstance(stmt, ast.While)
                  and isinstance(stmt.test, ast.Constant)
                  and bool(stmt.test.value))
        if isinstance(stmt, ast.While):
            partials = self._expr_sites(stmt.test, partials)
        else:
            partials = self._expr_sites(stmt.iter, partials)
        if self._transparent([stmt.body], allow_break=True):
            return [], partials  # site-free, exit-free loop body
        guard = self._guard("loop", stmt)
        finished, out = [], []
        arms = ((1, True),) if always else ((0, False), (1, True))
        for arm, enter in arms:
            forked = [p.fork(guard.gid, arm) for p in partials]
            if not enter:
                out.extend(forked)
                continue
            done, cont = self._block(stmt.body, forked)
            for path in done:
                if path.exit in ("break", "continue"):
                    # loop exits after this iteration (one-iteration
                    # abstraction): resume after the loop
                    out.append(_Partial(path.seq, path.decisions))
                else:
                    finished.append(path)
            out.extend(cont)  # body fell through -> loop exits
        return finished, self._cap(out)

    def _match(self, stmt, partials):
        """``match`` arms are a branch on the subject, same as an If —
        collectives under case arms must be visible (silent
        under-coverage is this module's cardinal sin)."""
        partials = self._expr_sites(stmt.subject, partials)
        if self._transparent([c.body for c in stmt.cases]):
            return [], partials
        cls, reason = self._classify(stmt.subject)
        guard = Guard(len(self.guards), "if", stmt, cls, reason)
        self.guards.append(guard)
        finished, out = [], []
        wildcard = any(
            isinstance(c.pattern, ast.MatchAs) and c.pattern.pattern
            is None and c.guard is None for c in stmt.cases)
        for arm, case in enumerate(stmt.cases):
            forked = [p.fork(guard.gid, arm) for p in partials]
            if case.guard is not None:
                forked = self._expr_sites(case.guard, forked)
            done, cont = self._block(case.body, forked)
            finished.extend(done)
            out.extend(cont)
        if not wildcard:  # the no-case-matched fall-through arm
            out.extend(p.fork(guard.gid, len(stmt.cases))
                       for p in partials)
        return finished, self._cap(out)

    def _try(self, stmt, partials):
        bodies = [stmt.body, stmt.orelse, stmt.finalbody] + [
            h.body for h in stmt.handlers]
        if self._transparent(bodies):
            return [], partials  # no rendezvous anywhere in the region
        finished, out = [], []
        guard = self._guard("except", stmt)
        # arm 0: no exception — body, else, (finally via fallthrough)
        normal = [p.fork(guard.gid, 0) for p in partials]
        done, cont = self._block(stmt.body + list(stmt.orelse), normal)
        for path in done:
            # a raise inside a guarded try body is (assumed) caught by
            # the handlers — the handler arms below model it; keeping it
            # as a function exit would fabricate early-exit divergences
            if path.exit == "raise" and stmt.handlers:
                continue
            finished.append(path)
        out.extend(cont)
        for i, handler in enumerate(stmt.handlers):
            if (len(handler.body) == 1
                    and isinstance(handler.body[0], ast.Raise)
                    and handler.body[0].exc is None):
                continue  # bare re-raise: propagation, not a decision
            forked = [p.fork(guard.gid, i + 1) for p in partials]
            done, cont = self._block(handler.body, forked)
            finished.extend(done)
            out.extend(cont)
        if stmt.finalbody:
            # the finally runs on EVERY exit of the region — a
            # rendezvous in it is issued by return/raise paths too
            # (dropping it would fabricate early-exit findings on
            # barrier-in-finally cleanup)
            refinished = []
            for path in finished:
                done, cont = self._block(
                    stmt.finalbody,
                    [_Partial(path.seq, path.decisions)])
                refinished.extend(done)  # finally's own exits win
                refinished.extend(p.finish(path.exit, path.exit_node)
                                  for p in cont)
            finished = refinished
            done, out = self._block(stmt.finalbody, out)
            finished.extend(done)
        return finished, self._cap(out)
