"""The suppression and scope engine of the port's protocol verifier —
the counterpart of the engine half of ``tpudp/analysis/core.py``.

Pure stdlib (``ast``, ``re``, ``tokenize``): it imports neither torch
nor jax, so the verifier loads anywhere.  The engine parses each target
file once and builds the facts the protocol pass needs — a parent map,
an import-alias table and a function index — as a :class:`Module`.

Suppressions are explicit ``# tpudp: lint-ok(rule)`` comments, either
on the offending line or on a comment-only line directly above it; an
optional ``: reason`` tail documents why.  Every suppression must
*match* a finding — one that suppresses nothing is itself reported
(``useless-suppression``), so stale exceptions cannot accumulate.  The
JAX package's lint rules and its traced-region index are not ported
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize

SUPPRESS_RE = re.compile(r"#\s*tpudp:\s*lint-ok\(([a-z0-9_\-,\s]+)\)")
MARKER_RE = re.compile(r"#\s*tpudp:\s*([a-z0-9\-]+)\b")

#: Rules owned by the protocol verifier (``protocol.py``), which reports
#: a suppression naming one of them that matches nothing.
PROTOCOL_RULE_NAMES = frozenset({
    "protocol-divergent-entry",
    "protocol-order-divergence",
    "protocol-early-exit",
    "protocol-divergent-loop",
})

#: The multi-process modules the protocol verifier covers by default:
#: the port's counterparts of JAX's nine (``tpudp/analysis/core.py``),
#: everywhere a cross-rank rendezvous is issued or decided.  Files outside
#: this scope (and without a ``# tpudp: protocol-module`` marker in their
#: first lines) are never verified.
PROTOCOL_MODULES = (
    "tpudp_torch/resilience.py",
    "tpudp_torch/utils/checkpoint.py",
    "tpudp_torch/utils/consistency.py",
    "tpudp_torch/mesh.py",
    "tpudp_torch/cli.py",
    "tpudp_torch/trainer.py",
    "tpudp_torch/serve/engine.py",
    "tpudp_torch/serve/disagg.py",
    "tpudp_torch/obs/flight.py",
)


def in_protocol_scope(rel: str, markers: set[str]) -> bool:
    """Is this file one the protocol verifier analyzes?  By configured
    module path, or by an explicit first-lines marker."""
    rel = rel.replace(os.sep, "/")
    return ("protocol-module" in markers
            or any(rel.endswith(m) for m in PROTOCOL_MODULES))


@dataclasses.dataclass(frozen=True)
class Finding:
    """One finding, pointing at a concrete source location."""

    rule: str
    path: str          # repo-relative, posix separators
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


def comment_tokens(source: str) -> dict[int, str]:
    """line → comment text, from real COMMENT tokens only (a docstring
    that merely *mentions* ``# tpudp: lint-ok(...)`` must not count)."""
    out: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


class Suppressions:
    """``# tpudp: lint-ok(rule[, rule...])`` comments for one file.

    A comment on a code line covers that line; a suppression inside a
    comment block covers the next *code* line after the block (so the
    justification can span several comment lines).  :meth:`allows`
    records use so :meth:`unused` can report suppressions that matched
    nothing.
    """

    def __init__(self, source: str, comments: dict[int, str] | None = None):
        self._cover: dict[int, list[tuple[int, str]]] = {}
        self._declared: list[tuple[int, str]] = []
        self._used: set[tuple[int, str]] = set()
        if comments is None:
            comments = comment_tokens(source)
        lines = source.splitlines()

        def _comment_or_blank(n: int) -> bool:
            if n > len(lines):
                return False
            stripped = lines[n - 1].strip()
            return not stripped or stripped.startswith("#")

        for lineno, text in comments.items():
            m = SUPPRESS_RE.search(text)
            if not m:
                continue
            code = lines[lineno - 1] if lineno <= len(lines) else ""
            target = lineno
            if code.lstrip().startswith("#"):
                target = lineno + 1
                while target <= len(lines) and _comment_or_blank(target):
                    target += 1
            for rule in m.group(1).split(","):
                rule = rule.strip()
                if rule:
                    self._declared.append((lineno, rule))
                    self._cover.setdefault(target, []).append((lineno, rule))

    def allows(self, line: int, rule: str) -> bool:
        for decl_line, r in self._cover.get(line, ()):
            if r == rule:
                self._used.add((decl_line, r))
                return True
        return False

    def unused(self) -> list[tuple[int, str]]:
        return [(line, rule) for line, rule in self._declared
                if (line, rule) not in self._used]


class Module:
    """One parsed file plus the shared facts rules consume."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.tree = ast.parse(source)
        self.lines = source.splitlines()
        self.comments = comment_tokens(source)
        self.suppressions = Suppressions(source, self.comments)
        self.markers = {m.group(1)
                        for line, text in self.comments.items() if line <= 5
                        for m in [MARKER_RE.search(text)] if m}
        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.imports = self._import_aliases()
        self.functions = self._collect_functions()

    # -- imports -------------------------------------------------------

    def _import_aliases(self) -> dict[str, str]:
        aliases: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def dotted(self, node: ast.AST) -> str | None:
        """Dotted path of a Name/Attribute chain with the root resolved
        through the module's import aliases (``np.random`` →
        ``numpy.random``); None for anything else (calls, subscripts)."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.imports.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))

    def raw_dotted(self, node: ast.AST) -> str | None:
        """Dotted path WITHOUT alias resolution (``self.state.params``)
        — the spelling taint tracking keys on."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        return ".".join(reversed(parts))

    # -- function index ------------------------------------------------

    def _collect_functions(self) -> dict[ast.FunctionDef, str]:
        """Every def, mapped to its dotted qualname (``Engine.step``,
        ``make_train_step.train_step``)."""
        out: dict[ast.FunctionDef, str] = {}

        def visit(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    out[child] = qual
                    visit(child, qual + ".")
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.")
                else:
                    visit(child, prefix)

        visit(self.tree, "")
        return out

    def enclosing_function(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None


def iter_python_files(paths: list[str], root: str):
    """Yield (abspath, relpath) for every .py under the given paths."""
    skip_dirs = {"__pycache__", ".git", "bench_results", "node_modules",
                 ".venv"}
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(ap):
            yield ap, os.path.relpath(ap, root)
            continue
        for dirpath, dirnames, filenames in os.walk(ap):
            dirnames[:] = sorted(d for d in dirnames if d not in skip_dirs)
            for f in sorted(filenames):
                if f.endswith(".py"):
                    full = os.path.join(dirpath, f)
                    yield full, os.path.relpath(full, root)
