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
(``useless-suppression``), so stale exceptions cannot accumulate.
:class:`Rule`, :func:`mentions`, :func:`ordered_walk` and
:func:`lint_paths` carry the port's lint rules (``rules.py``).
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


# -- the lint engine ------------------------------------------------------

#: Attribute reads that give host metadata of a tensor, not its values:
#: they break the taint of the value-tracking rules.
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad", "grad_fn", "names", "config"}
#: Host builtins whose result is not a device value (``float``, ``int``
#: and ``bool`` of a device value are the sync itself, which the
#: host-sync rule flags; their result is a host scalar).
STATIC_CALLS = {"len", "isinstance", "type", "getattr", "hasattr", "id",
                "callable", "range", "repr", "str", "format", "float",
                "int", "bool"}
#: Tensor methods that read host metadata.
STATIC_METHODS = {"size", "numel", "dim", "element_size", "stride",
                  "data_ptr", "is_contiguous", "get_device"}


def mentions(mod: Module, node: ast.AST, tainted: set[str]) -> bool:
    """Does ``node`` evaluate through a tainted value?  ``tainted`` holds
    raw dotted paths (``x``, ``self.state``); static attribute reads
    (``x.shape``), identity tests (``x is None``) and host builtins
    (``len``, ``isinstance``) break the taint."""
    if isinstance(node, (ast.Name, ast.Attribute)):
        if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
            return False
        dotted = mod.raw_dotted(node)
        if dotted is not None:
            return any(dotted == t or dotted.startswith(t + ".")
                       for t in tainted)
        if isinstance(node, ast.Attribute):
            return mentions(mod, node.value, tainted)
        return False
    if isinstance(node, ast.Call):
        if mod.dotted(node.func) in STATIC_CALLS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in STATIC_METHODS):
            return False
        parts = [*node.args, *[kw.value for kw in node.keywords]]
        if isinstance(node.func, ast.Attribute):
            parts.append(node.func.value)
        return any(mentions(mod, p, tainted) for p in parts)
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False
        return any(mentions(mod, c, tainted)
                   for c in [node.left, *node.comparators])
    if isinstance(node, ast.Constant):
        return False
    return any(mentions(mod, c, tainted) for c in ast.iter_child_nodes(node))


def ordered_walk(fn: ast.AST, skip_nested_defs: bool = True):
    """Nodes of ``fn`` in source order (``ast.walk`` is breadth-first,
    which breaks linear taint propagation through nested blocks); with
    ``skip_nested_defs``, the bodies of defs nested in ``fn`` are left
    out (they are analyzed on their own)."""
    skip: set[int] = set()
    if skip_nested_defs:
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                skip.update(id(n) for n in ast.walk(node))
                skip.discard(id(node))
    return sorted((n for n in ast.walk(fn)
                   if hasattr(n, "lineno") and id(n) not in skip),
                  key=lambda n: (n.lineno, n.col_offset))


class Rule:
    """A lint rule: subclasses set ``name`` and ``summary`` and yield
    :class:`Finding` objects (before suppression) from :meth:`check`."""

    name: str = ""
    summary: str = ""

    def check(self, mod: Module):
        raise NotImplementedError

    def finding(self, mod: Module, node: ast.AST, message: str) -> Finding:
        return Finding(self.name, mod.rel, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)


def lint_paths(paths: list[str], root: str, rules=None,
               report_useless: bool = True):
    """Every rule over every file: ``(findings, errors)``.  ``findings``
    leaves out suppressed hits and adds a ``useless-suppression`` for each
    suppression that matched nothing; ``errors`` names files that did not
    parse."""
    if rules is None:
        from .rules import RULES
        rules = RULES
    findings: list[Finding] = []
    errors: list[str] = []
    for path, rel in iter_python_files(paths, root):
        try:
            with open(path, encoding="utf-8") as f:
                mod = Module(path, rel, f.read())
        except (SyntaxError, UnicodeDecodeError) as exc:
            errors.append(f"{rel}: parse failed: {exc}")
            continue
        for rule in rules:
            for finding in rule.check(mod):
                if not mod.suppressions.allows(finding.line, rule.name):
                    findings.append(finding)
        if report_useless:
            in_protocol = in_protocol_scope(mod.rel, mod.markers)
            for line, rule_name in mod.suppressions.unused():
                if rule_name in PROTOCOL_RULE_NAMES and in_protocol:
                    continue  # the protocol pass reports these here
                findings.append(Finding(
                    "useless-suppression", mod.rel, line, 0,
                    f"lint-ok({rule_name}) suppresses nothing — remove it "
                    f"(or the hazard it excused is gone)"))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, errors
