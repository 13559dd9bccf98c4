"""Shared AST plumbing for the repro-lint passes (the port's copy of
``repro.analysis.astutils``, unchanged but for this line).

Every pass consumes a :class:`ModuleInfo`: the parsed tree with parent
links, the comment map (``# guarded-by:`` / ``# requires-lock:`` /
``# repro-lint:`` pragmas live in comments, which ``ast`` drops), and the
repo-relative path the scoping rules key on.  Helpers here are purely
syntactic — name resolution is "last dotted component" matching, constant
evaluation folds integer literals only — so the passes stay honest about
being static approximations.
"""
from __future__ import annotations

import ast
import contextlib
import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

PRAGMA_RE = re.compile(r"#\s*repro-lint:\s*(.+?)\s*$")
IGNORE_RE = re.compile(r"ignore\[([A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)\]")
SCOPE_RE = re.compile(r"scope\s*=\s*([\w-]+)")
# No '#' anchor: these are only ever searched inside the comment map, and
# annotations must be able to ride along in an existing trailing comment
# ("# worker drains (guarded-by: _lock)").
GUARDED_RE = re.compile(r"guarded-by:\s*([\w.]+)")
REQUIRES_RE = re.compile(r"requires-lock:\s*([\w.]+)")


@dataclass
class ModuleInfo:
    """One parsed source file plus the comment-level annotations."""

    path: str                       # repo-relative, '/'-separated
    text: str
    tree: ast.Module
    comments: Dict[int, str] = field(default_factory=dict)  # line -> comment
    scopes: Set[str] = field(default_factory=set)           # pragma scopes

    def comment_in_span(self, lo: int, hi: int, regex: re.Pattern
                        ) -> Optional[str]:
        """First regex group matched in any comment on lines [lo, hi]."""
        for line in range(lo, hi + 1):
            c = self.comments.get(line)
            if c:
                m = regex.search(c)
                if m:
                    return m.group(1)
        return None

    def ignored_rules(self, line: int) -> Set[str]:
        """Rule ids waived by an inline ``# repro-lint: ignore[XX000]``."""
        c = self.comments.get(line, "")
        m = PRAGMA_RE.search(c)
        if not m:
            return set()
        ig = IGNORE_RE.search(m.group(1))
        if not ig:
            return set()
        return {r.strip() for r in ig.group(1).split(",")}

    def in_scope(self, name: str) -> bool:
        """True when the module belongs to a named scope: either a path
        directory component matches (``serve`` for ``src/repro_torch/serve/*``)
        or a module-level ``# repro-lint: scope=<name>`` pragma opted in
        (how the fixture corpus exercises scoped rules)."""
        parts = self.path.split("/")
        return name in self.scopes or name in parts[:-1]


def parse_module(text: str, path: str) -> ModuleInfo:
    tree = ast.parse(text)
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._rl_parent = parent          # type: ignore[attr-defined]
    info = ModuleInfo(path=path.replace("\\", "/"), text=text, tree=tree)
    with contextlib.suppress(tokenize.TokenError):  # pragma: no cover
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                info.comments[tok.start[0]] = tok.string
    for c in info.comments.values():
        m = PRAGMA_RE.search(c)
        if m:
            s = SCOPE_RE.search(m.group(1))
            if s:
                info.scopes.add(s.group(1))
    return info


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_rl_parent", None)


def ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = parent(node)
    while cur is not None:
        yield cur
        cur = parent(cur)


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for nested Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def last_component(name: Optional[str]) -> Optional[str]:
    return name.rsplit(".", 1)[-1] if name else None


def const_int(node: ast.AST) -> Optional[int]:
    """Fold an integer-literal expression (``64 * 1024 * 1024``), else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = const_int(node.operand)
        return -v if v is not None else None
    if isinstance(node, ast.BinOp):
        left, right = const_int(node.left), const_int(node.right)
        if left is None or right is None:
            return None
        if isinstance(node.op, ast.Add):
            return left + right
        if isinstance(node.op, ast.Sub):
            return left - right
        if isinstance(node.op, ast.Mult):
            return left * right
        if isinstance(node.op, ast.FloorDiv) and right != 0:
            return left // right
        if isinstance(node.op, ast.Pow) and 0 <= right < 64:
            return left ** right
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def keyword_arg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def enclosing_function(node: ast.AST) -> Optional[ast.FunctionDef]:
    for a in ancestors(node):
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return a
    return None


def enclosing_class(node: ast.AST) -> Optional[ast.ClassDef]:
    for a in ancestors(node):
        if isinstance(a, ast.ClassDef):
            return a
    return None


def qualname(node: ast.AST) -> str:
    """Dotted Class.method context for a node (module level -> '<module>')."""
    parts: List[str] = []
    for a in ancestors(node):
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            parts.append(a.name)
    return ".".join(reversed(parts)) or "<module>"


def walk_in_order(node: ast.AST) -> Iterator[ast.AST]:
    """Depth-first, source-order traversal (ast.walk is breadth-first)."""
    for child in ast.iter_child_nodes(node):
        yield child
        yield from walk_in_order(child)


def class_methods(cls: ast.ClassDef) -> List[ast.FunctionDef]:
    return [n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def with_locks_held(node: ast.AST) -> Set[str]:
    """Lock attribute names for every enclosing ``with self.<lock>:`` block."""
    held: Set[str] = set()
    for a in ancestors(node):
        if isinstance(a, (ast.With, ast.AsyncWith)):
            for item in a.items:
                name = dotted_name(item.context_expr)
                if name and name.startswith("self."):
                    held.add(name[len("self."):])
                elif name:
                    held.add(name)
    return held


def self_attr(node: ast.AST) -> Optional[str]:
    """'X' when node is ``self.X``, else None."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def span(node: ast.AST) -> Tuple[int, int]:
    return node.lineno, getattr(node, "end_lineno", node.lineno)
