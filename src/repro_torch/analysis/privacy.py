"""Privacy-flow pass (PF rules).

**PF001 — taint tracking.**  An intraprocedural, fixed-point taint analysis
per function scope: raw-data *sources* (registry: histogram builders,
``req.marginals`` payload reads, data-plane parameters) taint the values
derived from them; *sanitizer* calls (the ``measure*`` family — every one
of them draws calibrated Gaussian/discrete-Gaussian noise before
returning) produce clean values; *declassifiers* (``.shape``/``.size``/
``len``) stop taint, since shape-class metadata is workload- not
data-dependent.  A tainted value reaching a *sink* (future resolution,
ledger journal append, serve-scope response assembly) is a privacy bug: a
release path that never paid for noise.

**PF002 — charge-before-measure.**  Inside serve-scope classes, every
method that (transitively, within the class) performs a measurement must be
dominated by a ``*.charge(...)`` call: either earlier in its own body, or
earlier than the call site in *every* intra-class caller chain.  This is
the static form of the ledger's charge-before-measure theorem
(:mod:`repro_torch.serve.ledger`): deleting the charge in ``_serve_batch`` flips
this rule, and with it the CI gate.

Both rules are approximations in the safe direction for a lint (no alias
tracking, no interprocedural taint): they prove the *annotated protocol*,
and the fixture corpus pins the behaviors they must and must not flag.

The port's copy of ``repro.analysis.privacy``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .astutils import (ModuleInfo, call_name, class_methods, last_component,
                       qualname)
from .findings import Finding
from .registry import DEFAULT_PRIVACY, PrivacyRegistry

_MAX_TAINT_ITERS = 4


def _walk_scope(scope: ast.AST):
    """Source-order traversal that does NOT descend into nested defs —
    each function body is its own taint scope."""
    def rec(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield child
            yield from rec(child)
    return rec(scope)


class _Taint:
    """Taint environment + expression evaluation for one function scope."""

    def __init__(self, reg: PrivacyRegistry):
        self.reg = reg
        self.env: Set[str] = set()

    # ------------------------------------------------------------ expression
    def tainted(self, node: ast.AST) -> bool:                  # noqa: C901
        reg = self.reg
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.env
        if isinstance(node, ast.Call):
            name = call_name(node)
            last = last_component(name)
            if last in reg.sanitizer_calls:
                return False
            if last in reg.declassifier_calls:
                return False
            if last in reg.source_calls:
                return True
            args_tainted = any(self.tainted(a) for a in node.args) or \
                any(self.tainted(kw.value) for kw in node.keywords)
            # a method call on a tainted object yields tainted data
            recv_tainted = isinstance(node.func, ast.Attribute) and \
                self.tainted(node.func.value)
            return args_tainted or recv_tainted
        if isinstance(node, ast.Attribute):
            if node.attr in reg.source_attrs:
                return True
            if node.attr in reg.declassifier_attrs:
                return False
            return self.tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.tainted(node.left) or self.tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            return False                       # booleans are shape-class info
        if isinstance(node, ast.IfExp):
            return self.tainted(node.body) or self.tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.tainted(v) for v in node.values if v is not None)
        if isinstance(node, ast.JoinedStr):
            return any(self.tainted(v.value) for v in node.values
                       if isinstance(v, ast.FormattedValue))
        if isinstance(node, ast.FormattedValue):
            return self.tainted(node.value)
        if isinstance(node, ast.Starred):
            return self.tainted(node.value)
        if isinstance(node, (ast.Await, ast.YieldFrom)):
            return self.tainted(node.value)
        if isinstance(node, ast.NamedExpr):
            return self.tainted(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self._comp_tainted(node, node.elt)
        if isinstance(node, ast.DictComp):
            return self._comp_tainted(node, node.value) \
                or self._comp_tainted(node, node.key)
        return False

    def _comp_tainted(self, comp: ast.AST, elt: ast.AST) -> bool:
        bound: Set[str] = set()
        for gen in comp.generators:
            if self.tainted(gen.iter):
                for t in ast.walk(gen.target):
                    if isinstance(t, ast.Name):
                        bound.add(t.id)
        added = bound - self.env
        self.env |= added
        try:
            return self.tainted(elt)
        finally:
            self.env -= added

    # ------------------------------------------------------------ statements
    def _bind(self, target: ast.AST, is_tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if is_tainted:
                self.env.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, is_tainted)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, is_tainted)
        # attribute/subscript stores: field-level taint is out of scope

    def run(self, scope: ast.AST, params: Optional[ast.arguments]) -> None:
        if params is not None:
            for a in (params.posonlyargs + params.args + params.kwonlyargs):
                if a.arg in self.reg.source_params:
                    self.env.add(a.arg)
        for _ in range(_MAX_TAINT_ITERS):
            before = set(self.env)
            for node in _walk_scope(scope):
                if isinstance(node, ast.Assign):
                    t = self.tainted(node.value)
                    for tgt in node.targets:
                        self._bind(tgt, t)
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    self._bind(node.target, self.tainted(node.value))
                elif isinstance(node, ast.AugAssign):
                    if self.tainted(node.value):
                        self._bind(node.target, True)
                elif isinstance(node, ast.For):
                    self._bind(node.target, self.tainted(node.iter))
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        if item.optional_vars is not None:
                            self._bind(item.optional_vars,
                                       self.tainted(item.context_expr))
                elif isinstance(node, ast.NamedExpr):
                    self._bind(node.target, self.tainted(node.value))
            if self.env == before:
                break


def _function_scopes(tree: ast.Module):
    """(scope_node, arguments|None) for the module body + every function."""
    yield tree, None
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, node.args


def _check_taint(info: ModuleInfo, reg: PrivacyRegistry) -> List[Finding]:
    findings: List[Finding] = []
    in_serve = info.in_scope(reg.serve_scope)
    for scope, params in _function_scopes(info.tree):
        taint = _Taint(reg)
        taint.run(scope, params)
        if not taint.env and not _has_source_expr(scope, reg):
            continue
        for node in _walk_scope(scope):
            if not isinstance(node, ast.Call):
                continue
            last = last_component(call_name(node))
            is_sink = last in reg.sink_calls \
                or last in reg.sink_constructors \
                or (in_serve and last in reg.serve_sink_calls)
            if not is_sink:
                continue
            if "PF001" in info.ignored_rules(node.lineno):
                continue
            hot = [a for a in node.args if taint.tainted(a)]
            hot += [kw.value for kw in node.keywords if taint.tainted(kw.value)]
            if not hot:
                continue
            findings.append(Finding(
                "PF001", info.path, node.lineno,
                f"{qualname(node)}:{last}",
                f"raw (un-noised) data flows into sink {last!r}",
                hint="route the value through a measure*/release sanitizer "
                     "(Gaussian or discrete-Gaussian noise) before it can "
                     "reach a release surface"))
    return findings


def _has_source_expr(scope: ast.AST, reg: PrivacyRegistry) -> bool:
    """Cheap pre-filter: does this scope mention any source at all?"""
    for node in ast.walk(scope):
        if isinstance(node, ast.Attribute) and node.attr in reg.source_attrs:
            return True
        if isinstance(node, ast.Call) and \
                last_component(call_name(node)) in reg.source_calls:
            return True
    return False


# --------------------------------------------------------------------- PF002
def _method_events(method: ast.AST, reg: PrivacyRegistry
                   ) -> List[Tuple[int, str, str]]:
    """Ordered (line, kind, name) events: charge / measure / self-calls."""
    events = []
    for node in ast.walk(method):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        last = last_component(name)
        if last in reg.charge_calls:
            events.append((node.lineno, "charge", last))
        elif last in reg.measure_calls:
            events.append((node.lineno, "measure", last))
        elif name and name.startswith("self."):
            events.append((node.lineno, "call", name.split(".", 1)[1]))
    events.sort()
    return events


def _check_charge_protocol(info: ModuleInfo, reg: PrivacyRegistry
                           ) -> List[Finding]:
    if not info.in_scope(reg.serve_scope):
        return []
    findings: List[Finding] = []
    for cls in [n for n in ast.walk(info.tree) if isinstance(n, ast.ClassDef)]:
        events: Dict[str, List[Tuple[int, str, str]]] = {
            m.name: _method_events(m, reg) for m in class_methods(cls)}
        lines = {m.name: m.lineno for m in class_methods(cls)}

        def charged_before(method: str, line: int) -> bool:
            return any(kind == "charge" and ln < line
                       for ln, kind, _n in events.get(method, []))

        def dominated(method: str, line: int, seen: frozenset) -> bool:
            """Is (method, line) preceded by a charge on every caller path?"""
            if charged_before(method, line):
                return True
            if method in seen:
                return True                # cycle: judged at the entry edge
            callers = [(m, ln) for m, evs in events.items()
                       for ln, kind, name in evs
                       if kind == "call" and name.split(".")[0] == method]
            if not callers:
                return False               # an entry point that never charged
            return all(dominated(m, ln, seen | {method})
                       for m, ln in callers)

        for method, evs in events.items():
            first = next(((ln, nm) for ln, kind, nm in evs
                          if kind == "measure"), None)
            if first is None:
                continue
            line, name = first
            if "PF002" in info.ignored_rules(line):
                continue
            if dominated(method, line, frozenset()):
                continue
            findings.append(Finding(
                "PF002", info.path, line,
                f"{cls.name}.{method}:{name}",
                f"measurement call {name!r} is not dominated by a budget "
                f"charge on every path into {cls.name}.{method}",
                hint="charge the ledger (charge-before-measure) before any "
                     "noise is drawn; see repro_torch/serve/ledger.py"))
        del lines
    return findings


def check_privacy(info: ModuleInfo,
                  reg: PrivacyRegistry = DEFAULT_PRIVACY) -> List[Finding]:
    return _check_taint(info, reg) + _check_charge_protocol(info, reg)
