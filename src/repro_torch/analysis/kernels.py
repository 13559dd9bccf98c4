"""Kernel-invariant pass of the port (KN rules).

Checks launch-config literals at ``plan_chain`` / ``plan_shapes`` /
``fused_chain_matvec`` / ``tune_chain`` call sites against the live limits
of the port's kernels: ``rows`` (batch rows a fused block holds) at least 1,
``smem_budget`` within the largest per-block shared memory of any card in
the cost model's table.  Two structural rules follow the reference's: no
narrow compute dtype on a chain launched from a noise-drawing function (the
``allow_narrow`` contract — Gaussian noise stays float32 end to end), and
no host side effects (Python RNG, clock, I/O, host syncs) inside a function
handed to ``torch.compile``, ``torch.jit.script`` or ``triton.jit``, or
inside a ``torch.cuda.graph`` capture, where they would trace to a
constant, break the capture, or run once instead of every replay.

The reference's KN005 (BlockSpec lane quantum) has no counterpart: the CUDA
kernels mask their own edges, so no literal of a launch has a quantum.

Only *literal* arguments are judged.  A computed ``rows`` is the
autotuner's job at runtime; a literal one is a reviewable claim the
analyzer can check at commit time.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from .astutils import (ModuleInfo, call_name, const_int, const_str,
                       dotted_name, enclosing_function, keyword_arg,
                       last_component, qualname, walk_in_order)
from .findings import Finding
from .registry import KernelLimits, kernel_limits

# Wrappers whose first argument (or decorated function) becomes a compiled
# or captured body: torch.compile, torch.jit.script, triton.jit,
# torch.cuda.make_graphed_callables.
_COMPILE_NAMES = {"compile", "script", "jit", "make_graphed_callables"}
_COMPILE_DOTTED = {"torch.compile", "torch.jit.script", "triton.jit", "jit",
                   "torch.cuda.make_graphed_callables"}


def _dtype_of(call: ast.Call) -> Optional[str]:
    """Literal compute dtype at a chain call site, if spelled out."""
    for kw_name in ("dtype", "compute_dtype"):
        node = keyword_arg(call, kw_name)
        if node is None:
            continue
        s = const_str(node)
        if s is not None:
            return s
        name = dotted_name(node)
        if name:
            return name.rsplit(".", 1)[-1]
    return None


def _callee(call: ast.Call) -> Optional[str]:
    """The called function's own name, also for a method of an expression
    (``torch.empty_like(x).normal_`` -> ``normal_``)."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return last_component(call_name(call))


def _draws_noise(fn: Optional[ast.AST], limits: KernelLimits) -> bool:
    if fn is None:
        return False
    return any(isinstance(n, ast.Call) and _callee(n) in limits.noise_calls
               for n in ast.walk(fn))


def _is_compile_wrapper(node: ast.AST) -> bool:
    """Is ``node`` (a decorator or a callee) one of the compile wrappers,
    bare (``@torch.compile``), called (``@torch.compile(mode=...)``) or
    through ``functools.partial(torch.compile, ...)``?"""
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name and last_component(name) == "partial":
            return bool(node.args) and _is_compile_wrapper(node.args[0])
        return _is_compile_wrapper(node.func)
    name = dotted_name(node)
    return bool(name) and (name in _COMPILE_DOTTED or (
        "." in name and last_component(name) in _COMPILE_NAMES
        and name.split(".")[0] in ("torch", "triton")))


def _compiled_names(tree: ast.Module) -> Set[str]:
    """Names of functions handed to a compile wrapper as its first argument."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_compile_wrapper(node.func) \
                and node.args and isinstance(node.args[0], ast.Name):
            names.add(node.args[0].id)
    return names


def _is_graph_capture(node: ast.AST) -> bool:
    """``with torch.cuda.graph(g):`` (or ``graph(g)`` imported bare)."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        ctx = item.context_expr
        if isinstance(ctx, ast.Call):
            name = dotted_name(ctx.func) or ""
            if name in ("torch.cuda.graph", "cuda.graph", "graph"):
                return True
    return False


def _chain_site_findings(info: ModuleInfo, call: ast.Call,
                         limits: KernelLimits) -> List[Finding]:
    out: List[Finding] = []
    fn_name = last_component(call_name(call))
    ignored = info.ignored_rules(call.lineno)
    where = f"{qualname(call)}:{fn_name}"

    rows = keyword_arg(call, "rows")
    lit_rows = const_int(rows) if rows is not None else None
    if lit_rows is not None and lit_rows < 1 and "KN001" not in ignored:
        out.append(Finding(
            "KN001", info.path, rows.lineno, where,
            f"rows={lit_rows} is below 1: a fused block holds at least one "
            f"batch row",
            hint="pass rows >= 1, or drop the literal and let plan_chain "
                 "fit the rows to the shared-memory budget"))

    budget = keyword_arg(call, "smem_budget")
    lit_budget = const_int(budget) if budget is not None else None
    if lit_budget is not None and "KN002" not in ignored \
            and lit_budget > limits.smem_limit:
        out.append(Finding(
            "KN002", info.path, budget.lineno, where,
            f"smem_budget={lit_budget} exceeds the largest per-block shared "
            f"memory of any card ({limits.smem_limit} bytes) in the "
            f"DeviceSpec table",
            hint="a budget above the card's block limit plans launches "
                 "that cannot start; use a table entry's smem_limit"))

    if "KN003" not in ignored:
        narrow = keyword_arg(call, "allow_narrow")
        is_narrow = (isinstance(narrow, ast.Constant)
                     and narrow.value is True) \
            or (_dtype_of(call) in limits.narrow_dtypes)
        if is_narrow and _draws_noise(enclosing_function(call), limits):
            node = narrow if narrow is not None else call
            out.append(Finding(
                "KN003", info.path, node.lineno, where,
                "narrow compute dtype requested on a chain inside a "
                "noise-drawing function; calibrated noise must stay float32",
                hint="keep allow_narrow=False wherever the function draws "
                     "noise (reconstruction-only paths may opt in)"))
    return out


def _host_effect(call: ast.Call, limits: KernelLimits) -> Optional[str]:
    """The host effect ``call`` makes (its name), or None."""
    name = call_name(call)
    if name and (name in limits.host_effect_exact or any(
            name.startswith(p) for p in limits.host_effect_prefixes)):
        return name
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in limits.host_sync_methods:
        return name or f".{call.func.attr}"
    return None


def _compiled_bodies(tree: ast.Module) -> Iterator[tuple]:
    """(node whose calls are checked, what it is) for every compiled
    function and every CUDA graph capture block."""
    compiled = _compiled_names(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                node.name in compiled
                or any(_is_compile_wrapper(d) for d in node.decorator_list)):
            yield node, f"compiled body {node.name!r}"
        elif _is_graph_capture(node):
            yield node, "CUDA graph capture"


def _host_effect_findings(info: ModuleInfo, limits: KernelLimits
                          ) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[ast.AST] = set()       # a capture inside a compiled body
    for body, what in _compiled_bodies(info.tree):
        for node in ast.walk(body):
            if not isinstance(node, ast.Call) or node in seen:
                continue
            seen.add(node)
            name = _host_effect(node, limits)
            if name is None:
                continue
            if "KN004" in info.ignored_rules(node.lineno):
                continue
            out.append(Finding(
                "KN004", info.path, node.lineno,
                f"{qualname(node)}:{name}",
                f"host side effect {name!r} inside {what}",
                hint="host calls trace to a constant, break the capture or "
                     "run once for every replay; hoist them out and pass "
                     "values in as tensors"))
    return out


def check_kernels(info: ModuleInfo,
                  limits: Optional[KernelLimits] = None) -> List[Finding]:
    limits = limits or kernel_limits()
    findings: List[Finding] = []
    for node in walk_in_order(info.tree):
        if isinstance(node, ast.Call) and \
                last_component(call_name(node)) in limits.chain_calls:
            findings.extend(_chain_site_findings(info, node, limits))
    findings.extend(_host_effect_findings(info, limits))
    return findings
