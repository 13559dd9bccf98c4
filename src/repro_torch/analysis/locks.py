"""Lock-discipline pass (LK rules).

Annotation syntax (comments, because they must not change runtime
behavior):

* ``self.field = ...   # guarded-by: _lock`` — every later ``self.field``
  access in the class must sit inside ``with self._lock:`` (directly or via
  an enclosing block).  Dataclass-style class-body fields
  (``field: T = ...  # guarded-by: _lock``) work the same way.
* ``def helper(self):   # requires-lock: _lock`` — the method asserts its
  callers hold the lock; accesses inside it are exempt (the runtime
  contract is the caller's, as with ``_EngineCache``-style helpers).

``__init__``/``__post_init__`` are exempt: the object is not yet published
to other threads while it is being constructed.  The pass is lexical on
purpose — a field that escapes via aliasing (``d = self._entries``) taints
nothing once aliased, which is exactly the hygiene the annotation is meant
to discourage.

The port's copy of ``repro.analysis.locks``.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from .astutils import (GUARDED_RE, REQUIRES_RE, ModuleInfo, class_methods,
                       enclosing_function, qualname, self_attr, span,
                       walk_in_order, with_locks_held)
from .findings import Finding

_CTOR_NAMES = {"__init__", "__post_init__", "__new__"}


def _guarded_fields(info: ModuleInfo, cls: ast.ClassDef) -> Dict[str, str]:
    """{field_name: lock_name} from ``# guarded-by:`` annotations."""
    guards: Dict[str, str] = {}
    for node in walk_in_order(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            lo, hi = span(node)
            lock = info.comment_in_span(lo, hi, GUARDED_RE)
            if not lock:
                continue
            lock = lock.removeprefix("self.")
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                name = self_attr(t)
                if name is None and isinstance(t, ast.Name):
                    name = t.id            # dataclass class-body field
                if name:
                    guards[name] = lock
    return guards


def _declared_locks(cls: ast.ClassDef) -> set:
    """Attribute names assigned a value anywhere in the class (lock homes)."""
    names = set()
    for node in walk_in_order(cls):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                name = self_attr(t)
                if name:
                    names.add(name)
                elif isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, ast.AnnAssign):
            name = self_attr(node.target)
            if name:
                names.add(name)
            elif isinstance(node.target, ast.Name):
                names.add(node.target.id)
    return names


def _required_locks(info: ModuleInfo, fn: ast.FunctionDef) -> set:
    """Locks a method declares its callers hold (``# requires-lock:``)."""
    first = fn.body[0].lineno if fn.body else fn.lineno
    locks = set()
    for line in range(fn.lineno, first + 1):
        c = info.comments.get(line)
        if c:
            m = REQUIRES_RE.search(c)
            if m:
                locks.add(m.group(1).removeprefix("self."))
    return locks


def check_locks(info: ModuleInfo) -> List[Finding]:
    findings: List[Finding] = []
    for cls in [n for n in ast.walk(info.tree) if isinstance(n, ast.ClassDef)]:
        guards = _guarded_fields(info, cls)
        if not guards:
            continue
        declared = _declared_locks(cls)
        for fld, lock in sorted(guards.items()):
            if lock not in declared:
                findings.append(Finding(
                    "LK002", info.path, cls.lineno,
                    f"{cls.name}:{fld}",
                    f"field {fld!r} is guarded-by {lock!r} but the class "
                    f"never creates self.{lock}",
                    hint=f"add self.{lock} = threading.Lock() in __init__ "
                         f"or fix the annotation"))
        method_requires = {m.name: _required_locks(info, m)
                           for m in class_methods(cls)}
        for method in class_methods(cls):
            if method.name in _CTOR_NAMES:
                continue
            required = _required_locks(info, method)
            reported = set()
            for node in walk_in_order(method):
                # caller side of the requires-lock contract: invoking a
                # helper that asserts "caller holds L" without holding L
                if isinstance(node, ast.Call):
                    callee = self_attr(node.func)
                    for lock in method_requires.get(callee, ()):
                        if lock in required or lock in with_locks_held(node):
                            continue
                        if "LK001" in info.ignored_rules(node.lineno):
                            continue
                        symkey = (method.name, callee)
                        if symkey in reported:
                            continue
                        reported.add(symkey)
                        findings.append(Finding(
                            "LK001", info.path, node.lineno,
                            f"{qualname(node)}:{callee}",
                            f"call to {callee!r} (requires-lock {lock!r}) "
                            f"outside 'with self.{lock}'",
                            hint=f"acquire self.{lock} before calling "
                                 f"self.{callee}(), or drop the "
                                 f"requires-lock annotation"))
                name = self_attr(node)
                if name is None or name not in guards:
                    continue
                lock = guards[name]
                if lock in required or lock in with_locks_held(node):
                    continue
                if "LK001" in info.ignored_rules(node.lineno):
                    continue
                fn = enclosing_function(node)
                if fn is not method and fn is not None \
                        and lock in _required_locks(info, fn):
                    continue               # nested helper with its own contract
                symkey = (method.name, name)
                if symkey in reported:
                    continue               # one finding per (method, field)
                reported.add(symkey)
                findings.append(Finding(
                    "LK001", info.path, node.lineno,
                    f"{qualname(node)}:{name}",
                    f"field {name!r} (guarded-by {lock!r}) accessed outside "
                    f"'with self.{lock}'",
                    hint=f"wrap the access in 'with self.{lock}:' or mark "
                         f"the method '# requires-lock: {lock}' if callers "
                         f"hold it"))
    return findings
