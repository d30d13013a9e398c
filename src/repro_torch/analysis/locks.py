"""Invariant family (c): lock discipline (the port's copy of
``repro/analysis/locks.py``).

Two lockset-style passes over each class:

  unguarded-write      an instance attribute that is written under a
                       lock at ANY site must be written under a lock at
                       EVERY site (outside ``__init__``). A mixed
                       discipline is how the PR-2/PR-5 era races slipped
                       in: one thread mutates under ``self._lock`` while
                       another mutates bare.
  blocking-under-lock  a blocking call — ``Future.result``, ``join``,
                       ``sleep``, ``wait``/``wait_for``, channel
                       ``submit``/``replicate``/``drain``/``stage_in`` —
                       made while holding a lock. With scheduler worker
                       threads acking back into locked registries, a
                       blocking call under a lock is a deadlock waiting
                       for its second participant.

Both passes treat nested closures as UNGUARDED flows (a closure defined
under a lock runs later, on another thread, without it) — which is
exactly the checkpoint-ack callback pattern, so writes inside closures
count as unguarded sites for the attribute lockset.

To keep the pass usable on this codebase's style — public methods take
the lock, private ``_helpers`` assume it ("Lock held." docstrings) — a
*lock-held-on-entry* fixpoint is computed per class: a private method
every one of whose intra-class call sites is guarded (directly under a
``with <lock>`` or inside another held-on-entry method) is treated as
guarded throughout. Helpers that are ALSO called bare anywhere stay
unguarded, which is the actual race.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, FuncInfo, Module,
                                       call_name, lock_items, src,
                                       walk_in_order)

BLOCKING = {"result", "join", "sleep", "wait", "wait_for", "submit",
            "replicate", "drain", "stage_in", "run_job"}


def _self_attr_target(node: ast.AST) -> Optional[str]:
    """The ``self.attr`` an assignment target writes, if any — covers
    ``self.x = ``, ``self.x += ``, ``self.x[k] = `` (container mutate)."""
    t = node
    if isinstance(t, ast.Subscript):
        t = t.value
    if isinstance(t, ast.Attribute) and \
            isinstance(t.value, ast.Name) and t.value.id == "self":
        return t.attr
    return None


class _MethodScan(ast.NodeVisitor):
    """Walk ONE function body tracking the lock-held depth. Nested defs
    are scanned separately with depth reset to 0 (closures run later,
    lock not held)."""

    def __init__(self, mod: Module, fn: FuncInfo):
        self.mod = mod
        self.fn = fn
        self.depth = 0
        #: attr -> list of (guarded, lineno)
        self.writes: Dict[str, List[Tuple[bool, int]]] = {}
        #: (name, receiver, lineno, lock source) blocking calls under lock
        self.blocking: List[Tuple[str, str, int, str]] = []
        #: intra-class calls: method name -> [guarded-at-call-site]
        self.self_calls: Dict[str, List[bool]] = {}
        self._lock_stack: List[str] = []
        self._root = fn.node

    def scan(self) -> "_MethodScan":
        for stmt in getattr(self._root, "body", []):
            self.visit(stmt)
        return self

    # -- structure ---------------------------------------------------
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return  # separate flow; indexed + scanned on its own

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        return

    def visit_With(self, node: ast.With) -> None:
        locks = lock_items(node)
        if locks:
            self._lock_stack.extend(locks)
            self.depth += 1
        for item in node.items:
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        if locks:
            self.depth -= 1
            del self._lock_stack[-len(locks):]

    # -- events ------------------------------------------------------
    def _record_write(self, target: ast.AST, lineno: int) -> None:
        attr = _self_attr_target(target)
        if attr is not None:
            self.writes.setdefault(attr, []).append(
                (self.depth > 0, lineno))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_write(t, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_write(node.target, node.lineno)
        self.visit(node.value)

    @staticmethod
    def _is_blocking(name: str, recv: str) -> bool:
        if name not in BLOCKING:
            return False
        if name == "join":
            # str/bytes .join and os.path.join are not thread joins
            lit = recv.lstrip("frbuFRBU")
            if not recv or lit[:1] in ("'", '"') or \
                    recv.endswith("path"):
                return False
        return True

    def visit_Call(self, node: ast.Call) -> None:
        name, recv = call_name(node)
        if self._is_blocking(name, recv):
            lock = self._lock_stack[-1] if self.depth > 0 else ""
            self.blocking.append((name, recv, node.lineno, lock))
        if recv == "self":
            self.self_calls.setdefault(name, []).append(self.depth > 0)
        self.generic_visit(node)


def _class_methods(mod: Module, cls: str) -> List[FuncInfo]:
    return [fn for fn in mod.functions.values() if fn.cls == cls]


def _held_on_entry(cls: str, scans: Dict[str, "_MethodScan"]) -> Set[str]:
    """Method names whose every intra-class call site holds the lock —
    directly, or transitively via another held-on-entry caller. Only
    private (``_``-prefixed, non-dunder) direct methods qualify: a
    public method can be entered from anywhere, lock not held. A
    closure caller never confers held-ness (it runs on another thread,
    lock dropped)."""
    sites: Dict[str, List[Tuple[str, bool]]] = {}
    for q, scan in scans.items():
        for callee, flags in scan.self_calls.items():
            for g in flags:
                sites.setdefault(callee, []).append((q, g))
    held: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for q in scans:
            if "." in q.split(f"{cls}.", 1)[-1]:
                continue  # closure, not a direct method
            name = q.rsplit(".", 1)[-1]
            if name in held or not name.startswith("_") or \
                    name.startswith("__"):
                continue
            calls = sites.get(name)
            if not calls:
                continue
            if all(g or (caller == f"{cls}.{caller.rsplit('.', 1)[-1]}"
                         and caller.rsplit(".", 1)[-1] in held)
                   for caller, g in calls):
                held.add(name)
                changed = True
    return held


def run(modules: List[Module]) -> List[Finding]:
    findings: List[Finding] = []
    for mod in modules:
        classes: Set[str] = {fn.cls for fn in mod.functions.values()
                             if fn.cls}
        for cls in sorted(classes):
            methods = _class_methods(mod, cls)
            scans = {fn.qualname: _MethodScan(mod, fn).scan()
                     for fn in methods}
            held = _held_on_entry(cls, scans)

            def is_held(q: str) -> bool:
                name = q.rsplit(".", 1)[-1]
                return name in held and q == f"{cls}.{name}"

            # ---- lockset: attr guarded anywhere => guarded everywhere
            guarded_attrs: Set[str] = set()
            for q, scan in scans.items():
                if q.endswith("__init__"):
                    continue
                for attr, sites in scan.writes.items():
                    if is_held(q) or any(g for g, _ in sites):
                        guarded_attrs.add(attr)
            for q, scan in scans.items():
                if q.endswith("__init__") or is_held(q):
                    continue
                for attr, sites in scan.writes.items():
                    if attr not in guarded_attrs:
                        continue
                    for guarded, lineno in sites:
                        if guarded:
                            continue
                        if mod.suppressed(lineno, "unguarded-write"):
                            continue
                        findings.append(Finding(
                            "unguarded-write", mod.rel, lineno, q, attr,
                            f"self.{attr} is written under a lock "
                            f"elsewhere in {cls} but written bare here "
                            f"— every write site must hold the lock "
                            f"(lockset rule)"))
            # ---- blocking calls while holding a lock
            for q, scan in scans.items():
                for name, recv, lineno, lock in scan.blocking:
                    if not lock:
                        if not is_held(q):
                            continue
                        lock = "<lock held on entry>"
                    if mod.suppressed(lineno, "blocking-under-lock"):
                        continue
                    callee = f"{recv}.{name}" if recv else name
                    findings.append(Finding(
                        "blocking-under-lock", mod.rel, lineno, q,
                        f"{name}",
                        f"blocking call `{callee}(...)` while holding "
                        f"`{lock}` — if the completion path needs the "
                        f"same lock this deadlocks; move the wait "
                        f"outside the critical section"))
    return findings
