"""Invariant family (b): metadata-only recovery (the port's copy of
``repro/analysis/recovery.py``).

Functions decorated ``@metadata_only`` (``analysis/annotations.py`` of
either package: the pass keys on the decorator's name)
promise that recovery/placement *decisions* read persisted metadata only
— ack records, catalog records, manifests, journals — never object
payload bytes. The promise is what makes ``restore_latest_recoverable``,
``DatasetCatalog.recoverable``, ``WorkflowScheduler.resume`` and the
repair scans cheap and probe-free after a node loss (CHANGES.md PRs
2-5 all assert "zero blind probes" in tests; this pass enforces it at
the source level).

The pass builds a project-wide call graph and walks it transitively
from every ``@metadata_only`` root. An *object read* is:

  * a call to ``get_with_manifest`` / ``read_leaf_slice`` (always), or
  * a ``.get(...)`` whose receiver smells like an object store or the
    external tier (``...store...``, ``...external...``, ``self.view``) —
    plain dict ``.get`` never matches.

Traversal stops at functions decorated ``@rehydration_entry``: reads
there are the sources of sanctioned copies (replicate/drain/stage-in),
not probes. Call resolution is heuristic but effective on this
codebase: ``self.m()`` resolves within the class, bare names within the
module, and otherwise a method name that is defined by exactly ONE
class in the analyzed set resolves to it (ambiguous names are not
traversed — the direct-read patterns above still apply at every site).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, FuncInfo, Module,
                                       call_name, src, walk_in_order)

ALWAYS_READ = {"get_with_manifest", "read_leaf_slice", "get_leaf"}
STOREISH = ("store", "external", "view")


def _is_object_read(name: str, recv: str) -> bool:
    if name in ALWAYS_READ:
        return True
    if name == "get":
        low = recv.lower()
        return any(s in low for s in STOREISH)
    return False


class _Graph:
    """Project-wide function index + heuristic call resolution."""

    def __init__(self, modules: List[Module]):
        self.modules = modules
        # global id: f"{mod.rel}::{qualname}"
        self.funcs: Dict[str, Tuple[Module, FuncInfo]] = {}
        # method name -> list of global ids (for unique-name resolution)
        self.by_method: Dict[str, List[str]] = {}
        for mod in modules:
            for q, fn in mod.functions.items():
                gid = f"{mod.rel}::{q}"
                self.funcs[gid] = (mod, fn)
                self.by_method.setdefault(q.rsplit(".", 1)[-1],
                                          []).append(gid)

    def resolve(self, mod: Module, fn: FuncInfo, name: str,
                recv: str) -> Optional[str]:
        # self.m() -> method on the same class
        if recv == "self" and fn.cls:
            gid = f"{mod.rel}::{fn.cls}.{name}"
            if gid in self.funcs:
                return gid
        # bare f() -> sibling nested function, then module function
        if not recv:
            parent = fn.qualname.rsplit(".", 1)[0] \
                if "." in fn.qualname else ""
            for scope in (fn.qualname, parent, ""):
                q = f"{scope}.{name}" if scope else name
                gid = f"{mod.rel}::{q}"
                if gid in self.funcs:
                    return gid
            return None
        # obj.m() -> unique method name across the project
        cands = [g for g in self.by_method.get(name, ())
                 if "." in self.funcs[g][1].qualname]
        if len(cands) == 1:
            return cands[0]
        return None

    def effects(self, gid: str) -> Tuple[List[Tuple[ast.Call, str]],
                                         List[Tuple[str, ast.Call]]]:
        """(object reads, resolved callees) of one function, nested
        closures included — a closure defined here runs in this flow."""
        mod, fn = self.funcs[gid]
        reads: List[Tuple[ast.Call, str]] = []
        calls: List[Tuple[str, ast.Call]] = []
        stack = [gid]
        seen = {gid}
        while stack:
            g = stack.pop()
            m, f = self.funcs[g]
            for child in f.children:
                cg = f"{m.rel}::{child}"
                if cg in self.funcs and cg not in seen:
                    seen.add(cg)
                    stack.append(cg)
            for node in walk_in_order(f.node):
                if not isinstance(node, ast.Call):
                    continue
                name, recv = call_name(node)
                if _is_object_read(name, recv):
                    reads.append((node, f"{recv}.{name}" if recv
                                  else name))
                target = self.resolve(m, f, name, recv)
                if target is not None and target != g:
                    calls.append((target, node))
        return reads, calls


def run(modules: List[Module]) -> List[Finding]:
    graph = _Graph(modules)
    findings: List[Finding] = []
    roots = [gid for gid, (mod, fn) in graph.funcs.items()
             if "metadata_only" in fn.decorators]
    for root in roots:
        mod, fn = graph.funcs[root]
        if mod.func_suppressed(fn, "metadata-only-read"):
            continue
        # BFS keeping one witness path per function
        paths: Dict[str, List[str]] = {root: [fn.qualname]}
        queue = [root]
        visited = {root}
        while queue:
            gid = queue.pop(0)
            gmod, gfn = graph.funcs[gid]
            if gid != root and "metadata_only" in gfn.decorators:
                continue  # an inner @metadata_only is its own root
            reads, calls = graph.effects(gid)
            for call, what in reads:
                if gmod.suppressed(call.lineno, "metadata-only-read"):
                    continue
                via = " -> ".join(paths[gid])
                findings.append(Finding(
                    "metadata-only-read", mod.rel, fn.node.lineno,
                    fn.qualname, f"{what}@{gfn.qualname}",
                    f"@metadata_only function reaches object-store "
                    f"read `{src(call)[:60]}` "
                    f"({gmod.rel}:{call.lineno}) via {via} -> "
                    f"{gfn.qualname} — route it through a "
                    f"@rehydration_entry or drop the annotation"))
            for target, _call in calls:
                tmod, tfn = graph.funcs[target]
                if "rehydration_entry" in tfn.decorators:
                    continue
                if target not in visited:
                    visited.add(target)
                    paths[target] = paths[gid] + [tfn.qualname]
                    queue.append(target)
    return findings
