"""Invariant family (a): persistence ordering (the port's copy of
``repro/analysis/persistence.py``).

The B-APM durability contract (``pmem.py``, ``meta_log.py``): a store is
durable only after an explicit ``flush()`` (CLWB+SFENCE analogue), and a
*commit point* — a committed-tail advance, an atomic ``put_json``
metadata rename, a log-compaction ``rename`` — must never be reached
while the bytes it commits are still unflushed. Four rules:

  missing-flush        a function writes a PMemRegion and never flushes
                       after its last write (dirty bytes escape the flow)
  commit-before-flush  a commit point follows a region write with no
                       intervening flush (the crash window the paper's
                       explicit-persistence model warns about)
  raw-pool-path        code outside pmem.py touches pool-directory paths
                       with raw file APIs, bypassing PMemRegion/put_json
                       (no flush discipline, no crash atomicity)
  silent-swallow       an except handler in a persistence path whose
                       body is only pass/continue — a failed flush or
                       commit must at least be counted/surfaced

Heuristics (documented, baseline-able): a "region" receiver is a name
bound from ``pool.create/open/extend/open_or_create`` in the same
function, or whose source mentions ``region``. Ordering is judged on
source order within one function body (nested defs are separate flows).
``pmem.py`` itself is exempt from the region rules (it IS the
implementation) but not from silent-swallow.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, FuncInfo, Module,
                                       call_name, src, walk_in_order)

#: calls that constitute a durability commit point
COMMIT_CALLS = {"put_json", "rename", "replace"}
#: direct persistence operations — a function containing any of these is
#: a "persistence path" for the silent-swallow rule
PERSIST_MARKERS = {"flush", "fsync", "put_json", "rename", "replace",
                   "write"}


def _is_region_recv(recv: str, region_vars: Set[str]) -> bool:
    if not recv:
        return False
    base = recv.split(".")[0].split("[")[0]
    return ("region" in recv) or (base in region_vars) or \
        (recv in region_vars)


def _region_vars(fn_node: ast.AST) -> Set[str]:
    """Names bound from pool region factories within this function."""
    out: Set[str] = set()
    for node in walk_in_order(fn_node, into_defs=True):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name, _recv = call_name(node.value)
            if name in ("create", "open", "extend", "open_or_create"):
                # ``open`` the builtin returns a file, not a region —
                # require an attribute call (pool.open), not bare open()
                if isinstance(node.value.func, ast.Name):
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _tail_write(call: ast.Call) -> bool:
    """A region write whose offset argument names the committed-tail
    header slot — itself a commit point."""
    if not call.args:
        return False
    return "TAIL" in src(call.args[0]).upper()


def _events(mod: Module, fn: FuncInfo) -> List[Tuple[str, ast.Call]]:
    """(kind, call) in source order: kind in {write, tailwrite, flush,
    commit}."""
    region_vars = _region_vars(fn.node)
    events: List[Tuple[str, ast.Call]] = []
    for node in walk_in_order(fn.node):
        if not isinstance(node, ast.Call):
            continue
        name, recv = call_name(node)
        if name == "write" and _is_region_recv(recv, region_vars):
            events.append(("tailwrite" if _tail_write(node) else "write",
                           node))
        elif name == "flush" and _is_region_recv(recv, region_vars):
            events.append(("flush", node))
        elif name in COMMIT_CALLS:
            # ``replace``/``rename`` only count when they smell like a
            # pool/os-level atomic swap, not str.replace etc.
            if name in ("rename", "replace"):
                if not (recv == "os" or "pool" in recv or recv == "self"):
                    continue
            events.append(("commit", node))
    events.sort(key=lambda e: (e[1].lineno, e[1].col_offset))
    return events


def _check_ordering(mod: Module, fn: FuncInfo,
                    findings: List[Finding]) -> None:
    events = _events(mod, fn)
    writes = [e for e in events if e[0] in ("write", "tailwrite")]
    if not writes:
        return
    # missing-flush: some flush must follow the last write
    last_kind, last_call = writes[-1]
    has_final_flush = any(k == "flush" and
                          (c.lineno, c.col_offset) >
                          (last_call.lineno, last_call.col_offset)
                          for k, c in events)
    if not has_final_flush and \
            not mod.suppressed(last_call.lineno, "missing-flush") and \
            not mod.func_suppressed(fn, "missing-flush"):
        findings.append(Finding(
            "missing-flush", mod.rel, last_call.lineno, fn.qualname,
            src(last_call.func),
            f"region write `{src(last_call)[:60]}` is never followed by "
            f"a flush() in this flow — the bytes may not be durable"))
    # commit-before-flush: every (write .. commit/tailwrite) pair needs
    # an intervening flush
    pending: Optional[ast.Call] = None
    for kind, call in events:
        if kind == "write":
            pending = call
        elif kind == "flush":
            pending = None
        elif kind in ("commit", "tailwrite"):
            if pending is not None:
                rule = "commit-before-flush"
                if not mod.suppressed(call.lineno, rule) and \
                        not mod.func_suppressed(fn, rule):
                    findings.append(Finding(
                        rule, mod.rel, call.lineno, fn.qualname,
                        src(call.func),
                        f"commit point `{src(call.func)}` reached with "
                        f"unflushed region write at line "
                        f"{pending.lineno} — a crash here commits bytes "
                        f"that were never flushed"))
            # a tail write is itself a write that must reach a flush
            pending = call if kind == "tailwrite" else None


RAW_FILE_CALLS = {"open", "replace", "rename", "unlink", "rmtree",
                  "write_text", "write_bytes", "remove", "truncate"}


def _check_raw_paths(mod: Module, fn: FuncInfo,
                     findings: List[Finding]) -> None:
    for node in walk_in_order(fn.node, into_defs=False):
        if not isinstance(node, ast.Call):
            continue
        name, recv = call_name(node)
        if name not in RAW_FILE_CALLS:
            continue
        text = src(node)
        if "pool.root" in text or "pool._path" in text or \
                ".pools[" in text:
            if mod.suppressed(node.lineno, "raw-pool-path"):
                continue
            findings.append(Finding(
                "raw-pool-path", mod.rel, node.lineno, fn.qualname, name,
                f"`{text[:70]}` touches a pmem pool directory with raw "
                f"file APIs — only pmem.py may do that (use "
                f"PMemRegion/put_json so flush+commit discipline holds)"))


def _check_silent_swallow(mod: Module, fn: FuncInfo,
                          findings: List[Finding]) -> None:
    has_persist = False
    for node in walk_in_order(fn.node):
        if isinstance(node, ast.Call):
            name, _ = call_name(node)
            if name in PERSIST_MARKERS:
                has_persist = True
                break
    if not has_persist:
        return
    for node in walk_in_order(fn.node):
        if not isinstance(node, ast.ExceptHandler):
            continue
        # ``continue`` in a fan-out loop is NOT a silent swallow: the
        # surrounding loop accounts successes and raises on zero (the
        # put_json_all_pools / _meta_put_json pattern). Only a body
        # that is literally just ``pass`` drops the failure on the
        # floor with no accounting at all.
        body_trivial = all(isinstance(s, ast.Pass) for s in node.body)
        if not body_trivial:
            continue
        # the disable comment may sit on the ``except`` line or on the
        # ``pass`` itself — both read naturally at the suppression site
        if any(mod.suppressed(ln, "silent-swallow")
               for ln in [node.lineno] + [s.lineno for s in node.body]):
            continue
        caught = src(node.type) if node.type else "<bare>"
        findings.append(Finding(
            "silent-swallow", mod.rel, node.lineno, fn.qualname, caught,
            f"`except {caught}: pass` in a persistence path swallows a "
            f"failed flush/commit silently — count it and/or warn "
            f"(see PMemPool.dir_fsync_failures for the pattern)"))


def run(modules: List[Module]) -> List[Finding]:
    findings: List[Finding] = []
    for mod in modules:
        is_pmem_impl = mod.rel.endswith("core/pmem.py")
        for fn in mod.functions.values():
            if not is_pmem_impl:
                _check_ordering(mod, fn, findings)
                _check_raw_paths(mod, fn, findings)
            _check_silent_swallow(mod, fn, findings)
    return findings
