"""Shared infrastructure for the pmemlint AST passes (the port's copy of
``repro/analysis/core.py``: the port imports nothing of the JAX package).

Every pass works on ``Module`` objects (parsed files + a per-function
index) produced by ``collect``. Findings carry a *fingerprint* that is
stable under line drift (rule + file + function + key, no line numbers)
so the checked-in baseline survives unrelated edits; the printed report
still shows exact ``file:line`` locations.

Suppression: a ``# pmemlint: disable=<rule>[,<rule>...]`` comment on the
flagged line (or on the ``def`` line for function-level findings)
silences that rule there. Suppressions are for *reviewed* false
positives of the heuristics — new code should satisfy the invariant
instead.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set, Tuple

_SUPPRESS_RE = re.compile(r"#\s*pmemlint:\s*disable=([\w,\-]+)")


@dataclass(frozen=True)
class Finding:
    rule: str          # e.g. "commit-before-flush"
    path: str          # repo-relative posix path
    line: int
    func: str          # qualified name within the module ("" = module)
    key: str           # stable detail key (attr/call name), not prose
    message: str       # human-readable explanation

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.path}|{self.func}|{self.key}"

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        scope = f" {self.func}:" if self.func else ""
        return f"{where} [{self.rule}]{scope} {self.message}"


@dataclass
class FuncInfo:
    """One function (or method, or nested closure) in a module."""
    qualname: str                  # "Class.method" / "func" / "f.<locals>.g"
    node: ast.AST
    cls: Optional[str]             # owning class name, if a method
    decorators: Set[str] = field(default_factory=set)
    #: nested functions defined inside this one (their effects run in
    #: this function's flow — closures are submitted as callbacks)
    children: List[str] = field(default_factory=list)


@dataclass
class Module:
    path: Path                     # absolute
    rel: str                       # repo-relative posix path
    tree: ast.Module
    source: str
    lines: List[str]
    functions: Dict[str, FuncInfo] = field(default_factory=dict)

    def suppressed(self, line: int, rule: str) -> bool:
        if 1 <= line <= len(self.lines):
            m = _SUPPRESS_RE.search(self.lines[line - 1])
            if m and rule in m.group(1).split(","):
                return True
        return False

    def func_suppressed(self, fn: FuncInfo, rule: str) -> bool:
        node = fn.node
        start = min((d.lineno for d in getattr(node, "decorator_list", [])),
                    default=node.lineno)
        for ln in range(start, node.lineno + 1):
            if self.suppressed(ln, rule):
                return True
        return False


def _decorator_names(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for d in getattr(node, "decorator_list", []):
        t = d.func if isinstance(d, ast.Call) else d
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, ast.Attribute):
            out.add(t.attr)
    return out


def _index_functions(mod: Module) -> None:
    def visit(node: ast.AST, qual: str, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{qual}.{child.name}" if qual else child.name
                info = FuncInfo(q, child, cls, _decorator_names(child))
                mod.functions[q] = info
                if qual and qual in mod.functions:
                    mod.functions[qual].children.append(q)
                # nested defs scope under "<locals>"-free names: we use
                # plain dotted paths; collisions are not a concern for
                # lint addressing within one module
                visit(child, q, cls if cls and qual else None)
    visit(mod.tree, "", None)


def parse_module(path: Path, root: Path) -> Optional[Module]:
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (OSError, SyntaxError):
        return None
    try:
        rel = path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        rel = path.as_posix()
    mod = Module(path, rel, tree, source, source.splitlines())
    _index_functions(mod)
    return mod


def collect(targets: List[Path], root: Path) -> List[Module]:
    """Parse every ``*.py`` under the target paths (files or dirs)."""
    files: List[Path] = []
    for t in targets:
        if t.is_dir():
            files.extend(sorted(t.rglob("*.py")))
        elif t.suffix == ".py":
            files.append(t)
    mods = []
    for f in files:
        if "__pycache__" in f.parts:
            continue
        m = parse_module(f, root)
        if m is not None:
            mods.append(m)
    return mods


def src(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return ""


def call_name(call: ast.Call) -> Tuple[str, str]:
    """(callee name, receiver source) for a Call — receiver is "" for
    bare-name calls."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id, ""
    if isinstance(f, ast.Attribute):
        return f.attr, src(f.value)
    return "", ""


def walk_in_order(node: ast.AST, *, into_defs: bool = False
                  ) -> Iterator[ast.AST]:
    """Depth-first, source-order traversal of a function body. Nested
    function/lambda bodies are skipped unless ``into_defs`` — they run
    in a different flow (callbacks) and are indexed separately."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)) and not into_defs:
            continue
        yield child
        yield from walk_in_order(child, into_defs=into_defs)


LOCKISH = re.compile(r"lock", re.IGNORECASE)


def lock_items(node: ast.With) -> List[str]:
    """Sources of the with-items that look like locks."""
    out = []
    for item in node.items:
        s = src(item.context_expr)
        if LOCKISH.search(s) and "Lock(" not in s:
            out.append(s)
    return out
