"""Invariant annotations the pmemlint passes key on (a copy of the JAX
package's ``analysis/annotations.py``: the port imports nothing of it).

Both decorators are runtime no-ops beyond marking the function and
registering its qualified name. The lint's metadata-only recovery pass
reads them by name from the AST, so applying one changes no behaviour:

    python -m repro_torch.analysis.lint src/repro_torch
"""
from __future__ import annotations

from typing import Callable, Set

#: qualified names (``module.Class.method``) declared metadata-only at
#: import time
METADATA_ONLY: Set[str] = set()

#: qualified names of sanctioned rehydration/copy entry points
REHYDRATION_ENTRIES: Set[str] = set()


def _qualname(fn: Callable) -> str:
    return f"{fn.__module__}.{fn.__qualname__}"


def metadata_only(fn: Callable) -> Callable:
    """Declare that ``fn`` (and everything it transitively calls) decides
    from persisted metadata alone (ack records, manifests, journals) and
    never reads object-store payload bytes except through a function
    marked ``@rehydration_entry``. The lint walks the call graph from
    every such root and fails when the contract is broken."""
    fn.__pmem_metadata_only__ = True
    METADATA_ONLY.add(_qualname(fn))
    return fn


def rehydration_entry(fn: Callable) -> Callable:
    """Declare ``fn`` a sanctioned data-movement entry point: its object
    reads are the sources of copies being made (stage-in, replication,
    drain), never blind recovery probes. The metadata-only pass does not
    traverse into it."""
    fn.__pmem_rehydration_entry__ = True
    REHYDRATION_ENTRIES.add(_qualname(fn))
    return fn
