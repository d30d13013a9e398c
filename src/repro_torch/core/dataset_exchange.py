"""The two helpers of ``repro/core/dataset_exchange.py`` that the DLM
ack registry (``tiered_io.DLMAckRegistry``) needs: ``ack_targets`` reads
an ack record's replica holders, ``read_json_copies`` reads every pool's
copy of a replicated record. The dataset catalog, its leases and its
exchange channel wait for ROADMAP Queue A item 2(c)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.core.object_store import PMemObjectStore


def ack_targets(rec: Optional[dict]) -> List[str]:
    """The acked replica holders recorded in one ack entry. Modern
    records carry the full ``targets`` list (repair prunes + extends
    it); legacy records carry a single ``target``, read as a
    one-element list."""
    if not rec:
        return []
    targets = rec.get("targets")
    if targets:
        return list(targets)
    target = rec.get("target")
    return [target] if target else []


def read_json_copies(stores: Dict[str, PMemObjectStore],
                     nodes: Sequence[str], name: str) -> List[dict]:
    """All readable pool copies of a replicated record (callers merge
    with their own semantics). Raises the last error when none read."""
    copies: List[dict] = []
    err: Optional[Exception] = None
    for nid in nodes:
        try:
            copies.append(stores[nid].pool.get_json(name))
        except (IOError, FileNotFoundError, ValueError) as e:
            # ValueError: a torn/truncated JSON copy (media damage on
            # one pool; put_json itself commits atomically). The
            # surviving well-formed copies still win the merge.
            err = e
    if not copies:
        raise err if err is not None else FileNotFoundError(name)
    return copies
