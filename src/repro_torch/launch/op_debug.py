"""Top byte contributors of a saved op trace (perf-iteration tool).

PyTorch counterpart of ``repro/launch/hlo_debug.py``: where that reads a
saved HLO dump, this reads the per-op totals ``launch/op_analysis``
writes (``DRYRUN_SAVE_OPS=<path>`` for a dry-run cell) and prints the
same lines: the total, then ``bytes  op shape xcount :: tag``.

Usage: PYTHONPATH=src python -m repro_torch.launch.op_debug /tmp/cell.ops
"""
from __future__ import annotations

import json
import sys


def breakdown(path: str, top: int = 18):
    with open(path) as fh:
        rec = json.load(fh)
    rows = sorted(rec["ops"], key=lambda r: -r["bytes"])
    print(f"total bytes (unfused model): {rec['bytes']:.3e}")
    for r in rows[:top]:
        key = (f"{r['op']} {r['shape'][:36]} x{r['count']:.0f} :: "
               f"{r['tag'][-60:]}")
        print(f"{r['bytes']:.3e}  {key}")


if __name__ == "__main__":
    breakdown(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 18)
