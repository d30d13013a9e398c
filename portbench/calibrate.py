"""Read the numbers a cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 11,12,... [--control-seeds 21,22,23]

For each of ``--seeds`` it runs the cell as ``run.py`` does (weights
from the seed, warm-up, a window of ``--seconds``, the sample and the
reference) and prints the program's readings; for each of
``--control-seeds`` it prints the control's readings on that seed's
sample (the reference with float8 weights in the program's place, see
``check.py``). One JSON line a seed; the kernels build and the card
starts once. The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
import time

from run import CHECKOUT, _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    _environment()
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.Bench(CHECKOUT)
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t0 = time.perf_counter()
        out = harness.run_cell(bench, args.workload, seed, args.seconds,
                               False, device="cuda", control=control,
                               log=lambda s: print("  " + s))
        metrics = {k: v["value"] for k, v in out["result"]["metrics"].items()}
        print(json.dumps({"seed": seed, "side": "control" if control
                          else "program", "readings": out["readings"],
                          "metrics": metrics,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
