"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. Set-up (from this process's start: imports, the card, the
kernels' build or load under ``build/``, weights from the seed, the
warm-up) is followed by the measured window, then the plain reference's
comparison. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit, which are also the last lines of standard error).
Without a card, or with fewer cards than the cell asks for, or if JAX or
the JAX package is loaded once the window has closed, it prints no
result and exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc builds already go to ``build/kernels``), and one
    CPU thread for PyTorch's and OpenMP's pools: the serve path runs its
    work on the card, and idle pool threads only compete with the one
    that launches it on a shared host."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    build = CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    import torch
    from portbench import harness
    bench = harness.Bench(CHECKOUT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda",
                           t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measured process: {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    line = dict(out["result"])
    line["checks"] = out["checks"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
