"""Quickstart on the PyTorch port: train a reduced-config model end to end
with the full pmem systemware stack (staged data, asynchronous node-local
checkpoints with buddy replicas).

The counterpart of ``examples/quickstart.py``: the port's training CLI
(``repro_torch.launch.train``) with the same flags, on the card unless
``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py [--arch gemma2-9b] \
        [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import train as train_cli  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    train_cli.main(["--arch", args.arch, "--smoke",
                    "--steps", str(args.steps), "--seq", "64",
                    "--batch", "8", "--ckpt-every", "10",
                    "--device", args.device])


if __name__ == "__main__":
    main()
