"""Elastic restart on the PyTorch port: train on 4 nodes, lose a node,
resume from buddy replicas on the survivors, then shrink the cluster
between runs, all from node-local pmem.

The counterpart of ``examples/elastic_restart.py``: phase A is the port's
training CLI with a node killed after step 8 (``recoveries=[8]``), phase B
the port's elastic launcher, 4 -> 2 nodes. On the card unless
``--device cpu``.

    PYTHONPATH=src python examples/torch_elastic_restart.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import elastic  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print("== phase A: node failure mid-training, buddy recovery ==")
    train_cli.main(["--arch", "starcoder2-15b", "--smoke", "--steps", "12",
                    "--seq", "48", "--batch", "4", "--ckpt-every", "3",
                    "--fault-at", "8", "--device", args.device])
    print("\n== phase B: shrink the cluster between runs (4 -> 2 nodes) ==")
    elastic.main(["--arch", "gemma2-9b", "--steps", "5",
                  "--nodes-before", "4", "--nodes-after", "2",
                  "--device", args.device])


if __name__ == "__main__":
    main()
