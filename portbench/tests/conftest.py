"""The benchmark's own tests (the repository's suite does not collect
them): ``python -m pytest -q portbench/tests`` from the checkout's root.
Tests marked ``cuda`` decide inside the test whether a card is there."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
