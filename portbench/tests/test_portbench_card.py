"""On the card: the smoke cells through the port's kernels (float32
routes at smoke widths) against the plain reference, and a traced run's
reduction. Run on a machine with a card:
``python -m pytest -q -m cuda portbench/tests``."""
import pytest
import torch

from portbench import harness
from portbench.tests import smokebench


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(smokebench.CELLS))
def test_smoke_cells_through_the_kernels(tmp_path, cell):
    _card()
    bench = harness.Bench(smokebench.make(tmp_path))
    out = harness.run_cell(bench, cell, 2 ** 31 + 3, 1.0, True,
                           device="cuda", log=lambda s: None)
    r = out["result"]
    assert r["correct"], out["readings"]
    assert r["device"]["busy_s"] > 0
    assert r["device"]["window_s"] >= r["device"]["busy_s"]
    assert r["breakdown"]["device_ops"]
