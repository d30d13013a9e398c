"""The port's examples end to end on the CPU (``--device cpu``), as
``tests/test_workflow_pipeline.py`` runs JAX's: the Fig. 8 pipeline over
the dataset exchange (stage-in, in-situ reuse, retain, drain, lineage down
to the external root input, a node-loss resume with zero replays and a
replica read) and the fleet serve flow (bit-exact continuation across a
fork, a node loss and a cross-worker resume, with zero blind probes)."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _run(script: str) -> str:
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / script), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, \
        f"{script} failed:\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout


def test_torch_workflow_pipeline_example_end_to_end():
    out = _run("torch_workflow_pipeline.py")
    for marker in ("stage_in", "in_situ", "retain", "drain"):
        assert marker in out, f"missing {marker} event:\n{out}"
    assert "external:raw_corpus" in out
    assert "produced by train" in out
    assert "replayed []" in out
    assert "1 replica reads" in out


def test_torch_serve_longcontext_example_end_to_end():
    out = _run("torch_serve_longcontext.py")
    assert "catalog says recoverable: ['alice', 'bob']" in out, out
    assert "0 blind probes" in out, out
    assert "bit-exact continuation across fork + node loss + " \
        "cross-worker resume — OK" in out, out
