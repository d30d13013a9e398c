"""The port stands alone: no module of ``src/repro_torch/``, no port
example (``examples/torch_*.py``) and not ``chip_smoke.py`` imports JAX,
ml_dtypes or the JAX package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(ast.parse(path.read_text()))
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("src/repro_torch/serve/engine.py",
                 "src/repro_torch/kernels/flash_attention/ops.py",
                 "src/repro_torch/kernels/rglru/ops.py",
                 "src/repro_torch/kernels/ssd/ops.py",
                 "src/repro_torch/kernels/moe_gmm/ops.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/models/rglru.py",
                 "src/repro_torch/models/ssm.py",
                 "src/repro_torch/core/object_store.py",
                 "src/repro_torch/kernels/ckpt_codec/ops.py",
                 "src/repro_torch/kernels/ckpt_codec/ref.py",
                 "src/repro_torch/core/meta_log.py",
                 "src/repro_torch/core/data_scheduler.py",
                 "src/repro_torch/core/checkpoint.py",
                 "src/repro_torch/core/resilience.py",
                 "src/repro_torch/core/tiered_io.py",
                 "src/repro_torch/core/cluster.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/train/optimizer.py",
                 "src/repro_torch/train/train_step.py",
                 "src/repro_torch/train/loop.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/core/wire_codec.py",
                 "src/repro_torch/core/tiering.py",
                 "src/repro_torch/core/dataset_exchange.py",
                 "src/repro_torch/obs/metrics.py",
                 "src/repro_torch/obs/trace.py",
                 "src/repro_torch/obs/recorder.py",
                 "src/repro_torch/obs/plane.py",
                 "src/repro_torch/obs/report.py",
                 "src/repro_torch/configs/deepseek_coder_33b.py",
                 "src/repro_torch/configs/starcoder2_15b.py",
                 "src/repro_torch/configs/internvl2_26b.py",
                 "src/repro_torch/configs/whisper_tiny.py",
                 "src/repro_torch/analysis/core.py",
                 "src/repro_torch/analysis/persistence.py",
                 "src/repro_torch/analysis/recovery.py",
                 "src/repro_torch/analysis/locks.py",
                 "src/repro_torch/analysis/lint.py",
                 "src/repro_torch/analysis/sanitizer.py",
                 "src/repro_torch/analysis/pytest_plugin.py",
                 "src/repro_torch/launch/elastic.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/distributed/mesh.py",
                 "src/repro_torch/distributed/compat.py",
                 "src/repro_torch/distributed/sharding.py",
                 "src/repro_torch/distributed/decode_attn.py",
                 "src/repro_torch/distributed/moe_parallel.py",
                 "src/repro_torch/distributed/compression.py",
                 "src/repro_torch/distributed/pipeline.py",
                 "examples/torch_quickstart.py",
                 "examples/torch_elastic_restart.py",
                 "examples/torch_serve_longcontext.py",
                 "examples/torch_workflow_pipeline.py", "chip_smoke.py"):
        assert must in names
    # the scan itself sees a forbidden import when there is one
    assert list(_imported(ast.parse("from repro.core import pmem"))) == \
        ["repro.core"]
    assert list(_imported(ast.parse(
        "importlib.import_module('jax.numpy')"))) == ["jax.numpy"]
