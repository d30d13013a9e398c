"""The benchmark's shape: no JAX anywhere under it, ``BENCHMARK.json``
within its contract, the parameter tree equal to the port's, and new
pieces found by name without an existing file edited."""
import ast
import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness, weights
from portbench.tests import smokebench
from portbench.tests.smokebench import PB, REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _top_level_imports(path: Path):
    """Top-level names of every import statement and of every
    ``import_module``/``__import__`` call with a literal name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_nothing_under_the_benchmark_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        bad = _top_level_imports(path) & {"jax", "jaxlib", "ml_dtypes",
                                          "repro", "flax"}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    """The reference and the layer kinds import torch and the benchmark's
    own modules, nothing of the program."""
    allowed = {"__future__", "math", "typing", "torch", "portbench"}
    for path in (PB / "reference").rglob("*.py"):
        assert _top_level_imports(path) <= allowed, path
    for path in (PB / "kinds.py", PB / "weights.py", PB / "work"):
        for f in [path] if path.is_file() else path.rglob("*.py"):
            assert "repro_torch" not in _top_level_imports(f), f


def test_benchmark_json_keeps_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    n = len(SPEC["workloads"])
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(x) for x in names)
    assert len(set(names)) == len(names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (REPO / c["file"]).is_file()
        cfg = json.loads((REPO / c["file"]).read_text())
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == n
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, n // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])
        for cell in m.get("workloads", [w["name"]
                                        for w in SPEC["workloads"]]):
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        cell = w["name"]
        has = [m for m in SPEC["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        assert len(has) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in SPEC["per_layer"])
        assert (PB / "limits" / f"{cell}.json").is_file()


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_the_benchmark_s_tree_is_the_port_s(config):
    bench = harness.Bench(REPO)
    cfg = bench.config(config)
    harness.check_layout(cfg, harness.model_config(cfg),
                         harness.runtime(cfg))
    assert weights.nbytes(cfg) > 1e9


def test_a_changed_tree_is_refused():
    bench = harness.Bench(REPO)
    cfg = dict(bench.config("mamba2-1.3b"))
    mc = harness.model_config(dict(cfg, d_model=1024))
    with pytest.raises(ValueError):
        harness.check_layout(cfg, mc, harness.runtime(cfg))


def _digests(root: Path):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = smokebench.make(tmp_path)
    before = _digests(root / "portbench")
    pb = root / "portbench"
    # a new configuration: three layers of the mamba-like one
    cfg = json.loads((pb / "configs" / "mamba-smoke.json").read_text())
    cfg.update(name="mamba-deeper", n_layers=3)
    (pb / "configs" / "mamba-deeper.json").write_text(json.dumps(cfg))
    mix = dict(smokebench.PREFILL, batch=2)
    (pb / "traffic" / "smoke_pairs.json").write_text(json.dumps(mix))
    (pb / "metrics" / "requests_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx.requests))\n")
    (pb / "limits" / "d.pairs.json").write_text(json.dumps(
        {"limits": smokebench.F32_LIMITS}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "mamba-deeper",
                            "file": "portbench/configs/mamba-deeper.json"})
    spec["workloads"].append({"name": "d.pairs", "config": "mamba-deeper",
                              "traffic": "smoke_pairs", "chips": 1})
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["d.pairs"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = harness.run_cell(harness.Bench(root), "d.pairs", 5, 0.3, False,
                           device="cpu", log=lambda s: None)
    assert out["result"]["correct"], out["readings"]
    assert out["result"]["metrics"]["requests_done"]["value"] >= 1
    assert "setup_s" in out["result"]["metrics"]
    after = _digests(pb)
    assert all(after[p] == d for p, d in before.items())


SWIGLU_KIND = '''"""swiglu: a dense gated MLP (a test's new kind)."""
import torch.nn.functional as F

from portbench.kinds import leaf_bytes
from portbench.reference.lm import mat, rms_norm
from portbench.weights import Leaf

ROLE = "mlp"


def leaves(cfg):
    d, f = cfg["d_model"], cfg["d_ff"]
    return [Leaf("norm2/w", (d,), init="norm"),
            Leaf("mlp/w1", (d, f), std=d ** -0.5),
            Leaf("mlp/w3", (d, f), std=d ** -0.5),
            Leaf("mlp/w2", (f, d), std=f ** -0.5)]


def forward(lp, x, cfg, quant):
    n, m = rms_norm(x, lp["norm2"]["w"]), lp["mlp"]
    h = F.silu(n @ mat(m["w1"], 1, quant)) * (n @ mat(m["w3"], 1, quant))
    return x + h @ mat(m["w2"], 1, quant), {}, {}


def prefill_flops(cfg, batch, s):
    return batch * s * 6.0 * cfg["d_model"] * cfg["d_ff"]


def decode_flops(cfg, batch, pos):
    return prefill_flops(cfg, batch, 1)


def decode_bytes(cfg, batch, pos):
    return leaf_bytes(leaves(cfg))
'''

RUN_NEW_KINDS = """
import json, sys
from portbench import harness
bench = harness.Bench(sys.argv[1])
cfg = bench.config("dense-smoke")
harness.check_layout(cfg, harness.model_config(cfg), harness.runtime(cfg))
out = harness.run_cell(bench, "d.dense", 5, 0.3, False, device="cpu",
                       log=lambda s: None)
from portbench.work import model
print(json.dumps({"correct": out["result"]["correct"],
                  "readings": out["readings"],
                  "metrics": sorted(out["result"]["metrics"]),
                  "flops": model.prefill_flops(cfg, 1, 16)}))
"""


def test_a_new_layer_kind_and_loop_kind_are_found_by_name(tmp_path):
    """A configuration with a layer kind no cell uses yet (the port's
    dense ``swiglu`` MLP, in a file the configuration's ``kinds`` names)
    and a mix of a new loop kind: each a new file in a copy of the
    benchmark, no existing file edited; the run is correct against the
    port's plain routes in float32."""
    import subprocess
    import sys
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    root = smokebench.make(tmp_path)
    pb = root / "portbench"
    before = _digests(pb)
    (pb / "reference" / "dense_swiglu.py").write_text(SWIGLU_KIND)
    (pb / "loops" / "prefill_again.py").write_text(
        "from portbench.loops.prefill import run, warm_up  # noqa: F401\n")
    cfg = json.loads((pb / "configs" / "grok-smoke.json").read_text())
    del cfg["moe"]
    cfg.update(name="dense-smoke", kinds={"swiglu": "dense_swiglu"},
               pattern=[{"mixer": "attn_global", "mlp": "swiglu"}])
    (pb / "configs" / "dense-smoke.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "smoke_again.json").write_text(
        json.dumps(dict(smokebench.PREFILL, kind="prefill_again")))
    (pb / "limits" / "d.dense.json").write_text(json.dumps(
        {"limits": dict(smokebench.F32_LIMITS,
                        kpos_mismatch={"limit": 0})}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dense-smoke",
                            "file": "portbench/configs/dense-smoke.json"})
    spec["workloads"].append({"name": "d.dense", "config": "dense-smoke",
                              "traffic": "smoke_again", "chips": 1})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    proc = subprocess.run(
        [sys.executable, "-c", RUN_NEW_KINDS, str(root)], cwd=root,
        capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ,
             "PYTHONPATH": f"{root}:{REPO / 'src'}"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out
    assert out["readings"]["kpos_mismatch"] == 0
    # 2 layers of 16 tokens: q, k, v, o 2*64*(8 + 4)*16 and SwiGLU
    # 6*64*128 a token; 4*16 (dh) * 4 heads * 136 pairs; the head 2*64*512
    assert out["flops"] == 2 * (16 * (24576 + 49152) + 34816) + 65536
    after = _digests(pb)
    assert all(after[p] == d for p, d in before.items())


def test_the_command_refuses_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files gives no result and a non-zero exit."""
    import subprocess
    import sys
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip().startswith("{")
