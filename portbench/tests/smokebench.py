"""A benchmark checkout at smoke widths for the CPU tests: the real
``BENCHMARK.json``'s metrics and the real readers, mixes and limits
copied into ``root``, plus two small configurations (a grok-1-like MoE
and a mamba2-like SSD, the real files with smaller numbers), three small
mixes and three cells."""
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PB = REPO / "portbench"

GROK = dict(name="grok-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
            max_seq=128, moe={"n_experts": 4, "top_k": 2,
                              "capacity_factor": 1.5,
                              "router_softcap": 30.0})
MAMBA = dict(name="mamba-smoke", n_layers=2, d_model=64, vocab_size=500,
             max_seq=128, ssm={"d_state": 16, "head_dim": 8, "n_groups": 1,
                               "conv_width": 4, "chunk_size": 16,
                               "expand": 2})
PREFILL = {"kind": "prefill", "batch": 1,
           "prompt_len": {"dist": "loguniform", "min": 16, "max": 64,
                          "levels": 8, "strata": 2},
           "gen_tokens": 1, "sample": {"requests": 3},
           "trace": {"skip": 1, "count": 2}}
DECODE = {"kind": "decode", "batch": 4,
          "prompt_len": {"dist": "fixed", "value": 16}, "gen_tokens": 8,
          "chunk": 4, "sample": {"requests": 1, "rows": 4},
          "trace": {"skip": 1, "count": 1}}
CELLS = {"g.pre": ("grok-smoke", "smoke_prefill"),
         "m.pre": ("mamba-smoke", "smoke_prefill"),
         "m.dec": ("mamba-smoke", "smoke_decode")}
#: the real cell each smoke cell stands for (its metrics' lists)
STANDS_FOR = {"grok-1-314b-4L.prefill_online": "g.pre",
              "mamba2-1.3b.prefill_online": "m.pre",
              "mamba2-1.3b.decode_batch256": "m.dec"}
#: limits for float32 smoke runs: the plain routes agree with the
#: reference to ~1e-6
F32_LIMITS = {"state_err": {"limit": 1e-4}, "state_err_p90": {"limit": 1e-4},
              "token_gap": {"limit": 1e-3}}


def make(root: Path, dtype: str = "float32", limits=F32_LIMITS) -> Path:
    root = Path(root)
    (root / "portbench").mkdir(parents=True, exist_ok=True)
    for d in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(PB / d, root / "portbench" / d, dirs_exist_ok=True)
    for base, small in (("grok-1-314b-4L", GROK), ("mamba2-1.3b", MAMBA)):
        cfg = json.loads((PB / "configs" / f"{base}.json").read_text())
        cfg.update(small, param_dtype=dtype)
        (root / "portbench" / "configs" / f"{small['name']}.json") \
            .write_text(json.dumps(cfg))
    for name, mix in (("smoke_prefill", PREFILL), ("smoke_decode", DECODE)):
        (root / "portbench" / "traffic" / f"{name}.json") \
            .write_text(json.dumps(mix))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": n, "file": f"portbench/configs/{n}.json"}
                       for n in ("grok-smoke", "mamba-smoke")]
    spec["workloads"] = [{"name": c, "config": cfg, "traffic": mix,
                          "chips": 1} for c, (cfg, mix) in CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [STANDS_FOR[c] for c in m["workloads"]]
    for cell, (cfg, _) in CELLS.items():
        lim = dict(limits)
        if cfg == "grok-smoke":
            lim["kpos_mismatch"] = {"limit": 0}
        (root / "portbench" / "limits" / f"{cell}.json") \
            .write_text(json.dumps({"limits": lim}))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
