"""One run of one cell: set-up, the measured window, the traced stretch,
the metrics, and the comparison that decides ``correct``.

``Bench`` finds every piece by name under a checkout: the cell and its
configuration in ``BENCHMARK.json``, the configuration's numbers in its
``file``, the mix in ``portbench/traffic/<traffic>.json``, each metric's
reader in ``portbench/metrics/<metric>.py`` and the cell's limits in
``portbench/limits/<cell>.json``; the configuration's layer kinds are
``portbench/reference/<kind>.py`` (``kinds.py``) and the mix's loop is
``portbench/loops/<kind>.py``. ``run_cell`` drives the port's
``repro_torch.serve.engine.ServeEngine`` through that loop.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from portbench import check, loadgen, trace, weights

CHECKOUT = Path(__file__).resolve().parents[1]


class Bench:
    """The benchmark's files under ``root`` (a checkout)."""

    def __init__(self, root: Path = CHECKOUT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "portbench" / "traffic" /
                           f"{name}.json").read_text())

    @staticmethod
    def loop(kind: str):
        """The loop that drives a mix of this ``kind``
        (``portbench/loops/<kind>.py``)."""
        return importlib.import_module(f"portbench.loops.{kind}")

    def limits(self, cell: str) -> Dict[str, dict]:
        """The cell's limits; none before they have been set (a
        calibration run of ``calibrate.py``)."""
        path = self.root / "portbench" / "limits" / f"{cell}.json"
        if not path.is_file():
            return {}
        return json.loads(path.read_text())["limits"]

    def metrics(self, cell: str, traced: bool) -> List[dict]:
        """The cell's end-to-end metrics, or with ``traced`` its
        per-layer ones."""
        group = self.spec["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str) -> Callable:
        path = self.root / "portbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


# ---------------------------------------------------------------------------
# The port, built from the configuration's own numbers
# ---------------------------------------------------------------------------

def model_config(cfg: dict):
    """The port's ``ModelConfig`` from the configuration file: every field
    of the file that ``ModelConfig`` has, the pattern, ``moe`` and
    ``ssm``."""
    from repro_torch.configs import base
    names = {f.name for f in dataclasses.fields(base.ModelConfig)}
    fields = {k: v for k, v in cfg.items()
              if k in names and k not in ("pattern", "moe", "ssm")}
    return base.ModelConfig(
        pattern=tuple(base.LayerSpec(mixer=p["mixer"], mlp=p["mlp"])
                      for p in cfg["pattern"]),
        moe=base.MoEConfig(**cfg["moe"]) if "moe" in cfg else None,
        ssm=base.SSMConfig(**cfg["ssm"]) if "ssm" in cfg else None,
        **fields)


def runtime(cfg: dict):
    """Every kernel route, one device, no recomputation."""
    from repro_torch.models import transformer as tfm
    return tfm.ModelRuntime(tp=1, attn_impl="pallas", ssd_impl="pallas",
                            moe_impl="pallas", rglru_impl="pallas",
                            remat=False, max_seq=cfg["max_seq"])


def check_layout(cfg: dict, mc, rt, dtype=torch.bfloat16) -> None:
    """The benchmark's tree against the port's ``abstract_params``:
    the same names, shapes and dtypes (bfloat16 leaves as ``dtype``)."""
    from repro_torch.models import transformer as tfm
    port = weights.flat_leaves(tfm.abstract_params(mc, rt)[0])
    ours = {x.path: x for x in weights.layout(cfg)}
    diff = []
    for name in sorted(set(port) | set(ours)):
        if name not in port or name not in ours:
            diff.append(f"{name}: {'port only' if name in port else 'ours'}")
            continue
        want = (tuple(port[name].shape), port[name].dtype)
        have = (ours[name].shape, ours[name].dtype)
        if want != have:
            diff.append(f"{name}: port {want}, ours {have}")
    if diff:
        raise ValueError("the benchmark's parameter tree differs from the "
                         "port's:\n  " + "\n  ".join(diff))


def kernel_counters() -> Dict[str, int]:
    """The port's kernel launch counters (each kernel package's
    ``ops.launches`` and ``ops.launches_by_route``), by kernel and
    route."""
    import importlib.util as iu
    import pkgutil
    from repro_torch import kernels
    out = {}
    for pkg in pkgutil.iter_modules(kernels.__path__):
        name = f"repro_torch.kernels.{pkg.name}.ops"
        if not pkg.ispkg or iu.find_spec(name) is None:
            continue
        mod = importlib.import_module(name)
        if hasattr(mod, "launches"):
            out[pkg.name] = mod.launches
            for route, n in getattr(mod, "launches_by_route", {}).items():
                out[f"{pkg.name}.{route}"] = n
    return out


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    cfg: dict
    traffic: dict
    setup_s: float
    window_s: float
    requests: List[dict]
    chunks: List[dict]
    trace: Optional[trace.Trace]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: Bench, cell_name: str, seed: int, seconds: float,
             traced: bool, device="cuda", t_start: Optional[float] = None,
             log: Callable[[str], None] = print,
             engine_hook: Optional[Callable] = None,
             control: bool = False) -> dict:
    """One run. Returns ``{"result": the result line's object without
    ``checks``, "checks": {name: {"value", "limit"}}, "readings": every
    number the comparison read}``. ``t_start`` is the
    process's start on ``time.perf_counter``'s clock (set-up counts from
    it); ``engine_hook(engine)``, when given, may replace parts of the
    engine (the fault tests); ``control`` reads the control's numbers
    instead of the program's (``calibrate.py``)."""
    from repro_torch.serve.engine import ServeEngine
    t_start = time.perf_counter() if t_start is None else t_start
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    limits = bench.limits(cell_name)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        log(f"card: {card_line()}; torch {torch.__version__}, "
            f"cuda {torch.version.cuda}; ready "
            f"{time.perf_counter() - t_start:.3f}s since start")
    mc, rt = model_config(cfg), runtime(cfg)
    dtype = torch.bfloat16 if cfg.get("param_dtype", "bfloat16") == \
        "bfloat16" else torch.float32
    check_layout(cfg, mc, rt)
    params = weights.make(cfg, seed, dev, dtype)
    _sync(dev)
    log(f"weights: {weights.nbytes(cfg)} B made on {dev} in "
        f"{time.perf_counter() - t_start:.3f}s since start")
    engine = ServeEngine(mc, rt, params, device=dev)
    if engine_hook is not None:
        engine_hook(engine)
    gen = loadgen.Traffic(mix, seed, cfg["vocab_size"])
    loop = bench.loop(mix["kind"])
    t_warm = time.perf_counter()
    loop.warm_up(engine, gen)
    _sync(dev)
    log(f"warm-up: {time.perf_counter() - t_warm:.3f}s (prompts of "
        f"{gen.warmup_lengths()})")
    prof = None
    if traced:
        tr = mix["trace"]
        prof = trace.Profiler(tr["skip"], tr["count"], dev.type)
        t_warm = time.perf_counter()
        prof.warm()
        log(f"tracer start-up: {time.perf_counter() - t_warm:.3f}s")
    sample = mix.get("sample", {})
    sampler = check.Sampler(int(sample.get("requests", 4)), seed,
                            gen.batch, int(sample.get("rows", 0)))
    before = kernel_counters()
    _sync(dev)
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    reqs, chunks, w0, w1 = loop.run(engine, gen, seconds, sampler, prof,
                                    traced)
    _sync(dev)
    after = kernel_counters()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    engine.cache = None
    del engine
    launches = {k: after[k] - before[k] for k in after}
    n_req = len(reqs)
    log(f"window: {w1 - w0:.6f}s, {n_req} requests, "
        f"{sum(r['prompt_len'] * r['rows'] for r in reqs)} prompt tokens, "
        f"{sum(r['tokens_out'] for r in reqs)} served tokens, "
        f"{len(chunks)} decode chunks; set-up {setup_s:.6f}s")
    log("kernel launches in the window (per request): " + ", ".join(
        f"{k} {v} ({v / n_req:.2f})" for k, v in launches.items()))
    log(f"peak device memory: {peak} B")
    if chunks:
        log("batch seconds: " + ", ".join(
            f"{r['t_done'] - r['t_issue']:.3f}" for r in reqs))
    tr_obj = prof.reduce() if prof is not None else None
    ctx = Context(cfg, mix, setup_s, w1 - w0, reqs, chunks, tr_obj)
    metrics = {}
    for m in bench.metrics(cell_name, traced):
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t_ref = time.perf_counter()
    samples = sampler.samples()
    readings = (check.control_readings if control else
                check.program_readings)(params, cfg, samples, dev)
    ok, checks = check.judge(readings, limits)
    ok = ok and bool(limits)
    log(f"reference: {len(samples)} sampled requests "
        f"({sum(s['served'].size for s in samples)} served tokens, "
        f"longest prompt {max(s['prompt'].shape[1] for s in samples)}) in "
        f"{time.perf_counter() - t_ref:.3f}s; readings {readings}")
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": sum(r["rows"] for r in reqs),
              "failed": 0, "metrics": metrics, "device": device_info}
    if tr_obj is not None:
        device_info["busy_s"] = tr_obj.busy_s
        device_info["window_s"] = tr_obj.window_s
        result["breakdown"] = tr_obj.breakdown()
    return {"result": result, "checks": checks, "readings": readings}
