#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port's serve path from the sources in
the checkout, holds each kernel against its plain PyTorch version at the
shapes the path gives it (and times both), then serves gemma2-9b at its
full published size (42 layers, d_model 3584, vocab 256000; random bf16
weights from a seeded generator on the card) through the port's entry
points: prefill, decode, spill to a pmem object store, resume, decode;
holds a short prompt's prefill logits through the kernel against its
plain version at full depth, in bf16 and with the weights in float32;
then runs the serve CLI at its defaults. Every kernel launch counter is
reset just before a path is driven and read just after.

It prints, before the last line, the card's name and power limit as
``nvidia-smi`` gives them and one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without a CUDA device, or outside a checkout, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM published peaks (dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# gemma2-9b attention at request A's prefill shapes
ATTN_B, ATTN_S, ATTN_H, ATTN_KH, ATTN_D = 2, 5120, 16, 8, 256
WINDOW, ATTN_CAP = 4096, 50.0
RAGGED_S = 37
# q scaled by 8 takes the scores into the softcap's bend and concentrates
# the softmax, so a missing cap or a window edge one key off shows (see
# tests/test_torch_flash_attention.py)
Q_SCALE = 8.0
# bf16 outputs carry 8 mantissa bits and the kernel rounds p to bf16 before
# p.v, as the JAX kernel does (the same bound as tests/test_kernels.py);
# each row is also held to ref.BF16_ROW_TOL of its own largest value
KERNEL_TOL = 2e-2
# request B: prefill logits through the kernel against its plain version
# (attn_impl "interpret": float32 scores, p not rounded), through all 42
# layers, as a share of the largest logit. In bf16 every op rounds, and
# any one-ulp difference in a layer's attention grows through the later
# layers: a sound kernel reads 3.0% on the H100, a build without the
# softcap 2.6%, so the bf16 limit (1.3x the sound reading) only guards
# against gross faults. In float32 only summation order and libm differ:
# a sound kernel reads 2.0e-6, the build without the softcap 1.0e-3, and
# the limit is 10x the sound reading (both readings in PERF.md).
LOGIT_REL_TOL = {"bfloat16": 4e-2, "float32": 2e-5}

PROMPT_A, GEN_A, BATCH_A = 5120, 16, 2
PROMPT_B, GEN_B, BATCH_B = 37, 8, 1
EXTRA = 4                     # tokens decoded on each side of a spill


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after one
    warm-up, from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build_kernels():
    """Build the kernel source of the path (the one nvcc call; a second
    kernel's build would start beside it)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    b = build.build("flash_attention", fa_ops.SOURCE)
    print(f"build flash_attention: nvcc {b.seconds:.3f}s -> "
          f"{b.path.relative_to(ROOT)}")
    for line in b.ptxas_report.splitlines():
        if "Function properties" in line or "Used" in line or \
                "spill" in line:
            print(f"  ptxas {line.strip()}")


def attention_bound_ms(b, s, h, kh, d, causal, window, itemsize=2):
    """Least time for the work this run's masks leave: 4*D FLOPs per
    visible (q, k) pair and head, against q/k/v/o read or written once."""
    q = np.arange(s)
    seen = q + 1 if causal else np.full(s, s)
    if window:
        seen = np.minimum(seen, window)
    flops = 4.0 * b * h * d * float(seen.sum())
    nbytes = (2 * b * s * h * d + 2 * b * s * kh * d) * itemsize
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def kernel_phase(device):
    """flash_attention against its plain version at gemma2-9b shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    gen = torch.Generator(device=device).manual_seed(SEED)

    def inputs(s, qscale=1.0):
        q, k, v = [torch.randn((ATTN_B, s, n, ATTN_D), generator=gen,
                               device=device, dtype=torch.float32)
                   for n in (ATTN_H, ATTN_KH, ATTN_KH)]
        return [t.to(torch.bfloat16) for t in (q * qscale, k, v)]

    plain = fa_ops.reference
    cases = {  # name: (S, q scale, masks)
        "global": (ATTN_S, 1.0, dict(causal=True, window=0, cap=ATTN_CAP)),
        "local": (ATTN_S, 1.0,
                  dict(causal=True, window=WINDOW, cap=ATTN_CAP)),
        "ragged": (RAGGED_S, 1.0, dict(causal=True, window=0, cap=ATTN_CAP)),
        "global_q8": (ATTN_S, Q_SCALE,
                      dict(causal=True, window=0, cap=ATTN_CAP)),
        "local_q8": (ATTN_S, Q_SCALE,
                     dict(causal=True, window=WINDOW, cap=ATTN_CAP)),
    }
    results = {}
    for name, (s, qscale, kw) in cases.items():
        q, k, v = inputs(s, qscale)
        got = fa_ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        row_err = fa_ref.row_error(got, want)
        close = torch.allclose(got.float(), want.float(), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
        print(f"kernel flash_attention {name}: B={ATTN_B} S={s} H={ATTN_H} "
              f"Kh={ATTN_KH} D={ATTN_D} q*{qscale} {kw}: max_abs_err={err} "
              f"(atol=rtol={KERNEL_TOL}) row_err={row_err} (tol "
              f"{fa_ref.BF16_ROW_TOL})")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(close, f"flash_attention {name}: max |kernel - plain| {err} "
                     f"beyond atol=rtol={KERNEL_TOL}")
        check(row_err <= fa_ref.BF16_ROW_TOL,
              f"flash_attention {name}: row error {row_err} beyond "
              f"{fa_ref.BF16_ROW_TOL}")
        reps = 10 if s > 1000 else 50
        ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), reps)
        plain_ms = cuda_ms(lambda: plain(q, k, v, **kw), max(reps // 5, 2))
        bound, bound_by = attention_bound_ms(
            ATTN_B, s, ATTN_H, ATTN_KH, ATTN_D, kw["causal"], kw["window"])
        results[name] = dict(max_abs_err=err, row_err=row_err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound,
                             bound_by=bound_by)
        print(f"  kernel_ms={ms} plain_ms={plain_ms} bound_ms={bound} "
              f"({bound_by})")
        del q, k, v, got, want

    # library yardstick: SDPA computes this function only without the
    # softcap, so it is timed on an extra causal cap=0 case, beside the
    # kernel on the same inputs (the port never calls SDPA)
    q, k, v = inputs(ATTN_S)
    kw = dict(causal=True, window=0, cap=0.0)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    lib_err = (sdpa().transpose(1, 2).float() -
               plain(q, k, v, **kw).float()).abs().max().item()
    lib_ms = cuda_ms(sdpa, 10)
    k_ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), 10)
    results["library_cap0"] = dict(library_ms=lib_ms, kernel_ms=k_ms,
                                   library_err=lib_err)
    print(f"library yardstick (causal, cap=0, same shapes): "
          f"scaled_dot_product_attention_ms={lib_ms} kernel_ms={k_ms} "
          f"sdpa max_abs_err vs plain={lib_err}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return results


def pool_root(spill_bytes: int) -> Path:
    """/dev/shm when it has room for twice the spill, else a temp dir on
    disk (core/pmem.py's scratch_root prefers /dev/shm unconditionally)."""
    shm = Path("/dev/shm")
    if shm.is_dir() and shutil.disk_usage(shm).free >= 2 * spill_bytes:
        return Path(tempfile.mkdtemp(prefix="repro_torch_pmem_",
                                     dir=str(shm)))
    return Path(tempfile.mkdtemp(prefix="repro_torch_pmem_"))


def gemma2_9b(device):
    """The full gemma2-9b config, its runtime (the kernel's route) and
    random bf16 parameters made on the card from the seed."""
    import torch
    from repro_torch.bridge import tree_leaves
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm

    cfg = registry.get_config("gemma2-9b")
    rt = tfm.ModelRuntime(tp=1, attn_impl="pallas",
                          max_seq=PROMPT_A + GEN_A + 2 * EXTRA + 8)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = tfm.init_params(cfg, rt, gen, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    print(f"serve {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"vocab={cfg.vocab_size}, {n_params} parameters made on the card "
          f"in {time.perf_counter() - t0:.3f}s")
    return cfg, rt, params


def request_a(device, card: str, cfg, rt, params, prompts):
    """The main path: prefill a long prompt, decode, then the same tokens
    across export/install and across spill/resume."""
    import torch
    from repro_torch.bridge import tree_leaves
    from repro_torch.core.object_store import PMemObjectStore
    from repro_torch.core.pmem import PMemPool
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.serve.engine import ServeEngine

    torch.cuda.reset_peak_memory_stats(device)
    eng = ServeEngine(cfg, rt, params, device=device)
    fa_ops.launches = 0
    t0 = time.perf_counter()
    first = eng.prefill(prompts)
    prefill_s = time.perf_counter() - t0
    launches_prefill = fa_ops.launches
    t0 = time.perf_counter()
    toks = eng.decode(first, GEN_A)
    decode_s = time.perf_counter() - t0
    check(fa_ops.launches == launches_prefill,
          "decode must not launch the prefill kernel")
    check(toks.shape == (BATCH_A, GEN_A + 1), f"tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "token out of vocab")
    spill_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_leaves(eng.cache))
    root = pool_root(spill_bytes)
    try:
        eng.store = PMemObjectStore(PMemPool(root))
        copy = eng.export_state()
        direct = eng.decode(toks[:, -1], EXTRA)
        eng.install_state(copy)
        del copy
        t0 = time.perf_counter()
        eng.spill("request_a")
        spill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.resume("request_a")
        resume_s = time.perf_counter() - t0
        resumed = eng.decode(toks[:, -1], EXTRA)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches_a = fa_ops.launches
    check(np.array_equal(direct, resumed),
          f"tokens differ across spill/resume: {direct} vs {resumed}")
    check(launches_prefill == cfg.n_layers,
          f"flash_attention launched {launches_prefill} times in one "
          f"prefill, want {cfg.n_layers}")
    peak = torch.cuda.max_memory_allocated(device)
    print(f"request A: batch {BATCH_A} prompt {PROMPT_A} +{GEN_A} tokens: "
          f"prefill_s={prefill_s} decode_tok_per_s="
          f"{BATCH_A * GEN_A / decode_s} (decode_s={decode_s}) "
          f"max_memory_allocated={peak} [{card}]")
    medium = "tmpfs /dev/shm" if str(root).startswith("/dev/shm") \
        else "disk"
    print(f"request A: KV state {spill_bytes} bytes, pool {root} "
          f"({medium}), spill_s={spill_s} resume_s={resume_s}")
    print(f"request A: tokens identical across spill/resume: "
          f"{direct.tolist()}")
    print(f"request A: flash_attention launches={launches_a} "
          f"({launches_prefill} per prefill, {cfg.n_layers} layers)")
    return dict(launches=launches_a, prefill_s=prefill_s,
                decode_tok_s=BATCH_A * GEN_A / decode_s, peak_bytes=peak,
                spill_s=spill_s, resume_s=resume_s, spill_bytes=spill_bytes)


def request_b(device, cfg, rt, params, prompts):
    """A short prompt served, then its prefill logits through the kernel
    against its plain version (attn_impl "interpret") on the same
    parameters, in bf16 and with the parameters cast to float32."""
    import torch
    from repro_torch.bridge import tree_map
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, rt, params, device=device)
    fa_ops.launches = 0
    toks = eng.decode(eng.prefill(prompts), GEN_B)
    check(fa_ops.launches == cfg.n_layers,
          f"request B: {fa_ops.launches} launches, want {cfg.n_layers}")
    del eng
    plain_rt = dataclasses.replace(rt, attn_impl="interpret")
    tok_t = torch.as_tensor(prompts, device=device)
    gaps = {}
    for dtype in LOGIT_REL_TOL:
        p = params if dtype == "bfloat16" else \
            tree_map(lambda t: t.to(getattr(torch, dtype)), params)
        before = fa_ops.launches
        with torch.no_grad():
            lk, _ = tfm.prefill(p, cfg, rt, tok_t)
            mid = fa_ops.launches
            lp, _ = tfm.prefill(p, cfg, plain_rt, tok_t)
        torch.cuda.synchronize()
        del p
        check(mid - before == cfg.n_layers and fa_ops.launches == mid,
              f"{dtype}: the kernel prefill must launch {cfg.n_layers} "
              f"times and the plain one none")
        check(bool(torch.isfinite(lk).all()) and
              lk.shape == (BATCH_B, cfg.padded_vocab),
              f"request B {dtype} logits {tuple(lk.shape)} not "
              f"finite/shaped")
        gaps[dtype] = ((lk - lp).abs().max().item(),
                       lp.abs().max().item(),
                       bool((lk.argmax(-1) == lp.argmax(-1)).all()))
    print(f"request B: batch {BATCH_B} prompt {PROMPT_B} +{GEN_B} tokens "
          f"{toks.tolist()}")
    for dtype, (err, scale, same) in gaps.items():
        print(f"request B {dtype}: prefill logits kernel vs its plain "
              f"version: max_abs_err={err} max |logit| {scale} "
              f"rel={err / scale} (tol {LOGIT_REL_TOL[dtype]}) argmax "
              f"equal={same}")
    for dtype, (err, scale, _) in gaps.items():
        check(err <= LOGIT_REL_TOL[dtype] * scale,
              f"request B {dtype} logits: kernel vs plain max |diff| {err} "
              f"> {LOGIT_REL_TOL[dtype]} * {scale}")
    return {f"logit_err_{d}": g[0] for d, g in gaps.items()}


def serve_phase(device, card: str):
    """gemma2-9b served through ServeEngine: request A (the long prompt,
    spill/resume) and request B (kernel vs its plain version)."""
    import torch
    cfg, rt, params = gemma2_9b(device)
    rng = np.random.default_rng(SEED)
    a = rng.integers(0, cfg.vocab_size, (BATCH_A, PROMPT_A)).astype(np.int32)
    b = rng.integers(0, cfg.vocab_size, (BATCH_B, PROMPT_B)).astype(np.int32)
    out = request_a(device, card, cfg, rt, params, a)
    out.update(request_b(device, cfg, rt, params, b))
    del params
    torch.cuda.empty_cache()
    return out


def cli_phase():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    fa_ops.launches = 0
    serve.main([])
    check(fa_ops.launches > 0, "the serve CLI launched no kernel")
    print(f"cli: repro_torch.launch.serve at its defaults: flash_attention "
          f"launches={fa_ops.launches}")
    return fa_ops.launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from the root of a checkout (no "
              "src/repro_torch beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    print(f"device: {name} x{count}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    build_kernels()
    kern = kernel_phase(device)
    serve_res = serve_phase(device, card)
    cli_phase()
    g = kern["global"]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
        "launches": serve_res["launches"],
        "max_abs_err": max(r["max_abs_err"] for n, r in kern.items()
                           if n != "library_cap0"),
        "max_row_err": max(r["row_err"] for n, r in kern.items()
                           if n != "library_cap0"),
        "ms": g["ms"],
        "plain_ms": g["plain_ms"],
        "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"],
        "library_ms": kern["library_cap0"]["library_ms"],
        "shape": f"global layer B={ATTN_B} S={ATTN_S} H={ATTN_H} "
                 f"Kh={ATTN_KH} D={ATTN_D} causal cap={ATTN_CAP}",
        "library_case": "scaled_dot_product_attention, causal cap=0, same "
                        "shapes",
        "local_ms": kern["local"]["ms"],
        "local_plain_ms": kern["local"]["plain_ms"],
        "local_bound_ms": kern["local"]["bound_ms"],
    }]
    print(f"total_s={time.perf_counter() - t_start:.3f}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
