#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port's serve and training paths from
the sources in the checkout (flash attention, the RG-LRU scan, the SSD
scan, the grouped expert matmul gmm, the delta-int8 checkpoint codec's
encode_tiles and decode_tiles; one nvcc a source, side by side), holds
each kernel against its plain PyTorch version at the shapes the paths give
it (and times both), then serves five models at their full published widths through
the port's entry points, one resident at a time, with random weights from
a seeded generator on the card: gemma2-9b (42 layers, d_model 3584),
recurrentgemma-9b (38 layers: 26 RG-LRU, 12 local MQA attention),
mamba2-1.3b (48 SSD layers), and the MoE models grok-1-314b (8 experts,
depth cut to 4 layers) and arctic-480b (128 experts and a dense residual,
depth cut to 2 layers), whose every MoE layer runs gmm three times in
prefill and in each decode step. Each is served prefill, decode, spill to
a pmem object store, resume, decode, and a short ragged prompt's prefill
logits through the kernels are held against the plain versions, in bf16
and in float32 (the MoE models: bf16 at the cut depth, float32 on a fresh
1-layer model). gemma2-9b's long request is also served through the
port's TieredIO on a 2-node SimCluster, as JAX's serve CLI does: a
nonblocking spill into the DLM write-back cache, the buddy replica's
ack, cold eviction, prefetch and a resume from DRAM, then a resume from
the replica after the home node's loss (and once at JAX's default DLM
capacity, which the state bypasses); mamba2-1.3b's session is
replicated through the delta-int8 wire codec, whose encode_tiles and
decode_tiles run on the card on the scheduler's mover threads. Then it
trains gemma2-9b at full width (depth cut to one local and one global
layer) for 4 steps on a 4-node pmem cluster, with a full checkpoint at
step 2 and a delta-int8 one at step 4 encoded on the card, each
replicated to its ring buddy (REPLICATED), and restores both: step 2
bit for bit, step 4 within the codec's per-tile bound, decoded on the
card. Then it runs the serve CLI (through a one-node SimCluster) at its
defaults and for the recurrent and MoE archs, and the training CLI with
delta checkpoints. Every kernel launch counter is reset just before a
path is driven and read just after; flash attention and gmm also count
their launches by route, and every served prefill launch of either must
take the wgmma route. Beside each kernel it times one PyTorch call that
computes the same function where there is one (SDPA at the cap-0
attention shapes, ``torch._grouped_mm`` at gmm's), used nowhere in the
port.

It prints, before the last line, the card's name and power limit as
``nvidia-smi`` gives them and one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. The kernel phases wait
for the card through ``repro_torch.kernels.watchdog``, which raises when
a wait outlasts its 120 s. Every phase after the build, the serve and
training phases included (whose waits lie inside the engine, the
training step and the checkpoint writer), runs under a deadline of
PHASE_DEADLINE_S: past it, ``faulthandler`` prints every thread's stack
and ends the process with exit code 1. So a hung kernel fails the run
instead of hanging it. Any failure raises and exits non-zero; without a
CUDA device, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import faulthandler
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

# H100 SXM published peaks (dense): bf16 tensor cores, HBM3, and float32
# outside the tensor cores (the scans compute in float32, as the reference
# does: TF32 would break parity)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12

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
# the tiered serve path's DLM cache: request A's state (3,183,457,536 B)
# must fit for the resume to be a DRAM hit; at JAX's default capacity it
# bypasses DRAM
TIERED_DLM_CAPACITY = 1 << 32
JAX_DLM_CAPACITY = 1 << 28

# recurrentgemma-9b's local attention at its prefill shapes: MQA (one kv
# head for 16 q heads), head_dim 256, window 2048, no softcap
MQA_B, MQA_S, MQA_H, MQA_KH, MQA_D, MQA_WINDOW = 2, 3000, 16, 1, 256, 2048

# the RG-LRU scan at recurrentgemma-9b's prefill shapes (B, S, W), a case
# ragged in S and W, and a long S that chains 313 sequence tiles; float32 on both sides, so the kernel's chunk
# composition differs from the sequential multiply-adds by ~1e-6 (the
# limit of tests/test_kernels.py)
RGLRU_SHAPES = {"serve": (2, 3000, 4096), "ragged": (3, 37, 100),
                "long": (1, 20000, 256)}
RGLRU_TOL = 1e-5
# the SSD scan at mamba2-1.3b's prefill shapes (B, S, H, P, G, N), and a
# small case ragged against every chunk at the smoke config's P and N; x,
# B, C and y in bf16. y rounds to bf16 once on each side, so the two may
# sit one ulp (2**-7 relative) apart beyond their float32 difference; the
# float32 states differ by summation order only
SSD_SHAPES = {"serve": (2, 4000, 64, 64, 1, 128),
              "ragged": (1, 77, 16, 8, 1, 16)}
SSD_Y_TOL = (1e-3, 2 ** -7 + 1e-3)    # (atol, rtol)
SSD_STATE_TOL = 1e-4

# the recurrent families' requests: (batch, prompt) of the long request,
# as request A; the short ragged one is request B's
RECURRENT = {"recurrentgemma-9b": (2, 3000), "mamba2-1.3b": (2, 4000)}
# the family whose session is replicated through the wire codec
CODEC_ARCH = "mamba2-1.3b"
# the short prompt's prefill logits through the kernels against their
# plain versions (every impl "interpret") at full depth, as a share of
# the largest logit. float32: ~10x the sound readings on the H100
# (1.1e-6 and 3.6e-6); bf16: a guard against gross faults only, as for
# gemma2 (sound readings 0.77% and 0.0; PERF.md)
RECURRENT_LOGIT_TOL = {
    "recurrentgemma-9b": {"bfloat16": 4e-2, "float32": 1e-5},
    "mamba2-1.3b": {"bfloat16": 4e-2, "float32": 4e-5},
}


# the grouped matmul (gmm) at the MoE paths' shapes: (routed rows, D, F,
# E). A prefill of batch 2 x 3000 routes 12,000 rows (top-2); a decode step
# of batch 2 routes 4; the ragged case has D and F off every tile, an empty
# expert and trailing -1 blocks
GMM_CASES = {"grok": (12000, 6144, 32768, 8),
             "arctic": (12000, 7168, 4864, 128),
             "decode": (4, 6144, 32768, 8),
             "ragged": (100, 200, 328, 5)}
# bf16: both sides sum in float32 and round once, so an output may sit one
# bf16 ulp (2**-7 relative at most) from the plain one, plus 1e-4 for
# outputs near zero (outputs are of unit scale: w ~ N(0, 1/D)). float32:
# summation order only over up to 7168 products of unit-scale sums, about
# 1e-6; held to 5e-5 of the case's largest output
GMM_BF16_RTOL, GMM_BF16_ATOL = 2 ** -7, 1e-4
GMM_F32_TOL = 5e-5
# the MoE families at full width, depth cut to fit one card: (layers,
# (batch, prompt)); 4 grok-1 layers are 42.6 GB of bf16 weights, 2 arctic
# layers 55.4 GB. The float32 logit check runs a fresh 1-layer model
MOE = {"grok-1-314b": (4, (2, 3000)), "arctic-480b": (2, (2, 3000))}
# their attention (every layer global, head_dim 128): (q heads, kv heads,
# head_dim, softcap); the flash kernel is checked at these shapes and at
# each prefill's (batch, prompt), with a q*8 twin for the cap's bend
MOE_ATTN = {"grok-1-314b": (48, 8, 128, 30.0),
            "arctic-480b": (56, 8, 128, 0.0)}
# row blocks timed beside choose_bt's pick at the same bf16 inputs, each
# held to the plain version as the pick is (what choose_bt was set from)
GMM_OTHER_BT = {"grok": (64,), "arctic": (16, 32, 64), "decode": (128,)}
# one MoE layer on the long request's own hidden states (its first layer,
# bt 128 over 12,000 routed rows): the kernel route against the same route
# through the plain gmm and against the dense gshard oracle, each token's
# largest |output| the scale. Both sum in float32 and round h, g, silu and
# y to bf16 once, so an output sits a few bf16 ulps from the other's (the
# H100 reads 1.2 ulps against the plain gmm's float32 matmuls and 0 against
# gshard's bf16 ones, PERF.md); the CPU tests hold the sorted route to
# JAX's gshard by the same rule
SERVED_MOE_ULPS = 4
# the short prompt's prefill logits through the kernels (gmm, flash)
# against the plain versions (moe_impl "gshard", the dense oracle;
# attn_impl "interpret"), as a share of the largest logit. float32 at 1
# layer: ~10x the sound readings on the H100 (4.2e-6 grok-1, 2.8e-6
# arctic; summation order only). bf16 at the cut depth: a guard against
# gross faults only, as for the other families (sound readings 1.6% and
# 1.3%: any one-ulp difference, a router logit's included, grows through
# the layers; PERF.md)
MOE_LOGIT_TOL = {
    "grok-1-314b": {"bfloat16": 4e-2, "float32": 4e-5},
    "arctic-480b": {"bfloat16": 4e-2, "float32": 3e-5},
}


# the delta-int8 codec at the training state's shard shapes: gemma2-9b's
# embedding shard (256000 / 4 nodes rows of 3584) in bf16 (a parameter)
# and in float32 (a moment), a ragged 5000-element float32 leaf and the
# int32 step. Kernel and plain version must agree bit for bit.
CODEC_CASES = {"emb_bfloat16": ((64000, 3584), "bfloat16"),
               "emb_float32": ((64000, 3584), "float32"),
               "ragged_float32": ((5000,), "float32"),
               "step_int32": ((), "int32")}
# the training phase: gemma2-9b at full width, n_layers 42 -> 2 (one local,
# one global layer: the config's own period); full depth needs ~111 GB of
# bf16 params and grads and float32 moments, more than one card holds.
# Batch 2 x 2048, AdamW lr 1e-3 (warmup 10), ce_chunk 128, remat on; a
# 4-node cluster, 4 steps, a checkpoint every 2 (full at 2, delta at 4).
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 2, 2, 2048
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_NODES = 4, 2, 4


#: seconds one phase may take before the run counts as hung; a whole run
#: took 261 s on an H100 (PERF.md, section 6)
PHASE_DEADLINE_S = 600


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


def sync() -> None:
    """Wait for the current stream with the watchdog's deadline: a kernel
    that does not finish fails the run instead of hanging it."""
    from repro_torch.kernels import watchdog
    watchdog.synchronize()


def release() -> None:
    """Free what a phase's clusters and engines held: their reference
    cycles (a TieredIO and its checkpointer, a DLM cache and its
    fallback reader) keep host trees and engines, and so parameters on
    the card, alive until the cyclic collector runs."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def run_phase(fn, *args):
    """``fn(*args)`` under PHASE_DEADLINE_S: past it ``faulthandler``
    prints every thread's stack and ends the process with exit code 1.
    This bounds the waits the watchdog does not see."""
    faulthandler.dump_traceback_later(PHASE_DEADLINE_S, exit=True)
    try:
        return fn(*args)
    finally:
        faulthandler.cancel_dump_traceback_later()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after one
    warm-up, from CUDA events (waited on with the watchdog)."""
    import torch
    from repro_torch.kernels import watchdog
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    watchdog.wait_event(end, what="a timed kernel loop")
    return start.elapsed_time(end) / reps


def kernel_ops():
    """Each kernel source's wrapper module, by its build name."""
    from repro_torch.kernels.ckpt_codec import ops as codec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"flash_attention": fa_ops, "rglru": rg_ops, "ssd": ssd_ops,
            "gmm": gmm_ops, "ckpt_codec": codec_ops}


def launch_counters() -> dict:
    """Each kernel's (wrapper module, launch counter), by the kernel's
    name: the codec's source holds two kernels."""
    mods = kernel_ops()
    out = {n: (m, "launches") for n, m in mods.items() if n != "ckpt_codec"}
    out["encode_tiles"] = (mods["ckpt_codec"], "encode_launches")
    out["decode_tiles"] = (mods["ckpt_codec"], "decode_launches")
    return out


def route_counters() -> dict:
    """The wrapper modules that count their launches by route (the
    kernels whose source holds a wgmma route beside others), by name."""
    mods = kernel_ops()
    return {n: mods[n] for n in ("flash_attention", "gmm")}


def reset_launches() -> None:
    for mod, attr in launch_counters().values():
        setattr(mod, attr, 0)
    for mod in route_counters().values():
        mod.launches_by_route = dict.fromkeys(mod.ROUTES, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in launch_counters().items()}


def read_routes() -> dict:
    """Each route-counting kernel's launches by route since the reset."""
    return {name: dict(mod.launches_by_route)
            for name, mod in route_counters().items()}


def check_wgmma(name: str, launches: dict, routes: dict) -> None:
    """Every launch of flash_attention and gmm in a served prefill went by
    the wgmma route."""
    for kernel, by_route in routes.items():
        check(by_route.get("wgmma", 0) == launches[kernel] and
              sum(by_route.values()) == launches[kernel],
              f"{name}: {kernel} launches {launches[kernel]} by route "
              f"{by_route}: every prefill launch must take wgmma")


def build_kernels():
    """Build the kernel sources of the paths: one nvcc each, all started
    together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    mods = kernel_ops()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        futs = {n: pool.submit(build.build, n, m.SOURCE)
                for n, m in mods.items()}
        built = {n: f.result() for n, f in futs.items()}
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.3f}s")
    for name, b in built.items():
        print(f"build {name}: nvcc {b.seconds:.3f}s -> "
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
    """flash_attention against its plain version at the prefill shapes of
    every served model's attention layers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    gen = torch.Generator(device=device).manual_seed(SEED)

    gemma = (ATTN_B, ATTN_H, ATTN_KH, ATTN_D)
    mqa = (MQA_B, MQA_H, MQA_KH, MQA_D)

    def inputs(s, qscale=1.0, shape=gemma):
        b, h, kh, d = shape
        q, k, v = [torch.randn((b, s, n, d), generator=gen,
                               device=device, dtype=torch.float32)
                   for n in (h, kh, kh)]
        return [t.to(torch.bfloat16) for t in (q * qscale, k, v)]

    plain = fa_ops.reference
    cases = {  # name: (S, q scale, masks[, (B, H, Kh, D)])
        "global": (ATTN_S, 1.0, dict(causal=True, window=0, cap=ATTN_CAP)),
        "local": (ATTN_S, 1.0,
                  dict(causal=True, window=WINDOW, cap=ATTN_CAP)),
        "ragged": (RAGGED_S, 1.0, dict(causal=True, window=0, cap=ATTN_CAP)),
        "global_q8": (ATTN_S, Q_SCALE,
                      dict(causal=True, window=0, cap=ATTN_CAP)),
        "local_q8": (ATTN_S, Q_SCALE,
                     dict(causal=True, window=WINDOW, cap=ATTN_CAP)),
        # recurrentgemma-9b's local layers
        "local_mqa": (MQA_S, 1.0,
                      dict(causal=True, window=MQA_WINDOW, cap=0.0), mqa),
        "local_mqa_q8": (MQA_S, Q_SCALE,
                         dict(causal=True, window=MQA_WINDOW, cap=0.0), mqa),
    }
    # grok-1's and arctic's layers: moe_grok, moe_arctic and q*8 twins
    for arch, (h, kh, d, cap) in MOE_ATTN.items():
        b, s = MOE[arch][1]
        tag = "moe_" + arch.split("-")[0]
        kw = dict(causal=True, window=0, cap=cap)
        cases[tag] = (s, 1.0, kw, (b, h, kh, d))
        cases[tag + "_q8"] = (s, Q_SCALE, kw, (b, h, kh, d))
    results = {}
    for name, (s, qscale, kw, *shape) in cases.items():
        b, h, kh, d = shape[0] if shape else gemma
        q, k, v = inputs(s, qscale, (b, h, kh, d))
        got = fa_ops.flash_attention(q, k, v, **kw)
        sync()
        want = plain(q, k, v, **kw)
        sync()
        err = (got.float() - want.float()).abs().max().item()
        row_err = fa_ref.row_error(got, want)
        close = torch.allclose(got.float(), want.float(), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
        print(f"kernel flash_attention {name}: B={b} S={s} H={h} "
              f"Kh={kh} D={d} q*{qscale} {kw} route "
              f"{fa_ops.route(q, k)}: max_abs_err={err} "
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
            b, s, h, kh, d, kw["causal"], kw["window"])
        results[name] = dict(max_abs_err=err, row_err=row_err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound,
                             bound_by=bound_by, route=fa_ops.route(q, k))
        print(f"  kernel_ms={ms} plain_ms={plain_ms} bound_ms={bound} "
              f"({bound_by})")
        del q, k, v, got, want

    # library yardsticks, timed beside the kernel on the same inputs (the
    # port never calls SDPA). SDPA computes the kernel's function only
    # without the softcap: on an extra gemma2 global case at cap 0, at
    # moe_arctic (cap 0 already) and at local_mqa (cap 0) with a boolean
    # mask of the causal window, built once outside the timed call
    for tag, (s, shape, kw) in {
            "library_cap0": (ATTN_S, gemma,
                             dict(causal=True, window=0, cap=0.0)),
            "library_moe_arctic": (
                MOE["arctic-480b"][1][1],
                (MOE["arctic-480b"][1][0],) + MOE_ATTN["arctic-480b"][:3],
                dict(causal=True, window=0, cap=0.0)),
            "library_local_mqa": (MQA_S, mqa, dict(
                causal=True, window=MQA_WINDOW, cap=0.0))}.items():
        q, k, v = inputs(s, 1.0, shape)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if kw["window"]:
            pos = torch.arange(s, device=device)
            mask = (pos[:, None] >= pos[None, :]) & \
                (pos[None, :] > pos[:, None] - kw["window"])

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
        else:
            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        want = plain(q, k, v, **kw)
        try:  # the yardstick only; the port never calls it
            lib_err = (sdpa().transpose(1, 2).float() -
                       want.float()).abs().max().item()
            lib_ms, note = cuda_ms(sdpa, 10), f"max_abs_err vs plain {lib_err}"
        except RuntimeError as err:
            lib_ms, note = None, "SDPA refused these inputs: " + \
                str(err).splitlines()[0]
        k_ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), 10)
        results[tag] = dict(library_ms=lib_ms, kernel_ms=k_ms, note=note)
        print(f"library yardstick {tag} (B, H, Kh, D)={shape} S={s} {kw}: "
              f"scaled_dot_product_attention_ms={lib_ms} kernel_ms={k_ms} "
              f"route {fa_ops.route(q, k)} ({note})")
        del q, k, v, qt, kt, vt, want
    torch.cuda.empty_cache()
    return results


def rglru_bound_ms(b, s, w):
    """Least time for the RG-LRU scan: two float32 inputs read and one
    output written once, against 5 float32 operations per element (exp,
    expm1, sqrt, two multiply-adds counted as one each)."""
    t_mem = 3 * 4 * b * s * w / PEAK_HBM_BYTES * 1e3
    t_ops = 5.0 * b * s * w / PEAK_F32_FLOPS * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def ssd_bound_ms(b, s, h, p, g, n, itemsize=2):
    """Least time for the SSD scan: 4 P N float32 operations per token
    and head (the rescaled form's update and read-out, fused multiply-adds
    counted as 2; the fewest of the kernel's two forms, and fewer than the
    chunked form's: a run the kernel takes step by step does 5 P N, so
    this is the least time whatever runs the kernel rescales), against x,
    y, B and C (itemsize), dt and a (float32) read or written once and
    the float32 state written once."""
    flops = 4.0 * b * s * h * p * n
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * itemsize + \
        4 * (b * s * h + h + b * h * p * n)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_mem = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def scan_kernel_phase(device):
    """The RG-LRU and SSD scans against their plain versions at the
    recurrent models' prefill shapes and at ragged small ones."""
    import torch
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    gen = torch.Generator(device=device).manual_seed(SEED)

    def rand(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=gen, device=device)
        return u * (hi - lo) + lo

    def randn(shape):
        return torch.randn(shape, generator=gen, device=device)

    results = {}
    for name, (b, s, w) in RGLRU_SHAPES.items():
        # log_a in (-0.2, 0), as the block's -8 softplus(lam) r gives
        log_a, gated = rand((b, s, w), -0.2, -1e-3), randn((b, s, w))
        got = rg_ops.rglru(log_a, gated)
        sync()
        want = rg_ops.reference(log_a, gated)
        err = (got - want).abs().max().item()
        print(f"kernel rglru {name}: B={b} S={s} W={w} float32: "
              f"max_abs_err={err} (atol=rtol={RGLRU_TOL}) max|h|="
              f"{want.abs().max().item()}")
        check(bool(torch.isfinite(got).all()), f"rglru {name}: non-finite")
        check(torch.allclose(got, want, atol=RGLRU_TOL, rtol=RGLRU_TOL),
              f"rglru {name}: max |kernel - plain| {err} beyond "
              f"atol=rtol={RGLRU_TOL}")
        reps = 20 if s > 1000 else 50
        ms = cuda_ms(lambda: rg_ops.rglru(log_a, gated), reps)
        plain_ms = cuda_ms(lambda: rg_ops.reference(log_a, gated), 2)
        bound, bound_by = rglru_bound_ms(b, s, w)
        results[f"rglru_{name}"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, bound_ms=bound,
                                        bound_by=bound_by)
        print(f"  kernel_ms={ms} plain_ms={plain_ms} bound_ms={bound} "
              f"({bound_by})")
        del log_a, gated, got, want
    atol, rtol = SSD_Y_TOL
    for name, (b, s, h, p, g, n) in SSD_SHAPES.items():
        # dt and A in the ranges the mamba2 init gives (decay exp(-dt A)
        # from 0.2 to ~1: long memories), x, B and C of unit scale
        dt = torch.exp(rand((b, s, h), np.log(1e-3), np.log(1e-1)))
        a = -rand((h,), 1.0, 16.0)
        x, bb, cc = (randn(shape).to(torch.bfloat16)
                     for shape in ((b, s, h, p), (b, s, g, n), (b, s, g, n)))
        y, st = ssd_ops.ssd(x, dt, a, bb, cc)
        sync()
        want_y, want_st = ssd_ops.reference(x, dt, a, bb, cc)
        err = (y.float() - want_y.float()).abs().max().item()
        st_err = (st - want_st).abs().max().item()
        print(f"kernel ssd {name}: B={b} S={s} H={h} P={p} G={g} N={n} "
              f"bfloat16: y max_abs_err={err} (atol={atol}, rtol={rtol}) "
              f"max|y|={want_y.float().abs().max().item()}; state "
              f"max_abs_err={st_err} (atol=rtol={SSD_STATE_TOL}) "
              f"max|state|={want_st.abs().max().item()}")
        check(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
              f"ssd {name}: non-finite")
        check(torch.allclose(y.float(), want_y.float(), atol=atol,
                             rtol=rtol),
              f"ssd {name}: y beyond atol={atol} rtol={rtol} ({err})")
        check(torch.allclose(st, want_st, atol=SSD_STATE_TOL,
                             rtol=SSD_STATE_TOL),
              f"ssd {name}: state beyond {SSD_STATE_TOL} ({st_err})")
        reps = 10 if s > 1000 else 50
        ms = cuda_ms(lambda: ssd_ops.ssd(x, dt, a, bb, cc), reps)
        plain_ms = cuda_ms(lambda: ssd_ops.reference(x, dt, a, bb, cc), 2)
        bound, bound_by = ssd_bound_ms(b, s, h, p, g, n)
        results[f"ssd_{name}"] = dict(max_abs_err=err, state_err=st_err,
                                      ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound, bound_by=bound_by)
        print(f"  kernel_ms={ms} plain_ms={plain_ms} bound_ms={bound} "
              f"({bound_by})")
        del x, dt, a, bb, cc, y, st, want_y, want_st
    print("library yardstick for rglru and ssd: none (no single PyTorch "
          "call computes either recurrence)")
    torch.cuda.empty_cache()
    return results


def gmm_bound_ms(rows, d, f, experts, itemsize=2, peak=PEAK_BF16_FLOPS):
    """Least time for one gmm from this routing: 2 D F operations per
    real row, against the real rows of x and out and the weights of the
    experts that hold a row, each read or written once."""
    flops = 2.0 * rows * d * f
    nbytes = (rows * d + rows * f + experts * d * f) * itemsize
    t_ops = flops / peak * 1e3
    t_mem = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def grouped_mm_ms(buf, w, ends, want, reps):
    """The library yardstick: ``torch._grouped_mm`` on the same padded
    groups (offsets at the group ends), where this torch has it; the port
    never calls it. Returns (ms or None, max |diff| vs the plain version or
    the reason it is None)."""
    import torch
    if not hasattr(torch, "_grouped_mm"):
        return None, "this torch has no torch._grouped_mm"
    live = int(ends[-1])
    a, offs = buf[:live], ends.to(torch.int32)
    tried = []
    for b in (w, w.transpose(1, 2).contiguous().transpose(1, 2)):
        try:
            out = torch._grouped_mm(a, b, offs=offs)
            sync()
        except RuntimeError as err:  # the yardstick only; not the port
            tried.append(str(err).splitlines()[0])
            continue
        err = (out.float() - want[:live].float()).abs().max().item()
        return (cuda_ms(lambda: torch._grouped_mm(a, b, offs=offs), reps),
                f"max |diff| vs plain {err}")
    return None, "torch._grouped_mm refused these inputs: " + \
        " | ".join(tried)


def gmm_kernel_phase(device):
    """gmm against its plain version at grok-1's and arctic's prefill
    shapes, a decode step and a ragged case, in bf16 and float32, with
    the routing laid out by the port's own sort_tokens_by_expert; in bf16
    also at the other row blocks of GMM_OTHER_BT."""
    import torch
    from repro_torch.kernels.moe_gmm import ops as gmm_ops

    results = {}
    for name, (t, d, f, e) in GMM_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=device).manual_seed(SEED)
            ids = torch.randint(0, e, (t,), generator=gen, device=device)
            if name == "ragged":
                ids[ids == 1] = 0  # an empty expert
            x = torch.randn((t, d), generator=gen, device=device).to(dtype)
            w = torch.randn((e, d, f), generator=gen, device=device)
            w = w.div_(d ** 0.5).to(dtype)
            counts = torch.bincount(ids, minlength=e)
            experts = int((counts > 0).sum())
            bf16 = dtype == torch.bfloat16
            big = t * d * f > 1e11
            reps = (5 if big else 20) if bf16 else 1
            tag = f"{name}_{str(dtype)[6:]}"
            pick = gmm_ops.choose_bt(t, e)
            ms_by_bt, errs = {}, []
            others = GMM_OTHER_BT.get(name, ()) if bf16 else ()
            for bt in (pick,) + tuple(b for b in others if b != pick):
                buf, be, _ = gmm_ops.sort_tokens_by_expert(x, ids, e, bt)
                got = gmm_ops.gmm(buf, w, be, bt=bt)
                sync()
                want = gmm_ops.reference(buf, w, be, bt)
                sync()
                diff = (got.float() - want.float()).abs()
                err = diff.max().item()
                errs.append(err)
                scale = want.float().abs().max().item()
                if bf16:
                    ok = bool((diff <= GMM_BF16_RTOL * want.float().abs() +
                               GMM_BF16_ATOL).all())
                    tol = f"rtol={GMM_BF16_RTOL} atol={GMM_BF16_ATOL}"
                else:
                    ok = err <= GMM_F32_TOL * scale
                    tol = f"{GMM_F32_TOL} of max |out| {scale}"
                pad = be.repeat_interleave(bt) < 0
                print(f"kernel gmm {tag}: rows={t} D={d} F={f} E={e} bt={bt}"
                      f"{'' if bt == pick else ' (not chosen)'} route "
                      f"{gmm_ops.gmm_route(buf, w, bt)} buffer="
                      f"{buf.shape[0]} rows, experts used {experts}, -1 "
                      f"blocks {int((be < 0).sum())}: max_abs_err={err} "
                      f"({tol})")
                check(bool(torch.isfinite(got).all()),
                      f"gmm {tag} bt {bt}: non-finite")
                check(ok, f"gmm {tag} bt {bt}: kernel vs plain {err} beyond "
                          f"{tol}")
                check(int(torch.count_nonzero(got[pad])) == 0,
                      f"gmm {tag} bt {bt}: -1 blocks not zero")
                ms_by_bt[bt] = cuda_ms(lambda: gmm_ops.gmm(buf, w, be, bt=bt),
                                       reps)
                if bt != pick:
                    print(f"  kernel_ms={ms_by_bt[bt]}")
                    del buf, be, got, want, diff, pad
                    continue
                bound, bound_by = gmm_bound_ms(
                    t, d, f, experts, torch.finfo(dtype).bits // 8,
                    PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
                plain_ms = cuda_ms(
                    lambda: gmm_ops.reference(buf, w, be, bt),
                    1 if big else 5)
                lib_ms, lib_note = None, "float32: the yardstick is bf16 only"
                if bf16:
                    ends = torch.cumsum((counts + bt - 1) // bt * bt, 0)
                    lib_ms, lib_note = grouped_mm_ms(buf, w, ends, want, reps)
                results[tag] = dict(max_abs_err=err, ms=ms_by_bt[bt],
                                    plain_ms=plain_ms, bound_ms=bound,
                                    bound_by=bound_by, library_ms=lib_ms,
                                    bt=bt, ms_by_bt=ms_by_bt,
                                    route=gmm_ops.gmm_route(buf, w, bt))
                print(f"  kernel_ms={ms_by_bt[bt]} plain_ms={plain_ms} "
                      f"bound_ms={bound} ({bound_by}) library_ms={lib_ms} "
                      f"(torch._grouped_mm: {lib_note})")
                del buf, be, got, want, diff, pad
            results[tag]["max_abs_err"] = max(errs)
            del x, w
            torch.cuda.empty_cache()
    return results


def pool_root(need_bytes: int) -> Path:
    """/dev/shm when it has room for ``need_bytes``, else a temp dir on
    disk (core/pmem.py's scratch_root prefers /dev/shm unconditionally);
    fails when neither has room."""
    shm = Path("/dev/shm")
    if shm.is_dir() and shutil.disk_usage(shm).free >= need_bytes:
        return Path(tempfile.mkdtemp(prefix="repro_torch_pmem_",
                                     dir=str(shm)))
    tmp = Path(tempfile.gettempdir())
    free = shutil.disk_usage(tmp).free
    check(free >= need_bytes, f"no room for {need_bytes} B of pmem pools: "
                              f"/dev/shm and {tmp} ({free} B free) are "
                              f"both too small")
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
    sync()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    print(f"serve {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"vocab={cfg.vocab_size}, {n_params} parameters made on the card "
          f"in {time.perf_counter() - t0:.3f}s")
    return cfg, rt, params


def request_a(device, card: str, cfg, rt, params, prompts):
    """The main path: prefill a long prompt, decode, then the same tokens
    across export/install, across spill/resume through the direct store
    and through TieredIO (``tiered_request_a``)."""
    import torch
    from repro_torch.bridge import tree_leaves
    from repro_torch.core.object_store import PMemObjectStore
    from repro_torch.core.pmem import PMemPool
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.serve.engine import ServeEngine

    torch.cuda.reset_peak_memory_stats(device)
    eng = ServeEngine(cfg, rt, params, device=device)
    reset_launches()
    t0 = time.perf_counter()
    first = eng.prefill(prompts)
    prefill_s = time.perf_counter() - t0
    launches_prefill = fa_ops.launches
    routes = read_routes()
    check_wgmma("request A prefill", read_launches(), routes)
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
    root = pool_root(2 * spill_bytes)
    try:
        eng.store = PMemObjectStore(PMemPool(root))
        copy = eng.export_state()
        direct = eng.decode(toks[:, -1], EXTRA)
        eng.install_state(copy)
        t0 = time.perf_counter()
        eng.spill("request_a")
        spill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.resume("request_a")
        resume_s = time.perf_counter() - t0
        resumed = eng.decode(toks[:, -1], EXTRA)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    eng.cache = None
    launches_a = fa_ops.launches
    peak = torch.cuda.max_memory_allocated(device)
    check(np.array_equal(direct, resumed),
          f"tokens differ across spill/resume: {direct} vs {resumed}")
    check(launches_prefill == cfg.n_layers,
          f"flash_attention launched {launches_prefill} times in one "
          f"prefill, want {cfg.n_layers}")
    tiered = tiered_request_a(device, card, cfg, rt, params, copy,
                              toks[:, -1], direct)
    del copy
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
          f"({launches_prefill} per prefill, {cfg.n_layers} layers); "
          f"prefill launches by route {routes}")
    return dict(launches=launches_a, routes=routes, prefill_s=prefill_s,
                decode_tok_s=BATCH_A * GEN_A / decode_s, peak_bytes=peak,
                spill_s=spill_s, resume_s=resume_s, spill_bytes=spill_bytes,
                tiered=tiered)


def state_bits_equal(a: dict, b: dict) -> bool:
    """Two session states (``{"cache", "pos"}``, host or device leaves)
    equal leaf for leaf and bit for bit."""
    from repro_torch.bridge import to_numpy, tree_leaves
    la, lb = tree_leaves(a["cache"]), tree_leaves(b["cache"])
    return [p for p, _ in la] == [p for p, _ in lb] and \
        all(np.array_equal(to_numpy(x), to_numpy(y))
            for (_, x), (_, y) in zip(la, lb)) and \
        int(a["pos"]) == int(b["pos"])


def tiered_request_a(device, card: str, cfg, rt, params, state, last,
                     direct):
    """Request A's state served through the port's TieredIO, as JAX's
    serve CLI does, on a 2-node SimCluster: a nonblocking spill into the
    DLM write-back cache, its durable write, the buddy replica's ack on
    node1, cold eviction, ``peek_session`` of the cursor and of a KV
    page from the home pool, a prefetch and a resume from DRAM (a DLM
    hit); then the home node's loss and a fresh engine's resume through
    the replica fallback. Every resume decodes the tokens the direct
    path decoded. Last, the same spill and resume at JAX's default DLM
    capacity, which the state exceeds: it bypasses DRAM."""
    import torch
    from repro_torch.bridge import to_numpy, tree_leaves
    from repro_torch.core.cluster import SimCluster
    from repro_torch.serve.engine import ServeEngine

    nbytes = sum(t.numel() * t.element_size()
                 for _, t in tree_leaves(state["cache"]))
    check(nbytes <= TIERED_DLM_CAPACITY, f"request A's state {nbytes} B "
          f"exceeds the DLM capacity {TIERED_DLM_CAPACITY}")
    name, obj = "request_a", "dlm/serve/request_a"
    page_path, page = tree_leaves(state["cache"])[0]
    out = {}
    root = pool_root(2 * nbytes + (1 << 30))
    reset_launches()
    try:
        cluster = SimCluster(root, n_nodes=2,
                             pmem_capacity=nbytes + (1 << 30),
                             dlm_capacity=TIERED_DLM_CAPACITY,
                             device=device)
        try:
            eng = ServeEngine(cfg, rt, params, tiered=cluster.tiered,
                              device=device)
            eng.install_state(state)
            sync()
            t0 = time.perf_counter()
            ticket = eng.spill(name, wait=False)
            out["spill_return_s"] = time.perf_counter() - t0
            ticket.result()
            out["durable_s"] = time.perf_counter() - t0
            errors = cluster.tiered.quiesce()
            out["acked_s"] = time.perf_counter() - t0
            check(errors == [], f"tiered request A: in-flight errors "
                                f"{errors}")
            check(cluster.tiered.dlm_acks.targets(obj) == ["node1"],
                  f"tiered request A: acks {cluster.tiered.dlm_acks.objects()}")
            check(eng.evict_cold_sessions() == 1,
                  "tiered request A: the spilled session was not resident")
            check(int(eng.peek_session(name, "pos")) == int(state["pos"]),
                  "tiered request A: peek_session of pos")
            got = eng.peek_session(name, "cache/" + page_path)
            check(np.array_equal(to_numpy(got), to_numpy(page)),
                  f"tiered request A: peek_session of {page_path}")
            t0 = time.perf_counter()
            res = eng.prefetch_sessions([name]).result()
            out["prefetch_s"] = time.perf_counter() - t0
            check(res == {"hits": 0, "loads": 1, "missing": 0},
                  f"tiered request A: prefetch {res}")
            hits = cluster.dlm.hits
            t0 = time.perf_counter()
            eng.resume(name)
            sync()
            out["resume_s"] = time.perf_counter() - t0
            check(cluster.dlm.hits == hits + 1,
                  "tiered request A: the resume was not a DLM hit")
            toks = eng.decode(last, EXTRA)
            check(np.array_equal(toks, direct), f"tiered request A: tokens "
                  f"{toks} after prefetch/resume, want {direct}")
            eng.cache = None
            check(eng.evict_cold_sessions() == 1,
                  "tiered request A: the prefetched session was not "
                  "resident")
            cluster.kill_node("node0")
            fresh = ServeEngine(cfg, rt, params, tiered=cluster.tiered,
                                device=device)
            t0 = time.perf_counter()
            fresh.resume(name)
            sync()
            out["replica_resume_s"] = time.perf_counter() - t0
            toks = fresh.decode(last, EXTRA)
            check(np.array_equal(toks, direct), f"tiered request A: tokens "
                  f"{toks} after the home node's loss, want {direct}")
            del fresh
        finally:
            cluster.shutdown()
            shutil.rmtree(root, ignore_errors=True)
        # JAX's default capacity: the state bypasses DRAM both ways
        cluster = SimCluster(root, n_nodes=2,
                             pmem_capacity=nbytes + (1 << 30),
                             dlm_capacity=JAX_DLM_CAPACITY, device=device)
        try:
            eng = ServeEngine(cfg, rt, params, tiered=cluster.tiered,
                              device=device)
            eng.install_state(state)
            sync()
            t0 = time.perf_counter()
            eng.spill(name)
            out["bypass_spill_s"] = time.perf_counter() - t0
            check(cluster.tiered.quiesce() == [] and
                  not cluster.dlm.contains(f"serve/{name}"),
                  "tiered request A at the default capacity: errors or "
                  "the state was cached")
            t0 = time.perf_counter()
            eng.resume(name)
            sync()
            out["bypass_resume_s"] = time.perf_counter() - t0
            out["bypasses"] = cluster.dlm.bypasses
            check(cluster.dlm.bypasses == 2, f"tiered request A at the "
                  f"default capacity: {cluster.dlm.bypasses} bypasses, "
                  f"want 2 (spill and resume)")
            toks = eng.decode(last, EXTRA)
            check(np.array_equal(toks, direct), f"tiered request A: tokens "
                  f"{toks} after the bypassing resume, want {direct}")
        finally:
            cluster.shutdown()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = read_launches()
    check(not any(out["launches"].values()),
          f"tiered request A: kernels launched {out['launches']}; "
          f"resumes decode from the spilled state, with no prefill and "
          f"no wire codec")
    del eng
    release()
    print(f"request A tiered (2-node SimCluster, DLM capacity "
          f"{TIERED_DLM_CAPACITY} B, state {nbytes} B): spill(wait=False) "
          f"returned in {out['spill_return_s']} s, durable at "
          f"{out['durable_s']} s, replica acked on node1 at "
          f"{out['acked_s']} s; prefetch_s={out['prefetch_s']} (1 load) "
          f"resume_s={out['resume_s']} (DLM hit); after node0's loss "
          f"replica_resume_s={out['replica_resume_s']}; kernel launches "
          f"{out['launches']} [{card}]")
    print(f"request A tiered: tokens identical across spill -> prefetch "
          f"-> resume and after the home node's loss; peek_session of pos "
          f"and {page_path} equal to the exported state")
    print(f"request A tiered at JAX's default DLM capacity "
          f"{JAX_DLM_CAPACITY} B: dlm.bypasses={out['bypasses']} "
          f"spill_s={out['bypass_spill_s']} resume_s="
          f"{out['bypass_resume_s']}; tokens identical [{card}]")
    out["state_bytes"] = nbytes
    return out


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
        sync()
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
    release()
    return out


def layer_counts(cfg, decode: bool = False) -> dict:
    """The launches of each kernel in one prefill (one per layer of the
    kernel's mixer, three gmm per MoE layer), or in one decode step (the
    three gmm of each MoE layer only)."""
    from repro_torch.configs.base import MLP_MOE, RGLRU, SSD
    counts = {name: 0 for name in launch_counters()}
    for period, reps in cfg.groups:
        for spec in period:
            if not decode:
                counts[{RGLRU: "rglru", SSD: "ssd"}.get(
                    spec.mixer, "flash_attention")] += reps
            if spec.mlp == MLP_MOE:
                counts["gmm"] += 3 * reps
    return counts


def peak_line(device, step: str) -> int:
    """Print and return the peak device memory since the last reset, then
    reset it for the next step."""
    import torch
    peak = torch.cuda.max_memory_allocated(device)
    print(f"  peak device memory, {step}: {peak} B")
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def recurrent_model(device, arch: str, prompt: int):
    """A recurrent family's full config, its runtime (every kernel's
    route, ModelRuntime's defaults) and random bf16 parameters (float32
    decay parameters) made on the card from the seed."""
    import torch
    from repro_torch.bridge import tree_leaves
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm

    cfg = registry.get_config(arch)
    rt = tfm.ModelRuntime(tp=1, max_seq=prompt + GEN_A + 2 * EXTRA + 8)
    check((rt.attn_impl, rt.rglru_impl, rt.ssd_impl) ==
          ("pallas",) * 3, "the runtime's defaults must be the kernels")
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = tfm.init_params(cfg, rt, gen, device=device)
    sync()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    print(f"serve {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"vocab={cfg.vocab_size} kernels per prefill "
          f"{layer_counts(cfg)}, {n_params} parameters made on the card in "
          f"{time.perf_counter() - t0:.3f}s")
    return cfg, rt, params


def model_request(device, card: str, cfg, rt, params, prompts):
    """A family's main path, as request A: prefill a long prompt, decode,
    then the same tokens across export/install and across spill/resume of
    the state (bf16 KV, float32 recurrent state and bf16 windows), and the
    resumed state equal to the spilled one, leaf for leaf and bit for
    bit (a random-weight model's greedy tokens may not depend on it).
    Launches are counted per prefill and per decode step."""
    import torch
    from repro_torch.bridge import to_numpy, tree_leaves
    from repro_torch.core.object_store import PMemObjectStore
    from repro_torch.core.pmem import PMemPool
    from repro_torch.serve.engine import ServeEngine

    want = layer_counts(cfg)
    want_step = layer_counts(cfg, decode=True)
    batch, prompt = prompts.shape
    torch.cuda.reset_peak_memory_stats(device)
    eng = ServeEngine(cfg, rt, params, device=device)
    peaks = {}
    reset_launches()
    t0 = time.perf_counter()
    first = eng.prefill(prompts)
    prefill_s = time.perf_counter() - t0
    per_prefill = read_launches()
    routes = read_routes()
    check_wgmma(f"{cfg.name} prefill", per_prefill, routes)
    peaks["prefill"] = peak_line(device, "prefill")
    reset_launches()
    t0 = time.perf_counter()
    toks = eng.decode(first, GEN_A)
    decode_s = time.perf_counter() - t0
    per_decode = read_launches()
    routes_decode = read_routes()
    peaks["decode"] = peak_line(device, f"decode {GEN_A} steps")
    check(per_decode == {n: GEN_A * c for n, c in want_step.items()},
          f"{cfg.name}: {GEN_A} decode steps launched {per_decode}, want "
          f"{want_step} a step")
    check(toks.shape == (batch, GEN_A + 1), f"tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "token out of vocab")
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_leaves(eng.cache))
    root = pool_root(2 * state_bytes)
    try:
        eng.store = PMemObjectStore(PMemPool(root))
        copy = eng.export_state()
        direct = eng.decode(toks[:, -1], EXTRA)
        eng.install_state(copy)
        t0 = time.perf_counter()
        eng.spill(cfg.name)
        spill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.resume(cfg.name)
        resume_s = time.perf_counter() - t0
        back = eng.export_state()
        leaves = tree_leaves(copy["cache"])
        check([p for p, _ in leaves] ==
              [p for p, _ in tree_leaves(back["cache"])] and
              all(np.array_equal(to_numpy(a), to_numpy(b)) for (_, a), (_, b)
                  in zip(leaves, tree_leaves(back["cache"]))) and
              int(back["pos"]) == int(copy["pos"]),
              f"{cfg.name}: the resumed state differs from the spilled one")
        del back
        resumed = eng.decode(toks[:, -1], EXTRA)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    peaks["spill_resume"] = peak_line(device, "spill/resume and decode")
    check(np.array_equal(direct, resumed),
          f"{cfg.name}: tokens differ across spill/resume: {direct} vs "
          f"{resumed}")
    check(per_prefill == want,
          f"{cfg.name}: launches per prefill {per_prefill}, want {want}")
    peak = max(peaks.values())
    print(f"{cfg.name}: batch {batch} prompt {prompt} +{GEN_A} tokens: "
          f"prefill_s={prefill_s} decode_tok_per_s="
          f"{batch * GEN_A / decode_s} (decode_s={decode_s}) "
          f"max_memory_allocated={peak} [{card}]")
    print(f"{cfg.name}: state {state_bytes} bytes, spill_s={spill_s} "
          f"resume_s={resume_s}")
    print(f"{cfg.name}: state identical across spill/resume ({len(leaves)} "
          f"leaves, bit for bit); tokens identical: {direct.tolist()}")
    step = {n: c // GEN_A for n, c in per_decode.items()}
    print(f"{cfg.name}: launches per prefill {per_prefill}, per decode "
          f"step {step}; by route: prefill {routes}, {GEN_A} decode steps "
          f"{routes_decode}")
    return dict(launches=per_prefill, launches_decode_step=step,
                routes=routes, routes_decode=routes_decode,
                prefill_s=prefill_s,
                decode_tok_s=batch * GEN_A / decode_s, peak_bytes=peak,
                spill_s=spill_s, resume_s=resume_s, state_bytes=state_bytes,
                handoff=dict(state=copy, last=toks[:, -1], direct=direct))


def recurrent_logits(device, cfg, rt, params, prompts):
    """As request B: a short ragged prompt served, then its prefill
    logits through the kernels against their plain versions (every impl
    "interpret") on the same parameters, in bf16 and in float32."""
    import torch
    from repro_torch.bridge import tree_map
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    want = layer_counts(cfg)
    eng = ServeEngine(cfg, rt, params, device=device)
    reset_launches()
    toks = eng.decode(eng.prefill(prompts), GEN_B)
    check(read_launches() == want,
          f"{cfg.name} short prompt: {read_launches()}, want {want}")
    del eng
    plain_rt = dataclasses.replace(rt, attn_impl="interpret",
                                   rglru_impl="interpret",
                                   ssd_impl="interpret")
    tok_t = torch.as_tensor(prompts, device=device)
    limits = RECURRENT_LOGIT_TOL[cfg.name]
    gaps = {}
    for dtype in limits:
        p = params if dtype == "bfloat16" else \
            tree_map(lambda t: t.to(getattr(torch, dtype)), params)
        reset_launches()
        with torch.no_grad():
            lk, _ = tfm.prefill(p, cfg, rt, tok_t)
            mid = read_launches()
            lp, _ = tfm.prefill(p, cfg, plain_rt, tok_t)
        sync()
        del p
        check(mid == want and read_launches() == mid,
              f"{cfg.name} {dtype}: the kernel prefill must launch {want} "
              f"and the plain one none")
        check(bool(torch.isfinite(lk).all()) and
              lk.shape == (prompts.shape[0], cfg.padded_vocab),
              f"{cfg.name} {dtype} logits {tuple(lk.shape)} not "
              f"finite/shaped")
        gaps[dtype] = ((lk - lp).abs().max().item(),
                       lp.abs().max().item(),
                       bool((lk.argmax(-1) == lp.argmax(-1)).all()))
        del lk, lp
        torch.cuda.empty_cache()
    print(f"{cfg.name} short prompt: batch {prompts.shape[0]} prompt "
          f"{prompts.shape[1]} +{GEN_B} tokens {toks.tolist()}")
    for dtype, (err, scale, same) in gaps.items():
        print(f"{cfg.name} {dtype}: prefill logits kernels vs plain "
              f"versions: max_abs_err={err} max |logit| {scale} "
              f"rel={err / scale} (tol {limits[dtype]}) argmax "
              f"equal={same}")
    for dtype, (err, scale, _) in gaps.items():
        check(err <= limits[dtype] * scale,
              f"{cfg.name} {dtype} logits: kernels vs plain max |diff| "
              f"{err} > {limits[dtype]} * {scale}")
    return {f"logit_err_{d}": g[0] for d, g in gaps.items()}


def stored_codes(store, rep: str, ce: dict):
    """The int8 codes and float32 scales one delta8 leaf of a replica
    holds on its pool, as written."""
    region = store.pool.open(f"objects/{rep}@v0.data")
    q = np.array(region.read(ce["offset"], ce["q_nbytes"]),
                 copy=True).view(np.int8)
    sc = np.array(region.read(ce["scales_offset"], ce["scales_nbytes"]),
                  copy=True).view(np.float32)
    return q, sc


def plain_codes(t, device):
    """encode_tiles' plain version on one source leaf, as the wire codec
    lays it out: float32, zero-padded to whole tiles, zero base."""
    import torch
    from repro_torch.kernels.ckpt_codec.ref import TILE, encode_ref

    flat = t.reshape(-1).to(device=device, dtype=torch.float32)
    tiles = -(-flat.numel() // TILE)
    x = torch.zeros((tiles, TILE), dtype=torch.float32, device=device)
    x.view(-1)[:flat.numel()] = flat
    q, sc = encode_ref(x, torch.zeros_like(x))
    return q.reshape(-1).cpu().numpy(), sc.reshape(-1).cpu().numpy()


def codec_replica_phase(device, card: str, cfg, rt, params, state, last,
                        direct):
    """mamba2-1.3b's session replicated through the delta-int8 wire codec
    on 2-node SimClusters (the codec runs on the card, on the scheduler's
    mover thread). Strict (``wire_codec=True``): decode_tiles launches
    once per encodable leaf for the round-trip check, the leaves that do
    not reproduce bit for bit ship raw, and a fresh engine resumes from
    the replica after the home node's loss, bit-identical. Lossy
    (``{"strict": False}``): encode_tiles launches on every float32 leaf,
    the codes and scales the replica stores equal the plain encode of the
    same source leaf bit for bit, the replica's leaves decoded by the
    kernel equal the plain decode of the same stored codes bit for bit
    and lie within each tile's scale / 2 of the source. Last, a float32 tree of the state's shapes on
    an 8-bit integer grid times 2**-6, replicated strictly: every leaf
    ships delta8 and reads back bit-identical. Launches are counted from
    0 around each path."""
    import torch
    from repro_torch.bridge import to_numpy, tree_leaves
    from repro_torch.core.cluster import SimCluster
    from repro_torch.core.object_store import PMemObjectStore
    from repro_torch.core.wire_codec import encodable
    from repro_torch.serve.engine import ServeEngine

    name, rep = "mamba2", "replica/node0/dlm/serve/mamba2"
    leaves = tree_leaves(state["cache"])
    tags = {p: str(t.dtype).replace("torch.", "") for p, t in leaves}
    enc = ["cache/" + p for p, t in leaves
           if encodable(tags[p], t.numel() * t.element_size())]
    nbytes = sum(t.numel() * t.element_size() for _, t in leaves)
    check(len(enc) > 0, f"{cfg.name}: no encodable leaf in the state")
    out = {"state_bytes": nbytes, "encodable": len(enc),
           "leaves": len(leaves) + 1}
    root = pool_root(4 * nbytes + (1 << 30))

    def spill(sub: str, codec):
        cluster = SimCluster(root / sub, n_nodes=2, wire_codec=codec,
                             device=device)
        eng = ServeEngine(cfg, rt, params, tiered=cluster.tiered,
                          device=device)
        eng.install_state(state)
        sync()
        reset_launches()
        t0 = time.perf_counter()
        eng.spill(name, wait=False).result()
        errors = cluster.tiered.quiesce()
        acked_s = time.perf_counter() - t0
        launches = read_launches()
        check(errors == [], f"{cfg.name} codec {codec}: errors {errors}")
        check(cluster.tiered.dlm_acks.targets(f"dlm/serve/{name}") ==
              ["node1"], f"{cfg.name} codec {codec}: no replica ack")
        man = cluster.stores["node1"].manifest(rep)
        return cluster, eng, man, launches, acked_s

    try:
        # strict: lossless, raw where the round trip is not exact
        cluster, eng, man, launches, out["strict_acked_s"] = spill(
            "strict", True)
        try:
            modes = {p: ce["mode"]
                     for p, ce in man["meta"]["wire_codec"]["leaves"].items()}
            delta = [p for p, m in modes.items() if m == "delta8"]
            out["strict_delta8"] = len(delta)
            out["strict_raw"] = len(modes) - len(delta)
            out["strict_launches"] = launches
            check(launches["decode_tiles"] == len(enc) and
                  launches["encode_tiles"] == 0,
                  f"{cfg.name} strict: launches {launches}, want "
                  f"decode_tiles once per encodable leaf ({len(enc)})")
            check(eng.evict_cold_sessions() == 1, "strict: not resident")
            cluster.kill_node("node0")
            fresh = ServeEngine(cfg, rt, params, tiered=cluster.tiered,
                                device=device)
            reset_launches()
            t0 = time.perf_counter()
            fresh.resume(name)
            sync()
            out["strict_replica_resume_s"] = time.perf_counter() - t0
            read = read_launches()
            check(read["decode_tiles"] == len(delta),
                  f"{cfg.name} strict read: launches {read}, want one "
                  f"decode_tiles per delta8 leaf ({len(delta)})")
            out["strict_read_decodes"] = read["decode_tiles"]
            check(state_bits_equal(fresh.export_state(), state),
                  f"{cfg.name} strict: the state resumed from the "
                  f"replica differs from the spilled one")
            toks = fresh.decode(last, EXTRA)
            check(np.array_equal(toks, direct), f"{cfg.name} strict: "
                  f"tokens {toks} after the home node's loss, want "
                  f"{direct}")
            del fresh, eng
        finally:
            cluster.shutdown()
        # lossy: every float32 leaf encoded by encode_tiles
        cluster, eng, man, launches, out["lossy_acked_s"] = spill(
            "lossy", {"strict": False})
        try:
            wc = man["meta"]["wire_codec"]
            out["lossy_launches"] = launches
            out["wire_bytes"] = (man["nbytes"], wc["nbytes_encoded"])
            check(launches["encode_tiles"] == len(enc) and
                  launches["decode_tiles"] == 0,
                  f"{cfg.name} lossy: launches {launches}, want "
                  f"encode_tiles once per float32 leaf ({len(enc)})")
            check(sorted(p for p, ce in wc["leaves"].items()
                         if ce["mode"] == "delta8") == sorted(enc),
                  f"{cfg.name} lossy: delta8 leaves differ from the "
                  f"encodable ones")
            reset_launches()
            t0 = time.perf_counter()
            kern = dict(tree_leaves(cluster.stores["node1"].get(rep)))
            out["lossy_read_s"] = time.perf_counter() - t0
            read = read_launches()
            check(read["decode_tiles"] == len(enc), f"{cfg.name} lossy "
                  f"read: launches {read}, want {len(enc)} decode_tiles")
            out["lossy_read_decodes"] = read["decode_tiles"]
            plain = dict(tree_leaves(PMemObjectStore(
                cluster.pools["node1"], device="cpu").get(rep)))
            src = dict(tree_leaves({"cache": state["cache"]}))
            worst = 0.0
            for path in enc:
                q, sc = stored_codes(cluster.stores["node1"], rep,
                                     wc["leaves"][path])
                pq, psc = plain_codes(src[path], device)
                check(q.tobytes() == pq.tobytes() and
                      sc.tobytes() == psc.tobytes(),
                      f"{cfg.name} lossy {path}: encode_tiles' stored codes "
                      f"and scales differ from its plain version on the "
                      f"same source ({int((q != pq).sum())} codes, "
                      f"{int((sc != psc).sum())} scales)")
                k, pl = kern[path], plain[path]
                check(k.dtype == pl.dtype and k.tobytes() == pl.tobytes(),
                      f"{cfg.name} lossy {path}: kernel decode differs "
                      f"from the plain decode of the same codes")
                x = to_numpy(src[path]).astype(np.float64).reshape(-1)
                tile = np.repeat(sc.astype(np.float64), 1024)[:x.size]
                err = np.abs(k.astype(np.float64).reshape(-1) - x)
                # the float32 arithmetic: x / scale and q * scale round
                slack = (np.abs(x) + 128 * tile) * 2.0 ** -22
                worst = max(worst, float((err / (tile / 2 + slack)).max()))
            out["lossy_worst_bound"] = worst
            check(worst <= 1.0, f"{cfg.name} lossy: decoded beyond the "
                                f"per-tile bound ({worst} of it)")
            # a state on an 8-bit grid times 2**-6 travels encoded, exact
            gen = torch.Generator(device=device).manual_seed(SEED)
            grid = {p: (torch.randint(-127, 128, tuple(t.shape),
                                      generator=gen, device=device)
                        .to(torch.float32) * 2.0 ** -6).cpu()
                    for p, t in leaves}
            check(all(t.numel() >= 1024 for t in grid.values()),
                  "grid: a leaf under one tile")
            cluster.stores["node0"].put("grid", grid)
            reset_launches()
            t0 = time.perf_counter()
            gman = cluster.scheduler.replicate("node0", "grid", "node1",
                                               codec=True).result()
            out["grid_replicate_s"] = time.perf_counter() - t0
            gl = read_launches()
            gmodes = {ce["mode"] for ce in
                      gman["meta"]["wire_codec"]["leaves"].values()}
            check(gmodes == {"delta8"} and
                  gl["decode_tiles"] == len(grid),
                  f"grid: modes {gmodes}, launches {gl}: want every leaf "
                  f"delta8, one decode_tiles each")
            back = dict(tree_leaves(cluster.stores["node1"].get(
                "replica/node0/grid", verify=True)))
            check(all(back[p].tobytes() == to_numpy(t).tobytes()
                      for p, t in grid.items()),
                  "grid: the replica differs from the source")
            out["grid_bytes"] = (gman["nbytes"],
                                 gman["meta"]["wire_codec"]["nbytes_encoded"])
            out["grid_launches"] = gl
            del eng, kern, plain, grid, back
        finally:
            cluster.shutdown()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release()
    print(f"{cfg.name} wire codec strict: {out['strict_delta8']} leaves "
          f"shipped delta8, {out['strict_raw']} raw of {len(modes)} "
          f"({out['encodable']} encodable); spill launches "
          f"{out['strict_launches']}; spill -> replica acked "
          f"{out['strict_acked_s']} s; after node0's loss the replica "
          f"resume ({out['strict_read_decodes']} decodes) took "
          f"{out['strict_replica_resume_s']} s: state bit-identical, tokens "
          f"identical [{card}]")
    print(f"{cfg.name} wire codec lossy: encode_tiles on all {len(enc)} "
          f"float32 leaves (launches {out['lossy_launches']}), stored "
          f"codes and scales equal to the plain encode bit for bit, "
          f"{out['wire_bytes'][0]} B -> {out['wire_bytes'][1]} B on the "
          f"wire, acked {out['lossy_acked_s']} s; kernel decode of the "
          f"replica ({out['lossy_read_decodes']} launches, "
          f"{out['lossy_read_s']} s) equal to the plain decode bit for "
          f"bit; worst error {out['lossy_worst_bound']} of the per-tile "
          f"bound [{card}]")
    print(f"{cfg.name} wire codec grid tree: every leaf delta8 "
          f"({out['grid_launches']['decode_tiles']} decode_tiles), "
          f"{out['grid_bytes'][0]} B -> {out['grid_bytes'][1]} B, "
          f"replicate {out['grid_replicate_s']} s, read back bit-identical "
          f"[{card}]")
    out["launches"] = {
        "encode_tiles": out["lossy_launches"]["encode_tiles"],
        "decode_tiles": (out["strict_launches"]["decode_tiles"] +
                         out["strict_read_decodes"] +
                         out["lossy_read_decodes"] +
                         out["grid_launches"]["decode_tiles"])}
    return out


def recurrent_phase(device, card: str, arch: str):
    """One recurrent family at full size: its long request (the main
    path) and its short ragged one; the model is freed at the end."""
    import torch
    batch, prompt = RECURRENT[arch]
    cfg, rt, params = recurrent_model(device, arch, prompt)
    rng = np.random.default_rng(SEED)
    long = rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    short = rng.integers(0, cfg.vocab_size,
                         (BATCH_B, PROMPT_B)).astype(np.int32)
    out = model_request(device, card, cfg, rt, params, long)
    handoff = out.pop("handoff")
    if arch == CODEC_ARCH:
        out["wire"] = codec_replica_phase(device, card, cfg, rt, params,
                                          **handoff)
    del handoff
    out.update(recurrent_logits(device, cfg, rt, params, short))
    del params
    release()
    return out


def moe_model(device, arch: str, layers: int, prompt: int):
    """A MoE family's full-width config with its depth cut to ``layers``,
    its runtime (every kernel's route, ModelRuntime's defaults) and random
    bf16 parameters made on the card from the seed."""
    import torch
    from repro_torch.bridge import tree_leaves
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm

    full = registry.get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    rt = tfm.ModelRuntime(tp=1, max_seq=prompt + GEN_A + 2 * EXTRA + 8)
    check((rt.attn_impl, rt.moe_impl) == ("pallas",) * 2,
          "the runtime's defaults must be the kernels")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = tfm.init_params(cfg, rt, gen, device=device)
    sync()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    nbytes = sum(t.numel() * t.element_size() for _, t in tree_leaves(params))
    print(f"serve {cfg.name}: reduced n_layers {full.n_layers} -> {layers} "
          f"(full width: d_model={cfg.d_model}, {cfg.moe.n_experts} experts "
          f"top-{cfg.moe.top_k}, expert d_ff={cfg.expert_d_ff}, dense "
          f"residual={cfg.pattern[0].dense_residual}), {n_params} parameters "
          f"({nbytes} B) made on the card in {time.perf_counter() - t0:.3f}s;"
          f" kernels per prefill {layer_counts(cfg)}, per decode step "
          f"{layer_counts(cfg, decode=True)}")
    peak_line(device, "init")
    return cfg, rt, params


def served_moe_layer(device, cfg, rt, params, prompts):
    """The long request's own routing. Its prefill runs again with each
    MoE layer's input recorded (the hidden states the served prefill
    routes); each layer's per-expert counts are printed, and the first
    layer as served (the sorted route, the kernel at choose_bt's row
    block) is held against the same route through the plain gmm and
    against the dense gshard oracle, and its wi gmm timed on that
    routing."""
    import torch
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm

    seen = []
    apply_moe = moe_mod.apply_moe

    def record(p, x, cfg_, impl="pallas"):
        _, ids, _ = moe_mod.router_probs(p, x, cfg_)
        seen.append((p, None if seen else x, ids))
        return apply_moe(p, x, cfg_, impl=impl)

    moe_mod.apply_moe = record
    try:
        with torch.no_grad():
            tfm.prefill(params, cfg, rt, torch.as_tensor(prompts,
                                                         device=device))
    finally:
        moe_mod.apply_moe = apply_moe
    sync()
    check(len(seen) == cfg.n_layers, f"{cfg.name}: {len(seen)} MoE layers "
                                     f"recorded, want {cfg.n_layers}")
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    for i, (_, _, ids) in enumerate(seen):
        counts = torch.bincount(ids.reshape(-1), minlength=e).tolist()
        print(f"{cfg.name} served routing, MoE layer {i}: {sum(counts)} "
              f"rows over {e} experts, min {min(counts)} max {max(counts)}, "
              f"experts used {sum(c > 0 for c in counts)}; counts {counts}")
    p, x, ids = seen[0]
    del seen

    def ulps(got, want):
        """max |got - want| in bf16 ulps (2**-7) of each token's largest
        |want|."""
        scale = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
        return ((got.float() - want.float()).abs() /
                (2 ** -7 * scale)).max().item()

    with torch.no_grad():
        before = gmm_ops.launches
        got, _ = moe_mod.apply_moe(p, x, cfg, impl="pallas")
        sync()
        check(gmm_ops.launches == before + 3,
              f"{cfg.name}: the served layer launched gmm "
              f"{gmm_ops.launches - before} times, want 3")
        check(bool(torch.isfinite(got).all()) and got.shape == x.shape,
              f"{cfg.name}: served layer output not finite/shaped")
        gaps = {impl: ulps(got, moe_mod.apply_moe(p, x, cfg, impl=impl)[0])
                for impl in ("interpret", "gshard")}
    check(gmm_ops.launches == before + 3,
          f"{cfg.name}: the plain routes launched the kernel")
    t = x.shape[0] * x.shape[1] * k
    bt = gmm_ops.choose_bt(t, e)
    wi = moe_mod.logical_expert_weights(p, cfg)[0]
    xk = x.reshape(-1, 1, cfg.d_model).expand(-1, k, -1).reshape(t, -1)
    buf, be, _ = gmm_ops.sort_tokens_by_expert(xk, ids.reshape(t), e, bt)
    ms = cuda_ms(lambda: gmm_ops.gmm(buf, wi, be, bt=bt), 5)
    used = int((torch.bincount(ids.reshape(-1), minlength=e) > 0).sum())
    bound, bound_by = gmm_bound_ms(t, cfg.d_model, cfg.expert_d_ff, used)
    print(f"{cfg.name} served MoE layer 0: {t} routed rows, bt={bt}, "
          f"buffer {buf.shape[0]} rows: kernel route vs plain gmm route "
          f"{gaps['interpret']} ulps, vs gshard oracle {gaps['gshard']} ulps"
          f" (tol {SERVED_MOE_ULPS} ulps of each token's largest output); "
          f"wi gmm on this routing kernel_ms={ms} bound_ms={bound} "
          f"({bound_by})")
    for impl, gap in gaps.items():
        check(gap <= SERVED_MOE_ULPS,
              f"{cfg.name} served layer: kernel route vs {impl} {gap} ulps "
              f"beyond {SERVED_MOE_ULPS}")
    del got, buf, be, xk
    torch.cuda.empty_cache()
    peak_line(device, "served MoE layer check")
    return dict(served_ulps=gaps, served_gmm_ms=ms,
                served_gmm_bound_ms=bound)


def cast_leaves_(tree: dict, dtype) -> None:
    """Cast a parameter tree in place one leaf at a time, so the cast
    holds one leaf twice at most, not the whole tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            cast_leaves_(v, dtype)
        else:
            tree[k] = v.to(dtype)
            del v


def moe_logits(device, cfg, rt, params, prompts, dtype: str):
    """The short ragged prompt's prefill logits through the kernels (gmm,
    flash) against the plain versions (moe_impl "gshard", the dense
    oracle; attn_impl "interpret") on the same parameters. Returns the
    gap, the largest logit and whether the argmax agrees."""
    import torch
    from repro_torch.models import transformer as tfm

    want = layer_counts(cfg)
    plain_rt = dataclasses.replace(rt, attn_impl="interpret",
                                   moe_impl="gshard")
    tok_t = torch.as_tensor(prompts, device=device)
    reset_launches()
    with torch.no_grad():
        lk, _ = tfm.prefill(params, cfg, rt, tok_t)
        mid = read_launches()
        lp, _ = tfm.prefill(params, cfg, plain_rt, tok_t)
    sync()
    check(mid == want and read_launches() == mid,
          f"{cfg.name} {dtype}: the kernel prefill must launch {want} and "
          f"the plain one none ({mid}, {read_launches()})")
    check(bool(torch.isfinite(lk).all()) and
          lk.shape == (prompts.shape[0], cfg.padded_vocab),
          f"{cfg.name} {dtype} logits {tuple(lk.shape)} not finite/shaped")
    gap = ((lk - lp).abs().max().item(), lp.abs().max().item(),
           bool((lk.argmax(-1) == lp.argmax(-1)).all()))
    err, scale, same = gap
    limit = MOE_LOGIT_TOL[cfg.name][dtype]
    print(f"{cfg.name} {dtype} ({cfg.n_layers} layers): prefill logits "
          f"kernels vs plain versions: max_abs_err={err} max |logit| "
          f"{scale} rel={err / scale} (tol {limit}) argmax equal={same}")
    peak_line(device, f"{dtype} logit check")
    return gap


def moe_phase(device, card: str, arch: str):
    """One MoE family at full width, depth cut: its long request (the
    main path: gmm in prefill and in every decode step), its first MoE
    layer on that request's hidden states against the plain routes, the
    short ragged prompt's bf16 logits at the cut depth; then, with that
    model freed, a
    fresh 1-layer model cast to float32 leaf by leaf for the float32
    logits. Every model is freed at the end."""
    import torch
    from repro_torch.configs.base import ATTN_GLOBAL
    from repro_torch.models import transformer as tfm

    layers, (batch, prompt) = MOE[arch]
    cfg, rt, params = moe_model(device, arch, layers, prompt)
    rng = np.random.default_rng(SEED)
    long = rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    short = rng.integers(0, cfg.vocab_size,
                         (BATCH_B, PROMPT_B)).astype(np.int32)
    check((cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
           cfg.attn_softcap) == MOE_ATTN[arch] and
          {spec.mixer for spec in cfg.pattern} == {ATTN_GLOBAL},
          f"{arch}: attention differs from the kernel phase's MOE_ATTN")
    out = model_request(device, card, cfg, rt, params, long)
    del out["handoff"]  # the tiered paths are request A's and mamba2's
    out.update(served_moe_layer(device, cfg, rt, params, long))
    gaps = {"bfloat16": moe_logits(device, cfg, rt, params, short,
                                   "bfloat16")}
    del params
    release()
    torch.cuda.reset_peak_memory_stats(device)
    one = dataclasses.replace(cfg, n_layers=1)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    params = tfm.init_params(one, rt, gen, device=device)
    cast_leaves_(params, torch.float32)
    sync()
    peak_line(device, "1-layer model, cast to float32")
    gaps["float32"] = moe_logits(device, one, rt, params, short, "float32")
    del params
    release()
    for dtype, (err, scale, _) in gaps.items():
        limit = MOE_LOGIT_TOL[arch][dtype]
        check(err <= limit * scale,
              f"{arch} {dtype} logits: kernels vs plain max |diff| {err} > "
              f"{limit} * {scale}")
        out[f"logit_err_{dtype}"] = err
        out[f"logit_rel_{dtype}"] = err / scale
    return out


def codec_bound_ms(n: int, in_bytes: int, out_bytes: int) -> tuple:
    """Least time for one codec call over n elements: the bytes it must
    move (its inputs read once, its outputs written once; the codes of a
    ragged last tile included) against ~6 float32 operations an element
    (subtract, |.|, max, divide, round, clamp; decode: convert, multiply,
    add, round)."""
    t_mem = (in_bytes + out_bytes) / PEAK_HBM_BYTES * 1e3
    t_ops = 6.0 * n / PEAK_F32_FLOPS * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops > t_mem else "bytes")


def codec_kernel_phase(device):
    """encode_tiles and decode_tiles against their plain versions at the
    training state's shard shapes, bit for bit, and timed."""
    import torch
    from repro_torch.kernels.ckpt_codec import ops as codec_ops

    gen = torch.Generator(device=device).manual_seed(SEED)
    results = {}
    for name, (shape, dtype) in CODEC_CASES.items():
        dt = getattr(torch, dtype)
        if dt == torch.int32:  # the step counter: base 2, new 4
            base = torch.full(shape, 2, dtype=dt, device=device)
            new = base + 2
        else:
            base = torch.randn(shape, generator=gen, device=device)
            new = (base + 0.01 * torch.randn(shape, generator=gen,
                                             device=device)).to(dt)
            base = base.to(dt)
        n, item = new.numel(), new.element_size()
        tiles = codec_ops.n_tiles(n)
        e0 = codec_ops.encode_launches
        q, s = codec_ops.delta_encode(new, base)
        sync()
        pq, ps = codec_ops.delta_encode(new, base, interpret=True)
        check(codec_ops.encode_launches == e0 + 1,
              f"codec {name}: the encode launched "
              f"{codec_ops.encode_launches - e0} times, want 1")
        check(torch.equal(q, pq) and torch.equal(s.view(torch.int32),
                                                 ps.view(torch.int32)),
              f"codec {name}: encode_tiles differs from its plain version "
              f"({int((q != pq).sum())} codes, "
              f"{int((s != ps).sum())} scales)")
        d0 = codec_ops.decode_launches
        out = codec_ops.delta_decode(q, s, base, shape=shape, dtype=dt)
        sync()
        plain = codec_ops.delta_decode(q, s, base, shape=shape, dtype=dt,
                                       interpret=True)
        check(codec_ops.decode_launches == d0 + 1,
              f"codec {name}: the decode launched "
              f"{codec_ops.decode_launches - d0} times, want 1")
        bits = torch.int16 if item == 2 else torch.int32
        check(torch.equal(out.view(bits), plain.view(bits)),
              f"codec {name}: decode_tiles differs from its plain version "
              f"in {int((out.view(bits) != plain.view(bits)).sum())} "
              f"elements")
        err = (out.double() - new.double()).abs()
        bound = s.double().expand(tiles, 1024).reshape(-1)[:n] \
            .reshape(shape) / 2
        check(bool((err <= bound + new.double().abs() * 2 ** -8 +
                    1e-6).all()),
              f"codec {name}: decoded beyond the per-tile bound")
        big = n > 1_000_000
        reps = 20 if big else 200
        enc_ms = cuda_ms(lambda: codec_ops.delta_encode(new, base), reps)
        enc_plain = cuda_ms(lambda: codec_ops.delta_encode(
            new, base, interpret=True), 3 if big else 20)
        dec_ms = cuda_ms(lambda: codec_ops.delta_decode(
            q, s, base, shape=shape, dtype=dt), reps)
        dec_plain = cuda_ms(lambda: codec_ops.delta_decode(
            q, s, base, shape=shape, dtype=dt, interpret=True),
            3 if big else 20)
        enc_bound = codec_bound_ms(n, 2 * n * item, tiles * (1024 + 4))
        dec_bound = codec_bound_ms(n, tiles * (1024 + 4) + n * item,
                                   n * item)
        results[name] = dict(
            encode=dict(ms=enc_ms, plain_ms=enc_plain,
                        bound_ms=enc_bound[0], bound_by=enc_bound[1]),
            decode=dict(ms=dec_ms, plain_ms=dec_plain,
                        bound_ms=dec_bound[0], bound_by=dec_bound[1]),
            max_abs_err=0.0)
        print(f"kernel ckpt_codec {name}: shape {shape} {dtype}, {tiles} "
              f"tiles: codes, scales and decoded bits equal to the plain "
              f"version's; encode_ms={enc_ms} plain_ms={enc_plain} "
              f"bound_ms={enc_bound[0]} ({enc_bound[1]}); decode_ms={dec_ms}"
              f" plain_ms={dec_plain} bound_ms={dec_bound[0]} "
              f"({dec_bound[1]})")
        del new, base, q, s, pq, ps, out, plain, err, bound
        torch.cuda.empty_cache()
    return results


def leaf_digest(t) -> tuple:
    """A digest of a tensor's bits, computed on the card: the sum of its
    words and the sum of its words weighted by their index (int64,
    wrapping), over slabs of 2**24 elements."""
    import torch
    x = t.detach().reshape(-1)
    x = x.view(torch.int16) if x.element_size() == 2 else \
        x.view(torch.int32)
    s1 = torch.zeros((), dtype=torch.int64, device=x.device)
    s2 = torch.zeros((), dtype=torch.int64, device=x.device)
    for lo in range(0, x.numel(), 1 << 24):
        c = x[lo:lo + (1 << 24)].to(torch.int64)
        s1 += c.sum()
        s2 += (c * torch.arange(lo, lo + c.numel(), device=x.device)).sum()
    return tuple(torch.stack([s1, s2]).tolist())


def state_digests(tree) -> dict:
    from repro_torch.bridge import tree_leaves
    return {path: (tuple(t.shape), str(t.dtype), leaf_digest(t))
            for path, t in tree_leaves(tree)}


def check_delta_restore(cluster, manifest, restored, live) -> float:
    """Every element of a delta step's restore within its tile's scale / 2
    plus half an ulp of the leaf dtype (plus two float32 ulps of the
    codec's arithmetic) of the live state it encoded, shard by shard,
    with the scales the save stored. Returns the largest ratio of an
    error to its bound."""
    import torch
    from repro_torch.bridge import to_torch, tree_leaves
    obj = f"ckpt/slot{manifest['slot']}"
    live = dict(tree_leaves(live))
    worst = 0.0
    for path, got in tree_leaves(restored):
        want = live[path]
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"restore {path}: {got.shape} {got.dtype}, want {want.shape} "
              f"{want.dtype}")
        ent = manifest["leaves"][path]
        for nid, start, rows in ent["shards"]:
            if got.dim():
                g, w = got[start:start + rows], want[start:start + rows]
            else:
                g, w = got, want
            g, w = g.double().reshape(-1), w.double().reshape(-1)
            scale = to_torch(cluster.stores[nid].get_leaf(
                obj, path + ".__ds"), got.device).double()
            tile = scale.expand(-1, 1024).reshape(-1)[:g.numel()]
            mag = torch.maximum(g.abs(), w.abs())
            if got.dtype == torch.int32:
                half_ulp = torch.full_like(mag, 0.5)
            else:
                mant = 7 if got.dtype == torch.bfloat16 else 23
                half_ulp = torch.exp2(torch.floor(torch.log2(
                    mag.clamp_min(1e-38))) - mant - 1)
            # the float32 arithmetic: d = new - base, d / scale and
            # base + q * scale round to float32 (base within 128 scales)
            slack = (mag + 128 * tile) * 2 ** -22
            ratio = ((g - w).abs() / (tile / 2 + half_ulp + slack)).max()
            worst = max(worst, ratio.item())
    check(worst <= 1.0, f"delta restore beyond the codec's per-tile bound: "
                        f"{worst} of it")
    return worst


def train_phase(device, card: str):
    """gemma2-9b trained at full width (2 layers) through the port's
    loop on a 4-node cluster: a full save at step 2 and a delta at step 4
    (encoded on the card), then restore(2) against the digests taken at
    save time and restore(4) (decoded on the card) against the live
    state. The counts are reset just before the loop and read after the
    restores."""
    import torch
    from repro_torch.bridge import tree_leaves
    from repro_torch.configs import ShapeConfig, registry
    from repro_torch.core.cluster import SimCluster
    from repro_torch.data.pipeline import StagedDataset
    from repro_torch.kernels.ckpt_codec import ops as codec_ops
    from repro_torch.models import transformer as tfm
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    full = registry.get_config("gemma2-9b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    check([s.mixer for s in cfg.pattern] == ["attn_local", "attn_global"]
          and cfg.groups == ((cfg.pattern, 1),),
          "the cut model must be one local and one global layer")
    rt = tfm.ModelRuntime(tp=1, attn_impl="blockwise", remat=True,
                          max_seq=TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, rt, torch.Generator(device=device)
                             .manual_seed(SEED), device=device)
    adamw = opt.AdamWConfig(lr=1e-3, warmup=10)
    opt_state = opt.init_opt_state(params, adamw)
    sync()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    state_bytes = sum(t.numel() * t.element_size() for _, t in
                      tree_leaves({"params": params, "opt": opt_state}))
    print(f"train {cfg.name}: reduced n_layers {full.n_layers} -> "
          f"{TRAIN_LAYERS} (full width: d_model={cfg.d_model}, "
          f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads of "
          f"{cfg.resolved_head_dim}, d_ff={cfg.d_ff}, vocab "
          f"{cfg.vocab_size}); {n_params} parameters, state {state_bytes} B "
          f"(bf16 params, float32 m and v) made on the card in "
          f"{time.perf_counter() - t0:.3f}s; batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, ce_chunk 128, remat, attention blockwise")
    peak_line(device, "train init")
    step_fn = ts.make_train_step(cfg, rt, adamw, ce_chunk=128)
    # room for the full save and a delta (int8 codes and their scales),
    # each with its buddy replicas
    n_elem = sum(t.numel() for _, t in
                 tree_leaves({"params": params, "opt": opt_state}))
    need = 2 * (state_bytes + n_elem + n_elem // 256) + (1 << 30)
    root = pool_root(need)
    steps, digests = [], {}
    last = {}
    # the loop is handed None and the first step takes the initial state
    # from here: held by this frame through the loop, it would be a third
    # state on the card beside the live one and the one a save holds
    first = {"params": params, "opt": opt_state}
    del params, opt_state

    def recorded_step(p, o, batch):
        if p is None:
            p, o = first.pop("params"), first.pop("opt")
        t0 = time.perf_counter()
        p, o, m = step_fn(p, o, batch)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        step = len(steps) + 1
        peak = peak_line(device, f"train step {step}")
        steps.append(dict(step=step, seconds=dt, loss=loss, peak=peak,
                          grad_norm=float(m["grad_norm"])))
        print(f"train step {step}: step_s={dt} loss={loss} grad_norm="
              f"{steps[-1]['grad_norm']} max_memory_allocated={peak} "
              f"[{card}]")
        if step % TRAIN_CKPT_EVERY == 0:  # the state this step's save gets
            digests[step] = state_digests({"params": p, "opt": o})
        last.update(params=p, opt=o)
        return p, o, m

    cluster = SimCluster(root, n_nodes=TRAIN_NODES, pmem_capacity=need,
                         delta=True, device=device)
    saves = {}
    save_async = cluster.tiered.save_async

    def recorded_save(step, tree, **kw):
        rec = saves[step] = dict(t0=time.perf_counter(), base=kw.get(
            "base_step"))
        ticket = save_async(step, tree, **kw)
        ticket.device_done.add_done_callback(
            lambda f: rec.update(device_s=time.perf_counter() - rec["t0"],
                                 encode_count=codec_ops.encode_launches))
        ticket.future.add_done_callback(
            lambda f: rec.update(total_s=time.perf_counter() - rec["t0"]))
        rec["ticket"] = ticket
        return ticket

    cluster.tiered.save_async = recorded_save
    try:
        data = StagedDataset(cluster, cfg, ShapeConfig(
            "train", TRAIN_SEQ, TRAIN_BATCH, "train"), n_shards=4,
            seqs_per_shard=16)
        lc = train_loop.LoopConfig(steps=TRAIN_STEPS,
                                   ckpt_every=TRAIN_CKPT_EVERY,
                                   delta_ckpt=True)
        reset_launches()
        t0 = time.perf_counter()
        state = train_loop.run(recorded_step, None, None,
                               data.batches(TRAIN_STEPS), cluster, lc)
        loop_s = time.perf_counter() - t0
        train_launches = read_launches()
        check(state.step == TRAIN_STEPS and all(np.isfinite(state.losses)),
              f"loop ended at step {state.step}, losses {state.losses}")
        check(sorted(saves) == [2, 4] and saves[4]["base"] == 2 and
              saves[2]["base"] is None,
              f"saves {sorted(saves)}: want a full save at 2, a delta at 4")
        mans = {st: saves[st]["ticket"].result() for st in saves}
        # launches per save: one encode per (node, leaf shard) with a base
        want_enc = sum(len(e["shards"]) for e in mans[4]["leaves"].values())
        prev = 0
        for i, st in enumerate(sorted(saves)):
            rec = saves[st]
            obj = f"ckpt/slot{mans[st]['slot']}"
            rec["bytes"] = sum(s.manifest(obj)["nbytes"]
                               for s in cluster.stores.values())
            rec["launches"] = rec["encode_count"] - prev
            prev = rec["encode_count"]
            rec["loop_s"] = state.ckpt_seconds[i]
            kind = "full" if rec["base"] is None else \
                f"delta vs step {rec['base']}"
            print(f"train save step {st} ({kind}): "
                  f"loop paid {rec['loop_s']} s, device phase "
                  f"{rec['device_s']} s, total {rec['total_s']} s, "
                  f"{rec['bytes']} B on pmem, encode_tiles launches "
                  f"{rec['launches']}")
        per_save = [saves[st]["launches"] for st in sorted(saves)]
        check(per_save == [0, want_enc] and
              train_launches["encode_tiles"] == want_enc,
              f"encode launches per save {per_save}, want 0 and "
              f"{want_enc}")
        print(f"train loop: {TRAIN_STEPS} steps in {loop_s} s (its end "
              f"joins the replicas); losses {state.losses}; ckpt_seconds "
              f"{state.ckpt_seconds}; final durability "
              f"{state.final_ckpt_durability}")
        # every save replicated to its ring buddy and acked
        levels = {st: saves[st]["ticket"].durability() for st in saves}
        check(levels == {2: "REPLICATED", 4: "REPLICATED"},
              f"durability after the loop {levels}, want REPLICATED")
        ring = cluster.node_ids
        replica_bytes = {st: sum(
            cluster.stores[cluster.checkpointer.buddy_of(nid, ring)]
            .manifest(f"replica/{nid}/ckpt/slot{mans[st]['slot']}")["nbytes"]
            for nid in ring) for st in saves}
        check(all(replica_bytes[st] == saves[st]["bytes"] for st in saves),
              f"replica bytes {replica_bytes} differ from the saves'")
        ack = cluster.tiered.replication._ack_s.summary()
        check(ack["count"] == len(saves) * len(ring),
              f"{ack['count']} replica acks, want {len(saves) * len(ring)}")
        pool_bytes = sum(p.used_bytes() for p in cluster.pools.values())
        print(f"train replicas: durability {levels}; replica bytes "
              f"{replica_bytes} (equal to the saves'); submit-to-ack "
              f"{ack['count']} transfers, min {ack['min']} s, mean "
              f"{ack['mean']} s, max {ack['max']} s; pools hold "
              f"{pool_bytes} B of {need} B allowed [{card}]")

        # restore(2): bit for bit against the digests taken at save time
        t0 = time.perf_counter()
        got2, man2 = cluster.checkpointer.restore(2)
        sync()
        restore2_s = time.perf_counter() - t0
        dig = state_digests(got2)
        check(dig == digests[2], "restore(2) differs from the state saved "
              "at step 2 in " + str([p for p in dig
                                     if dig[p] != digests[2].get(p)][:5]))
        del got2
        torch.cuda.empty_cache()
        print(f"train restore(2): {len(dig)} leaves bit-identical to the "
              f"state saved at step 2 (per-leaf digests taken at save "
              f"time); restore_s={restore2_s}")
        check(state_digests({"params": last["params"], "opt": last["opt"]})
              == digests[4], "the live step-4 state changed after its save")
        d0 = codec_ops.decode_launches
        t0 = time.perf_counter()
        got4, man4 = cluster.checkpointer.restore(4)
        sync()
        restore4_s = time.perf_counter() - t0
        decodes = codec_ops.decode_launches - d0
        worst = check_delta_restore(cluster, man4, got4,
                                    {"params": last["params"],
                                     "opt": last["opt"]})
        del got4
        launches = read_launches()
        check(decodes == want_enc and launches["decode_tiles"] == want_enc,
              f"restore(4) launched decode_tiles {decodes} times, want "
              f"{want_enc}")
        check(all(c == 0 for n, c in launches.items()
                  if n not in ("encode_tiles", "decode_tiles")),
              f"training launched serve kernels: {launches}")
        print(f"train restore(4): every element within its tile's scale/2 "
              f"+ half an ulp of its dtype of the live step-4 state (worst "
              f"{worst} of the bound); decode_tiles launches {decodes}; "
              f"restore_s={restore4_s}")
        peak = peak_line(device, "restores")
    finally:
        cluster.tiered.save_async = save_async
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)
        last.clear()
        release()
    return dict(launches=launches, steps=steps, saves={
        st: {k: v for k, v in rec.items() if k != "ticket"}
        for st, rec in saves.items()}, restore2_s=restore2_s,
        restore4_s=restore4_s, losses=state.losses, worst_bound=worst,
        restore_peak=peak, durability=levels, submit_to_ack=ack)


def cli_phase():
    import contextlib
    import io
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.launch import train
    fa_ops.launches = 0
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        serve.main([])  # through a one-node SimCluster's TieredIO
    print(said.getvalue(), end="")
    check(fa_ops.launches > 0, "the serve CLI launched no kernel")
    check("spill/resume ok" in said.getvalue(),
          "the serve CLI did not report spill/resume ok")
    print(f"cli: repro_torch.launch.serve at its defaults (spill, prefetch "
          f"and resume through TieredIO): flash_attention "
          f"launches={fa_ops.launches}")
    for arch, kernel in (("recurrentgemma-9b", "rglru"),
                         ("mamba2-1.3b", "ssd"), ("grok-1-314b", "gmm"),
                         ("arctic-480b", "gmm")):
        reset_launches()
        serve.main(["--arch", arch])
        launches = read_launches()
        check(launches[kernel] > 0,
              f"the serve CLI launched no {kernel} kernel for {arch}")
        print(f"cli: repro_torch.launch.serve --arch {arch}: launches "
              f"{launches}")
    # the training CLI at JAX's defaults (20 steps, seq 64, batch 8, a
    # checkpoint every 5): it raises unless the loss went down
    reset_launches()
    state = train.main(["--smoke", "--delta-ckpt"])
    launches = read_launches()
    check(launches["encode_tiles"] > 0,
          "the training CLI's delta checkpoints launched no encode_tiles")
    print(f"cli: repro_torch.launch.train --smoke --delta-ckpt: loss "
          f"{state.losses[0]} -> {state.losses[-1]}, launches {launches}")
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
    kern = run_phase(kernel_phase, device)
    scan = run_phase(scan_kernel_phase, device)
    gmm = run_phase(gmm_kernel_phase, device)
    codec = run_phase(codec_kernel_phase, device)
    serve_res = run_phase(serve_phase, device, card)
    rec = {arch: run_phase(recurrent_phase, device, card, arch)
           for arch in RECURRENT}
    moe = {arch: run_phase(moe_phase, device, card, arch) for arch in MOE}
    train_res = run_phase(train_phase, device, card)
    run_phase(cli_phase)
    wire = rec[CODEC_ARCH]["wire"]
    g = kern["global"]
    mqa = kern["local_mqa"]
    rg, sd = scan["rglru_serve"], scan["ssd_serve"]
    gk, ga = gmm["grok_bfloat16"], gmm["arctic_bfloat16"]
    grok, arctic = moe["grok-1-314b"], moe["arctic-480b"]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
        "launches": serve_res["launches"],
        "max_abs_err": max(r["max_abs_err"] for n, r in kern.items()
                           if not n.startswith("library")),
        "max_row_err": max(r["row_err"] for n, r in kern.items()
                           if not n.startswith("library")),
        "ms": g["ms"],
        "plain_ms": g["plain_ms"],
        "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"],
        "library_ms": kern["library_cap0"]["library_ms"],
        "shape": f"global layer B={ATTN_B} S={ATTN_S} H={ATTN_H} "
                 f"Kh={ATTN_KH} D={ATTN_D} causal cap={ATTN_CAP}",
        "library_case": "scaled_dot_product_attention, causal cap=0, same "
                        "shapes",
        "launches_by_route": {
            "gemma2-9b": serve_res["routes"]["flash_attention"],
            **{a: r["routes"]["flash_attention"]
               for a, r in (("recurrentgemma-9b", rec["recurrentgemma-9b"]),
                            ("grok-1-314b", grok),
                            ("arctic-480b", arctic))}},
        "routes_by_case": {n: r["route"] for n, r in kern.items()
                           if "route" in r},
        "local_ms": kern["local"]["ms"],
        "local_plain_ms": kern["local"]["plain_ms"],
        "local_bound_ms": kern["local"]["bound_ms"],
        "local_mqa_ms": mqa["ms"],
        "local_mqa_plain_ms": mqa["plain_ms"],
        "local_mqa_bound_ms": mqa["bound_ms"],
        "local_mqa_shape": f"B={MQA_B} S={MQA_S} H={MQA_H} Kh={MQA_KH} "
                           f"D={MQA_D} window={MQA_WINDOW} cap=0",
        **{f"{tag}_{key}": kern[tag][key] for tag in ("moe_grok", "moe_arctic")
           for key in ("ms", "plain_ms", "bound_ms")},
        "moe_arctic_library_ms": kern["library_moe_arctic"]["library_ms"],
        "local_mqa_library_ms": kern["library_local_mqa"]["library_ms"],
        "moe_shapes": {"moe_" + arch.split("-")[0]:
                       "B={} S={} H={} Kh={} D={} cap={}".format(
                           *MOE[arch][1], *MOE_ATTN[arch])
                       for arch in MOE_ATTN},
        "launches_recurrentgemma_9b":
            rec["recurrentgemma-9b"]["launches"]["flash_attention"],
        "launches_grok_1_314b": grok["launches"]["flash_attention"],
        "launches_arctic_480b": arctic["launches"]["flash_attention"],
    }, {
        "name": "rglru",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rglru/csrc/rglru.cu",
        "replaces": "src/repro/kernels/rglru/kernel.py:53",
        "launches": rec["recurrentgemma-9b"]["launches"]["rglru"],
        "max_abs_err": max(r["max_abs_err"] for n, r in scan.items()
                           if n.startswith("rglru")),
        "ms": rg["ms"],
        "plain_ms": rg["plain_ms"],
        "bound_ms": rg["bound_ms"],
        "bound_by": rg["bound_by"],
        "library_ms": None,
        "shape": "B={} S={} W={} float32".format(*RGLRU_SHAPES["serve"]),
        **{f"long_{k}": scan["rglru_long"][k]
           for k in ("ms", "plain_ms", "bound_ms")},
        "long_shape": "B={} S={} W={} float32".format(*RGLRU_SHAPES["long"]),
    }, {
        "name": "ssd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:69",
        "launches": rec["mamba2-1.3b"]["launches"]["ssd"],
        "max_abs_err": max(r["max_abs_err"] for n, r in scan.items()
                           if n.startswith("ssd")),
        "max_state_err": max(r["state_err"] for n, r in scan.items()
                             if n.startswith("ssd")),
        "ms": sd["ms"],
        "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"],
        "bound_by": sd["bound_by"],
        "library_ms": None,
        "shape": "B={} S={} H={} P={} G={} N={} bfloat16".format(
            *SSD_SHAPES["serve"]),
    }, {
        "name": "gmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/csrc/gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:29",
        "launches": grok["launches"]["gmm"],
        "launches_decode_step": grok["launches_decode_step"]["gmm"],
        "launches_arctic": arctic["launches"]["gmm"],
        "launches_arctic_decode_step":
            arctic["launches_decode_step"]["gmm"],
        "max_abs_err": max(r["max_abs_err"] for r in gmm.values()),
        "ms": gk["ms"],
        "plain_ms": gk["plain_ms"],
        "bound_ms": gk["bound_ms"],
        "bound_by": gk["bound_by"],
        "library_ms": gk["library_ms"],
        "shape": "grok-1 prefill: rows={} D={} F={} E={} bt={} bfloat16"
                 .format(*GMM_CASES["grok"], gk["bt"]),
        "library_case": "torch._grouped_mm on the same padded groups",
        "arctic_ms": ga["ms"],
        "arctic_plain_ms": ga["plain_ms"],
        "arctic_bound_ms": ga["bound_ms"],
        "arctic_bound_by": ga["bound_by"],
        "arctic_library_ms": ga["library_ms"],
        "arctic_shape": "rows={} D={} F={} E={} bt={} bfloat16".format(
            *GMM_CASES["arctic"], ga["bt"]),
        "decode_ms": gmm["decode_bfloat16"]["ms"],
        "decode_bound_ms": gmm["decode_bfloat16"]["bound_ms"],
        "decode_library_ms": gmm["decode_bfloat16"]["library_ms"],
        "launches_by_route": {
            f"{a} {step}": moe[a][key]["gmm"] for a in MOE
            for step, key in (("prefill", "routes"),
                              (f"{GEN_A} decode steps", "routes_decode"))},
        "routes_by_case": {n: r["route"] for n, r in gmm.items()},
        "ms_by_bt": {n: gmm[f"{n}_bfloat16"]["ms_by_bt"]
                     for n in GMM_OTHER_BT},
        "served_ms": {a: moe[a]["served_gmm_ms"] for a in MOE},
        "served_bound_ms": {a: moe[a]["served_gmm_bound_ms"] for a in MOE},
    }] + [{
        "name": f"{op}_tiles",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ckpt_codec/csrc/ckpt_codec.cu",
        "replaces": f"src/repro/kernels/ckpt_codec/kernel.py:{line}",
        "launches": train_res["launches"][f"{op}_tiles"],
        "launches_wire": wire["launches"][f"{op}_tiles"],
        "launches_wire_case": f"{CODEC_ARCH} session replicas: strict "
                              f"round trips, lossy encodes, replica reads, "
                              f"a grid tree",
        "max_abs_err": max(r["max_abs_err"] for r in codec.values()),
        **{k: codec["emb_bfloat16"][op][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": "gemma2-9b embedding shard [64000, 3584] bfloat16",
        "library_case": "none: no single PyTorch call computes the tile "
                        "codec",
        **{f"{case}_{k}": codec[case][op][k]
           for case in CODEC_CASES if case != "emb_bfloat16"
           for k in ("ms", "plain_ms", "bound_ms")},
    } for op, line in (("encode", 39), ("decode", 56))]
    print(f"total_s={time.perf_counter() - t_start:.3f}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
