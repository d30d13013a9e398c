#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port's serve and training paths from
the sources in the checkout (flash attention, the RG-LRU scan, the SSD
scan, the grouped expert matmul gmm, the delta-int8 checkpoint codec's
encode_tiles and decode_tiles; one nvcc a source, side by side), holds
each kernel against its plain PyTorch version at the shapes the paths give
it (and times both), then serves nine models at their full published
widths through the port's entry points, one resident at a time, with
random weights from a seeded generator on the card: gemma2-9b (42 layers, d_model 3584),
recurrentgemma-9b (38 layers: 26 RG-LRU, 12 local MQA attention),
mamba2-1.3b (48 SSD layers), and the MoE models grok-1-314b (8 experts,
depth cut to 4 layers) and arctic-480b (128 experts and a dense residual,
depth cut to 2 layers), whose every MoE layer runs gmm three times in
prefill and in each decode step; then grok-1-314b (2 layers) once more
on two processes of the one card through the port's ``distributed/``
(mesh (1, 2): each rank holds half the experts and half the KV ring;
prefill through ``make_moe_etp``, decode through flash-decoding and the
replicated MoE, logits against rank 0's single-device path; the
compressed reduction and the pipeline on the same ranks); then the
archs phase serves the four archs that complete the registry at full
width and depth: deepseek-coder-33b (62 layers, 2 x 4096),
starcoder2-15b (LayerNorm and biases, 12 q heads a kv head, 2 x 4096),
internvl2-26b (256 prefix
embeddings before 2048 tokens, batch 2) and whisper-tiny (8 x 64 decoder
tokens over 1500 encoder frames: flash non-causal in the encoder and in
the cross-attention, Sq != Sk). Each is served prefill, decode, spill to
a pmem object store, resume, decode, and a short ragged prompt's prefill
logits through the kernels are held against the plain versions, in bf16
and in float32 (the MoE models: bf16 at the cut depth, float32 on a fresh
1-layer model; the three large archs of the archs phase float32 on a
fresh 2-layer model). gemma2-9b's long request is also served through the
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
card. Then it serves a fleet as examples/serve_longcontext.py does, at
gemma2-9b's full width (depth cut to 8 layers, 4 local and 4 global):
one parameter set shared by two workers'
engines, a 5120-token prefix prefilled once and published as a catalog
dataset, two sessions forked from it, suspended as leased datasets with
acked replicas, the home of one killed, both adopted and resumed by the
second worker (tokens bit-exact against an uninterrupted reference, zero
blind store probes), and a mamba2-1.3b session through the strict wire
codec's replica (``peek`` and a resume bit-identical); then runs
examples/torch_workflow_pipeline.py's Fig. 8 pipeline (prep -> {train,
stats} -> eval over the dataset exchange) with gemma2-9b at full width
cut to 2 layers, kills the home of the trained ``model`` dataset and
resumes with no replay, and round-trips the trained embedding through an
``SLMTier``. Every SimCluster runs with its telemetry plane on, as JAX's
default does: each span and point event is a slot of its node's pmem
flight ring. The recovery phase holds each save to one connected
``ckpt.save`` trace whose id its manifest and ack records carry, with the
ack points on their transfer spans and the repair's ``repair.sweep``
trace; the fleet phase runs ``python -m repro_torch.obs.report`` over the
rings that survived the node loss (one ``serve.session`` trace per user,
in its record and continued by the adopting worker's resume); the
workflow's jobs share one trace; and a telemetry leg times
``save_async(drain=True)`` with the plane off and on (JAX's
benchmarks/bench_obs.py) at 8 MiB and 512 MiB and prints the span means
the phases recorded. Then the elastic phase runs
``repro_torch.launch.elastic`` with the training phase's full-width
gemma2-9b and the recovery phase's int8 AdamW moments: 4 steps on 4
nodes, a full save of parameters and AdamW state,
a restore on a second cluster over the same pools (bit-identical), 4 more
steps on 2 nodes and the resumed loss below the first, every pmem write,
flush and tail advance of the phase under the port's persistence
sanitizer (``repro_torch.analysis.PMemSanitizer``), which must report no
violation, beside the recovery phase's save of the same state; the
sanitize phase enumerates the crash images of a MetaLog, a flight ring
and a copy that fails at its commit (made on the card, through the wire
codec's encode_tiles) and replays each, then holds the retried copy's
codes and its read-back to the plain codec. Then it runs the
serve CLI (through a one-node SimCluster) at its defaults and for the
recurrent and MoE archs, the training CLI with delta checkpoints, and the
elastic CLI, and collects two cells of the port's dry run
(``python -m repro_torch.launch.dryrun``: whisper-tiny decode_32k on the
2 x 16 x 16 mesh, grok-1-314b train_4k on 16 x 16 through the
collectives' backward at one microbatch), each a process of its own on
meta tensors over a fake world, started before the kernels' build
(each nvcc on a thread of its own; the phases that need only the
kernels built first run while the SSD scan's nvcc goes on). The
dry run is held to a real run in the serve phase: gemma2-9b's request A
prefill under ``launch/op_analysis`` on the card against the dry run's
trace of the same call on meta tensors (``dryrun_card``: equal FLOPs,
42 flash calls a side, equal argument bytes, the traced peak within 10%
of ``max_memory_allocated``). The distributed phase also runs one
backward of grok-1's smoke config through its train plan's dense layout
and ``make_moe_etp`` on its two ranks against rank 0's single device,
in float32 and in bf16, and a training step of grok-1-314b (full width,
1 layer) on mesh (2, 1) with the reference's FSDP and ZeRO-2 plan
(parameters, int8 moments and gradients each rank's blocks, the
gradients reduce-scattered over "data") against rank 0's single device.
Every kernel launch counter is reset just before a
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
# the dry run's card leg: request A's prefill traced on meta tensors
# against the same call on the card; the traced peak may be this share
# from max_memory_allocated (a first setting; PERF.md records the ratio)
DRYRUN_PEAK_TOL = 0.10
# the dry-run CLI cells, each a process beside the card phases (they
# touch no card): JAX's own smoke cell, and grok-1's training step at
# tp=16 through the collectives' backward, at one microbatch (the step's
# program is the same for each of pick_microbatches' 16)
DRYRUN_CELLS = (("whisper-tiny", "decode_32k", "multi", ()),
                ("grok-1-314b", "train_4k", "single", ("--mb", "1")))
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


# the archs phase: the four archs that complete the registry, each at its
# published width and full depth, one resident at a time: (batch, prompt
# tokens) of the long request, and whisper's encoder frames and
# ``max_seq`` (the length of its learned positions and caches).
# internvl2's 256 prefix embeddings (seeded numpy x 0.02, as
# data/pipeline.py makes them) come before its 2048 text tokens; whisper's
# 64-token decoder prompt reads 1500 encoder frames, 30 s of audio
ARCHS_SERVE = {"deepseek-coder-33b": dict(batch=2, prompt=4096),
               "starcoder2-15b": dict(batch=2, prompt=4096),
               "internvl2-26b": dict(batch=2, prompt=2048),
               "whisper-tiny": dict(batch=8, prompt=64, frames=1500,
                                    max_seq=1536)}
# flash at those prefills (no arch has a softcap): (B, Sq, Sk, H, Kh, D,
# causal). whisper's encoder is non-causal at D=64 and its cross-attention
# reads 1500 frames from 64 decoder rows; starcoder2 puts 12 q heads on
# each kv head. The archs phase checks each model's attention against
# these; the q*8 twins concentrate the softmax
ARCH_ATTN = {"deepseek": (2, 4096, 4096, 56, 8, 128, True),
             "starcoder2": (2, 4096, 4096, 48, 4, 128, True),
             "internvl2": (2, 2304, 2304, 48, 8, 128, True),
             "whisper_enc": (8, 1500, 1500, 6, 6, 64, False),
             "whisper_self": (8, 64, 64, 6, 6, 64, True),
             "whisper_cross": (8, 64, 1500, 6, 6, 64, False)}
ARCH_ATTN_Q8 = ("starcoder2", "whisper_enc", "whisper_cross")
# the float32 logit check: the large archs' float32 weights do not fit
# one card (deepseek-coder-33b's are 133 GB), so it runs a fresh model at
# full width and this depth, cast to float32 leaf by leaf, as the MoE
# phase does; whisper-tiny's runs at full depth (None)
ARCHS_F32_LAYERS = {"deepseek-coder-33b": 2, "starcoder2-15b": 2,
                    "internvl2-26b": 2, "whisper-tiny": None}
# the short ragged prompt's prefill logits through the kernel against the
# plain version (attn_impl "interpret"), as a share of the largest logit.
# float32 (2 layers; whisper 4): summation order and libm only, ~10x the
# largest sound reading on the H100 (7.4e-7 to 1.06e-6); bf16 at full
# depth: a guard against gross faults only, as for the other families
# (sound readings 0.62% whisper to 1.31% deepseek's 62 layers: any one-ulp
# difference grows through the layers; PERF.md)
ARCHS_LOGIT_TOL = {"bfloat16": 4e-2, "float32": 1e-5}

# the distributed phase: grok-1-314b at full width (depth cut) served by a
# world of two processes on the one card, mesh (1, 2) = ("data",
# "model"): expert stacks and the KV ring sharded over "model", the rest
# whole on each rank. The prefill request is the moe phase's (batch 2 x
# 3000); the ring holds it and GEN_A decode steps with room to spare, and
# its length is even, so flash-decoding shards it (seq_ok)
DIST_ARCH, DIST_LAYERS, DIST_WORLD = "grok-1-314b", 2, 2
DIST_BATCH, DIST_PROMPT = 2, 3000
DIST_RING = DIST_PROMPT + 2 * GEN_A
# a capacity factor at which no (token, choice) pair is dropped (every
# expert can take every token twice), for the comparison with the
# dropless single-device reference; the main path runs the config's 1.25
DIST_DROPLESS_CF = 8.0
# logits of the two-rank path against rank 0's single-device path (the
# flash and gmm kernels, no hooks) on the same values, as a share of the
# largest logit: bf16 the MoE family's guard against gross faults, float32
# (1 layer) summation order only
DIST_LOGIT_TOL = {"bfloat16": 4e-2, "float32": 1e-5}
# the small legs on the same two ranks: the compressed reduction's
# elements a rank (JAX's limits: 0.02 after one round, 0.005 over 8) and
# the pipeline's stages, microbatches, rows and width (within 1e-5 of the
# stages run in turn, float32)
DIST_COMPRESS_N, DIST_COMPRESS_ROUNDS = 2 * 1024 * 64, 8
# the collectives' backward on the same two ranks: this arch's smoke
# config through its train plan's dense layout and MoE hook, batch x
# sequence of its training loss; each leaf's gradient within this share
# of rank 0's single-device gradient of the same dtype, in norm. float32
# holds the program's logic; bf16 differs from the single device by the
# rounding of the tensor-parallel partial sums (the smoke config
# rehearsed on the CPU: float32 9.0e-7, bf16 1.9%, either bf16 side 3.9%
# from float32), so the bf16 side also stays within DIST_GRAD_F32_RATIO
# of the single device's own distance from the float32 gradient
DIST_TRAIN_ARCH, DIST_TRAIN_SHAPE = "grok-1-314b", (4, 64)
DIST_GRAD_TOL = {"float32": 1e-5, "bfloat16": 0.1}
DIST_GRAD_F32_RATIO = 1.5
# the dense train legs' loss against the single-device step's
DIST_TRAIN_LOSS_TOL = 1e-2
DIST_PIPE = (2, 8, 2, 16)
# the dense layout's legs on the same two ranks. Serve: gemma2-9b at full
# width on (1, 2) (heads, MLP and vocabulary cut over "model", 8 q / 4 kv
# heads a rank), its depth cut from 42 to DIST_DENSE_LAYERS to keep the
# run inside its limit on a slow host (the full depth measured 2.418 s
# of prefill and 9.087 s of decode on one H100 host, 3.436 and 16.758 on
# another: each decode step runs ~6 gloo collectives a layer on the one
# card), GEN_A decode steps fed rank 0's single-device greedy tokens;
# logits held to DIST_LOGIT_TOL["bfloat16"]. Train: gemma2-9b at full width cut
# to DIST_TRAIN_LAYERS layers, one AdamW step (float32 moments, lr large
# enough that the bf16 update shows) on (2, 1) (ZeRO-1: each rank half
# the moments) and on (1, 2), each against the single-device step: the
# loss within DIST_TRAIN_LOSS_TOL; over this rank's blocks of the tree, the
# first moments (a tenth of the clipped gradient) within
# DIST_MOMENT_TOL in norm and the updates (new - old parameters) within
# DIST_UPDATE_TOL. bf16 guards against gross faults (a missing sum gives
# ~1): a row-parallel product rounds its partial sums to bf16 before the
# psum, a bf16 gradient entry near 0 may take the other sign (Adam's first
# step moves every entry by about lr), the zero-initialised gemma norm
# weights have small, noisy gradients, and the new parameter's bf16
# rounding is ~1% of lr (the smoke config rehearsed on the CPU at (1, 2):
# 0.015 and 0.13)
DIST_DENSE_ARCH, DIST_DENSE_BATCH, DIST_DENSE_PROMPT = "gemma2-9b", 2, 1024
DIST_DENSE_LAYERS = 6
DIST_DENSE_RING = DIST_DENSE_PROMPT + 2 * GEN_A
DIST_TRAIN_LAYERS, DIST_TRAIN_BATCH, DIST_TRAIN_SEQ = 2, 2, 512
DIST_TRAIN_LR, DIST_MOMENT_TOL, DIST_UPDATE_TOL = 1e-2, 5e-2, 0.25
# the FSDP leg on the same two ranks: grok-1-314b at full width cut to
# DIST_FSDP_LAYERS layer (4.92e9 parameters, the embeddings 1.61e9: 13.06
# GB in bf16; 2 layers would take ~115 GB of the card with both ranks'
# parameters, gradients, int8 moments and their new copies), one AdamW
# step on (2, 1) with the reference's plan: the parameters FSDP-cut over
# "data" (``launch/dryrun.plan_fsdp``), the gradients as ZeRO-2 blocks
# (``train_step.zero2_shardings``), int8 moments (the full config's
# choice, ``dryrun.adamw_for``), one microbatch, blockwise attention, the
# experts through make_moe_etp2d; at DIST_DROPLESS_CF, so that the loss
# and gradient norm can be held to rank 0's single-device step (the dense
# gshard route) within DIST_TRAIN_LOSS_TOL
DIST_FSDP_ARCH, DIST_FSDP_LAYERS = "grok-1-314b", 1
DIST_FSDP_BATCH, DIST_FSDP_SEQ = 2, 512
# both ranks must have exited 0 by then, the spawn and the builds of the
# ranks' parameters included
DIST_DEADLINE_S = 540


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
# the fleet phase (examples/serve_longcontext.py at gemma2-9b's width): a
# system prompt past the 4096 window, FLEET_GEN tokens decoded by each
# user on each side of the node loss, a DLM cache that holds two states
# and not three. Its depth is cut from 42 to FLEET_LAYERS (4 local and 4
# global layers): each published or suspended state is 0.30 GB, not the
# full depth's 1.59, and the phase's pmem writes and replicas shrink with
# it (the serve phase serves gemma2-9b at full depth); the DLM cache, 4
# GiB at full depth, shrinks in proportion
FLEET_PROMPT, FLEET_GEN, FLEET_LAYERS = 5120, 16, 8
FLEET_USERS = ("alice", "bob")
FLEET_DLM_CAPACITY = 3 << 28
# the fleet's codec leg: one mamba2-1.3b session of this many tokens
FLEET_CODEC_PROMPT = 4000
# the recovery phase: the train phase's model and batch with AdamW's int8
# moments, 6 steps, a save every 2 (full at 2, deltas at 4 and 6, each
# replicated through the strict wire codec and drained), the last node
# lost after step 5
RECOVERY_STEPS, RECOVERY_FAULT_AT = 6, 5
# the telemetry leg (benchmarks/bench_obs.py's design): runs a leg, and
# the states, (shape, dtype, saves a run) on the card: JAX's 8 MiB float32
# (bench_obs.py's 512 x 4096, 8 saves) and 512 MiB of bf16, whose saves run
# at the host's pmem rate (2.6-4.3 s each on the H100's hosts, PERF.md),
# cut from 8 to 4 saves a run, then to 2, and from 3 runs a leg to 2,
# then to 1 (the whole run must stay inside its limit on a slow host), so
# that the leg stays near 15 s
TELEMETRY_REPS = 1
TELEMETRY_STATES = {"8MiB_float32": ((512, 4096), "float32", 8),
                    "512MiB_bfloat16": ((16384, 16384), "bfloat16", 2)}
# the elastic phase (repro_torch.launch.elastic at the train phase's model
# and batch): ELASTIC_STEPS steps on ELASTIC_NODES[0] nodes, a full save of
# parameters and AdamW state, a restore on a second cluster over the same
# pools, ELASTIC_STEPS more steps on a fresh ELASTIC_NODES[1]-node cluster;
# every pmem write under the port's persistence sanitizer. Its AdamW
# moments are the recovery phase's int8 ones (ELASTIC_MOMENTS): the state
# it saves and restores is 9.0 GB, not the float32 moments' 22.3 GB (the
# train phase saves that one), and the run stays inside its limit
ELASTIC_STEPS, ELASTIC_NODES, ELASTIC_MOMENTS = 4, (4, 2), "int8"
# the sanitize phase (capture mode, JAX's three crash tests): MetaLog
# appends, flight-ring events (8 slots of 128 B), and a crash mid-copy of
# an object made on the card, float32 leaves of this shape, copied through
# the lossy wire codec in chunks of SANITIZE_CHUNK bytes
SANITIZE_APPENDS, SANITIZE_RING_EVENTS = 4, 6
SANITIZE_COPY_SHAPE, SANITIZE_CHUNK = (512, 1024), 256 << 10


#: seconds one phase may take before the run counts as hung; a whole run
#: took 460-605 s on an H100 (PERF.md, section 6)
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


def run_timed(fn, *args):
    """``run_phase`` and a line with the phase's seconds (host clock)."""
    t0 = time.perf_counter()
    out = run_phase(fn, *args)
    label = fn.__name__ + "".join(f" {a}" for a in args[2:3]
                                  if isinstance(a, str))
    print(f"phase {label}: {time.perf_counter() - t0:.3f}s")
    return out


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


def start_builds() -> dict:
    """Start the kernel sources' builds, one nvcc each, all together, on
    threads of their own: the phases that need only the sources built
    first run while the slowest nvcc (the SSD scan's) goes on.
    ``wait_builds`` collects them."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    mods = kernel_ops()
    pool = ThreadPoolExecutor(len(mods))
    t0 = time.perf_counter()
    done_at = {}
    futs = {}
    for name, mod in mods.items():
        futs[name] = pool.submit(build.build, name, mod.SOURCE)
        futs[name].add_done_callback(
            lambda f, n=name: done_at.setdefault(n, time.perf_counter()))
    return {"pool": pool, "t0": t0, "futs": futs, "done_at": done_at,
            "n": len(mods)}


def wait_builds(builds: dict, names) -> None:
    """Wait for the named builds and print each; after the last one, the
    seconds from the start of the builds to the end of the last nvcc."""
    for name in names:
        b = builds["futs"].pop(name).result()
        print(f"build {name}: nvcc {b.seconds:.3f}s -> "
              f"{b.path.relative_to(ROOT)}")
        for line in b.ptxas_report.splitlines():
            if "Function properties" in line or "Used" in line or \
                    "spill" in line:
                print(f"  ptxas {line.strip()}")
    if not builds["futs"]:
        builds["pool"].shutdown()
        print(f"build: {builds['n']} kernels in "
              f"{max(builds['done_at'].values()) - builds['t0']:.3f}s")


def attention_bound_ms(b, s, h, kh, d, causal, window, itemsize=2,
                       sk=None):
    """Least time for the work this run's masks leave: 4*D FLOPs per
    visible (q, k) pair and head, against q/k/v/o read or written once.
    ``sk`` is the key length (default ``s``: self-attention); a causal
    row q sees keys 0..q."""
    sk = s if sk is None else sk
    q = np.arange(s)
    seen = np.minimum(q + 1, sk) if causal else np.full(s, sk)
    if window:
        seen = np.minimum(seen, window)
    flops = 4.0 * b * h * d * float(seen.sum())
    nbytes = (2 * b * s * h * d + 2 * b * sk * kh * d) * itemsize
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
    results.update(arch_attention_cases(device, gen))
    return results


def arch_attention_cases(device, gen):
    """flash at the archs phase's prefill shapes (ARCH_ATTN: Sq != Sk,
    non-causal, D=64, a group of 12) against its plain version, timed
    beside its bound and SDPA, which computes the same function here (no
    softcap): non-causal where the mask is none, with ``enable_gqa``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    results = {}
    cases = {name: (shape, 1.0) for name, shape in ARCH_ATTN.items()}
    cases.update({f"{name}_q8": (ARCH_ATTN[name], Q_SCALE)
                  for name in ARCH_ATTN_Q8})
    for name, ((b, sq, sk, h, kh, d, causal), qscale) in cases.items():
        q, k, v = [torch.randn((b, n_s, n, d), generator=gen, device=device,
                               dtype=torch.float32)
                   for n_s, n in ((sq, h), (sk, kh), (sk, kh))]
        q, k, v = [t.to(torch.bfloat16) for t in (q * qscale, k, v)]
        kw = dict(causal=causal, window=0, cap=0.0)
        got = fa_ops.flash_attention(q, k, v, **kw)
        sync()
        want = fa_ops.reference(q, k, v, **kw)
        sync()
        err = (got.float() - want.float()).abs().max().item()
        row_err = fa_ref.row_error(got, want)
        print(f"kernel flash_attention {name}: B={b} Sq={sq} Sk={sk} H={h} "
              f"Kh={kh} D={d} q*{qscale} {kw} route {fa_ops.route(q, k)}: "
              f"max_abs_err={err} (atol=rtol={KERNEL_TOL}) row_err="
              f"{row_err} (tol {fa_ref.BF16_ROW_TOL})")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(torch.allclose(got.float(), want.float(), atol=KERNEL_TOL,
                             rtol=KERNEL_TOL),
              f"flash_attention {name}: max |kernel - plain| {err} beyond "
              f"atol=rtol={KERNEL_TOL}")
        check(row_err <= fa_ref.BF16_ROW_TOL,
              f"flash_attention {name}: row error {row_err} beyond "
              f"{fa_ref.BF16_ROW_TOL}")
        del want
        reps = 10 if sq * sk > 1 << 20 else 50
        ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), reps)
        plain_ms = cuda_ms(lambda: fa_ops.reference(q, k, v, **kw),
                           max(reps // 5, 2))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        lib_err = (sdpa().transpose(1, 2).float() - got.float()).abs() \
            .max().item()
        lib_ms = cuda_ms(sdpa, reps)
        bound, bound_by = attention_bound_ms(b, sq, h, kh, d, causal, 0,
                                             sk=sk)
        results[name] = dict(max_abs_err=err, row_err=row_err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound,
                             bound_by=bound_by, library_ms=lib_ms,
                             route=fa_ops.route(q, k),
                             shape=f"B={b} Sq={sq} Sk={sk} H={h} Kh={kh} "
                                   f"D={d} causal={causal} q*{qscale}")
        print(f"  kernel_ms={ms} plain_ms={plain_ms} bound_ms={bound} "
              f"({bound_by}) scaled_dot_product_attention_ms={lib_ms} "
              f"(max_abs_err vs kernel {lib_err})")
        del q, k, v, qt, kt, vt, got
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


def gemma2_9b(device, layers=None):
    """The gemma2-9b config (its full depth, or ``layers`` at full
    width), its runtime (the kernel's route) and random bf16 parameters
    made on the card from the seed."""
    import torch
    from repro_torch.bridge import tree_leaves
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm

    cfg = registry.get_config("gemma2-9b")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
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


def dryrun_card(device, card: str, cfg, rt, params, prompts) -> dict:
    """The dry run held to a real run: request A's prefill (full width,
    42 layers, 2 x 5120, the flash kernel) under ``op_analysis`` on the
    card, the peak-memory stats reset just before it, then
    ``dryrun.build_and_trace`` of the same call on meta tensors (a 1 x 1
    mesh, a ShapeConfig of the same batch and length, the same runtime).
    Hard failures: FLOP totals that differ at all, flash calls other than
    one a layer on either side, traced argument bytes other than the live
    parameters' and tokens', a traced peak more than DRYRUN_PEAK_TOL from
    ``max_memory_allocated``."""
    import torch
    from repro_torch.bridge import tree_leaves
    from repro_torch.configs import ParallelConfig, ShapeConfig
    from repro_torch.configs.base import PREFILL
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm

    tokens = torch.as_tensor(prompts, device=device)
    live = sum(t.numel() * t.element_size() for _, t in tree_leaves(params))
    live += tokens.numel() * tokens.element_size()
    release()
    sync()
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        (logits, caches), got = op_analysis.analyze(tfm.prefill, params,
                                                    cfg, rt, tokens)
        sync()
    card_s = time.perf_counter() - t0
    cuda_peak = torch.cuda.max_memory_allocated(device)
    del logits, caches
    release()
    shape = ShapeConfig("chip_prefill", PROMPT_A, BATCH_A, PREFILL)
    want = dryrun.build_and_trace(
        "gemma2-9b", shape.name, False, ParallelConfig(attn_impl="pallas"),
        shape=shape, mesh=make_mesh((1, 1), ("data", "model")), rt=rt,
        mesh_name="1x1")
    traced = want["memory"]["traced"]
    calls = (got["kernels"].get("flash_attention", {}).get("calls"),
             want["kernels"].get("flash_attention", {}).get("calls"))
    ratio = traced["peak_bytes"] / cuda_peak
    print(f"dryrun_card: {cfg.name} prefill {BATCH_A} x {PROMPT_A} "
          f"({cfg.n_layers} layers, flash): flops card "
          f"{got['flops']:.6e} meta {want['flops_per_device']:.6e}; "
          f"bytes card {got['bytes']:.6e} meta "
          f"{want['bytes_per_device']:.6e}; flash calls card {calls[0]} "
          f"meta {calls[1]}; held bytes live {live} meta "
          f"{traced['arg_bytes']}; peak meta-traced {traced['peak_bytes']} "
          f"card-traced {got['peak_bytes']} max_memory_allocated "
          f"{cuda_peak} (allocated before {before}); ratio meta/card "
          f"{ratio:.4f}; card {card_s:.3f}s, trace "
          f"{want['timing']['trace_s']:.3f}s [{card}]")
    check(got["flops"] == want["flops_per_device"],
          f"dryrun_card: FLOPs card {got['flops']} != meta "
          f"{want['flops_per_device']}")
    check(calls == (cfg.n_layers, cfg.n_layers),
          f"dryrun_card: flash calls {calls}, want {cfg.n_layers} each")
    check(traced["arg_bytes"] == live,
          f"dryrun_card: traced argument bytes {traced['arg_bytes']} != "
          f"live {live}")
    check(abs(ratio - 1.0) <= DRYRUN_PEAK_TOL,
          f"dryrun_card: traced peak {traced['peak_bytes']} vs "
          f"max_memory_allocated {cuda_peak} (ratio {ratio:.4f})")
    return {"flops": got["flops"], "bytes": got["bytes"],
            "meta_bytes": want["bytes_per_device"], "ratio": ratio,
            "peak_meta": traced["peak_bytes"],
            "peak_card_traced": got["peak_bytes"], "cuda_peak": cuda_peak}


def serve_phase(device, card: str):
    """gemma2-9b served through ServeEngine: the dry run's card leg
    (``dryrun_card``), request A (the long prompt, spill/resume) and
    request B (kernel vs its plain version)."""
    import torch
    cfg, rt, params = gemma2_9b(device)
    rng = np.random.default_rng(SEED)
    a = rng.integers(0, cfg.vocab_size, (BATCH_A, PROMPT_A)).astype(np.int32)
    b = rng.integers(0, cfg.vocab_size, (BATCH_B, PROMPT_B)).astype(np.int32)
    dry = dryrun_card(device, card, cfg, rt, params, a)
    out = request_a(device, card, cfg, rt, params, a)
    out["dryrun_card"] = dry
    out.update(request_b(device, cfg, rt, params, b))
    del params
    release()
    return out


def layer_counts(cfg, decode: bool = False) -> dict:
    """The launches of each kernel in one prefill (one per layer of the
    kernel's mixer, three gmm per MoE layer; an encoder-decoder adds one
    flash per encoder layer and one per decoder layer's cross-attention),
    or in one decode step (the three gmm of each MoE layer only)."""
    from repro_torch.configs.base import MLP_MOE, RGLRU, SSD
    counts = {name: 0 for name in launch_counters()}
    if cfg.enc_dec and not decode:
        counts["flash_attention"] += cfg.n_enc_layers + cfg.n_layers
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


def model_request(device, card: str, cfg, rt, params, prompts,
                  frontend=None):
    """A family's main path, as request A: prefill a long prompt (with
    the model's ``frontend`` inputs: internvl2's prefix, whisper's
    frames), decode, then the same tokens across export/install and
    across spill/resume of the state (bf16 KV and cross caches, float32
    recurrent state and bf16 windows), and the resumed state equal to the
    spilled one, leaf for leaf and bit for bit (a random-weight model's
    greedy tokens may not depend on it). Launches are counted per prefill
    and per decode step."""
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
    first = eng.prefill(prompts, **(frontend or {}))
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


def serve_repair_check(device, card: str, cfg, rt, params, state, last,
                       direct):
    """mamba2-1.3b's session spilled through TieredIO on a 3-node cluster
    (DLM home node0, replica acked on node1), node0 lost: the engine's
    ``repair(["node0"])`` copies the replica to a third node; then node1,
    the replica's first holder, is lost too, and a fresh engine resumes
    from the copy repair made, state bit-identical and tokens
    identical."""
    from repro_torch.bridge import tree_leaves
    from repro_torch.core.cluster import SimCluster
    from repro_torch.serve.engine import ServeEngine

    name = "mamba2-repair"
    obj = f"dlm/serve/{name}"
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in tree_leaves(state["cache"]))
    root = pool_root(4 * nbytes + (1 << 30))
    cluster = SimCluster(root, n_nodes=3, device=device)
    try:
        eng = ServeEngine(cfg, rt, params, tiered=cluster.tiered,
                          device=device)
        eng.install_state(state)
        sync()
        eng.spill(name, wait=False).result()
        check(cluster.tiered.quiesce() == [] and
              cluster.tiered.dlm_acks.targets(obj) == ["node1"],
              f"{cfg.name} repair: the spill's replica was not acked on "
              f"node1")
        check(eng.evict_cold_sessions() == 1, "repair: not resident")
        cluster.kill_node("node0")
        t0 = time.perf_counter()
        report = eng.repair(["node0"])
        repair_s = time.perf_counter() - t0
        copies = report["repaired"]
        check(len(copies) == 1 and copies[0][:3] == ("dlm", obj, "node1")
              and not report["errors"],
              f"{cfg.name} repair: report {report}, want one dlm copy of "
              f"{obj} from node1")
        new = copies[0][3]
        check(new not in ("node0", "node1") and
              cluster.tiered.dlm_acks.targets(obj) == sorted(["node1", new]),
              f"{cfg.name} repair: new holder {new}, acks "
              f"{cluster.tiered.dlm_acks.targets(obj)}")
        cluster.kill_node("node1")
        fresh = ServeEngine(cfg, rt, params, tiered=cluster.tiered,
                            device=device)
        t0 = time.perf_counter()
        fresh.resume(name)
        sync()
        resume_s = time.perf_counter() - t0
        check(state_bits_equal(fresh.export_state(), state),
              f"{cfg.name} repair: the state resumed from {new}'s copy "
              f"differs from the spilled one")
        toks = fresh.decode(last, EXTRA)
        check(np.array_equal(toks, direct), f"{cfg.name} repair: tokens "
              f"{toks} after losing node0 and node1, want {direct}")
        del eng, fresh
    finally:
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    release()
    print(f"{cfg.name} serve repair: {nbytes} B session; after node0's loss"
          f" engine.repair copied {copies[0]} in {repair_s} s; after node1's"
          f" loss too a fresh engine resumed from {new} in {resume_s} s: "
          f"state bit-identical, tokens identical [{card}]")
    return dict(repair_s=repair_s, resume_s=resume_s, copy=copies[0])


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
        out["repair"] = serve_repair_check(device, card, cfg, rt, params,
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


def arch_frontend(cfg, rng, batch: int, req: dict) -> dict:
    """The model's precomputed inputs for a batch, seeded numpy:
    internvl2's ``prefix_embeds`` (x 0.02, as data/pipeline.py makes
    them), whisper's ``enc_frames``."""
    out = {}
    if cfg.prefix_len:
        out["prefix_embeds"] = (rng.standard_normal(
            (batch, cfg.prefix_len, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.enc_dec:
        out["enc_frames"] = rng.standard_normal(
            (batch, req["frames"], cfg.d_model)).astype(np.float32)
    return out


def check_arch_attention(cfg, req: dict) -> None:
    """The model's flash launches have the shapes the kernel phase held
    (ARCH_ATTN)."""
    from repro_torch.configs.base import ATTN_GLOBAL
    b, s = req["batch"], req["prompt"] + cfg.prefix_len
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.enc_dec:
        f = req["frames"]
        want = {"whisper_enc": (b, f, f) + heads + (False,),
                "whisper_self": (b, s, s) + heads + (True,),
                "whisper_cross": (b, s, f) + heads + (False,)}
    else:
        want = {cfg.name.split("-")[0]: (b, s, s) + heads + (True,)}
    check({spec.mixer for spec in cfg.pattern} == {ATTN_GLOBAL} and
          cfg.attn_softcap == 0 and
          all(ARCH_ATTN[n] == w for n, w in want.items()),
          f"{cfg.name}: attention {want} differs from ARCH_ATTN")


def arch_logits(device, cfg, rt, params, prompts, frontend, dtype: str):
    """The short ragged prompt's prefill logits through the kernel against
    the plain version (attn_impl "interpret") on the same parameters.
    Returns the gap, the largest logit and whether the argmax agrees."""
    import torch
    from repro_torch import bridge
    from repro_torch.models import transformer as tfm

    want = layer_counts(cfg)
    plain_rt = dataclasses.replace(rt, attn_impl="interpret")
    tok_t = torch.as_tensor(prompts, device=device)
    extra = {k: bridge.to_torch(v, device) for k, v in frontend.items()}
    reset_launches()
    with torch.no_grad():
        lk, _ = tfm.prefill(params, cfg, rt, tok_t, **extra)
        mid = read_launches()
        lp, _ = tfm.prefill(params, cfg, plain_rt, tok_t, **extra)
    sync()
    check(mid == want and read_launches() == mid,
          f"{cfg.name} {dtype}: the kernel prefill must launch {want} and "
          f"the plain one none ({mid}, {read_launches()})")
    check(bool(torch.isfinite(lk).all()) and
          lk.shape == (prompts.shape[0], cfg.padded_vocab),
          f"{cfg.name} {dtype} logits {tuple(lk.shape)} not finite/shaped")
    err, scale = (lk - lp).abs().max().item(), lp.abs().max().item()
    same = bool((lk.argmax(-1) == lp.argmax(-1)).all())
    limit = ARCHS_LOGIT_TOL[dtype]
    print(f"{cfg.name} {dtype} ({cfg.n_layers} layers): prefill logits "
          f"kernel vs plain version: max_abs_err={err} max |logit| {scale} "
          f"rel={err / scale} (tol {limit}) argmax equal={same}")
    peak_line(device, f"{dtype} logit check")
    return err, scale, same


def archs_phase(device, card: str, arch: str):
    """One of the four archs that complete the registry, at its published
    width and full depth: its long request (the main path: prefill with
    the model's frontend, 16 decode tokens, spill/resume bit-identical,
    every flash launch on the wgmma route), then the short ragged prompt's
    logits through the kernel against the plain version in bf16 at full
    depth and in float32 (ARCHS_F32_LAYERS). Every model is freed at the
    end."""
    import torch
    from repro_torch.bridge import tree_leaves
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm

    req = ARCHS_SERVE[arch]
    cfg = registry.get_config(arch)
    check_arch_attention(cfg, req)
    batch, prompt = req["batch"], req["prompt"]
    rt = tfm.ModelRuntime(tp=1, max_seq=req.get(
        "max_seq", prompt + cfg.prefix_len + GEN_A + 2 * EXTRA + 8))
    check(rt.attn_impl == "pallas", "the runtime's default must be the "
                                    "kernel")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = tfm.init_params(cfg, rt, gen, device=device)
    sync()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    nbytes = sum(t.numel() * t.element_size() for _, t in tree_leaves(params))
    print(f"serve {cfg.name}: {cfg.n_layers} layers"
          f"{f' + {cfg.n_enc_layers} encoder layers' if cfg.enc_dec else ''}"
          f" d_model={cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} of "
          f"{cfg.resolved_head_dim} norm={cfg.norm} vocab={cfg.vocab_size} "
          f"prefix_len={cfg.prefix_len}, {n_params} parameters ({nbytes} B; "
          f"param_count {cfg.param_count()}) made on the card in "
          f"{time.perf_counter() - t0:.3f}s; kernels per prefill "
          f"{layer_counts(cfg)}")
    peak_line(device, "init")
    rng = np.random.default_rng(SEED)
    long = rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    front = arch_frontend(cfg, rng, batch, req)
    short = rng.integers(0, cfg.vocab_size,
                         (BATCH_B, PROMPT_B)).astype(np.int32)
    short_front = arch_frontend(cfg, rng, BATCH_B, req)
    out = model_request(device, card, cfg, rt, params, long, front)
    del out["handoff"]
    gaps = {"bfloat16": arch_logits(device, cfg, rt, params, short,
                                    short_front, "bfloat16")}
    layers = ARCHS_F32_LAYERS[arch]
    if layers is None:
        one = cfg
    else:
        del params
        release()
        torch.cuda.reset_peak_memory_stats(device)
        one = dataclasses.replace(cfg, n_layers=layers)
        gen = torch.Generator(device=device).manual_seed(SEED + 1)
        params = tfm.init_params(one, rt, gen, device=device)
        print(f"{cfg.name} float32 check: reduced n_layers {cfg.n_layers} "
              f"-> {layers} (full width)")
    cast_leaves_(params, torch.float32)
    sync()
    peak_line(device, f"{one.n_layers}-layer model, cast to float32")
    gaps["float32"] = arch_logits(device, one, rt, params, short,
                                  short_front, "float32")
    del params
    release()
    for dtype, (err, scale, _) in gaps.items():
        limit = ARCHS_LOGIT_TOL[dtype]
        check(err <= limit * scale,
              f"{arch} {dtype} logits: kernel vs plain max |diff| {err} > "
              f"{limit} * {scale}")
        out[f"logit_err_{dtype}"] = err
        out[f"logit_rel_{dtype}"] = err / scale
    out["f32_layers"] = one.n_layers
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


def check_restore_bound(ck, manifest, restored, live, lost=()) -> float:
    """Every element of a delta step's restore within its tile's scale / 2
    plus half an ulp of the leaf dtype (plus two float32 ulps of the
    codec's arithmetic) of the live state it encoded, shard by shard,
    with the scales the save stored, read where the restore read them
    (for a node in ``lost``: its replica or its drained copy). An
    int-typed leaf (the int8 moment codes, the step) is held to the
    bound before the cast back: its float32 decode is recomputed on the
    card from the stored codes and the base shard with the decode's
    plain version, and the restored values must be that decode
    truncated and wrapped as JAX's ``astype`` makes them. A shard the
    save stored raw (its base shard has another shape, as after the ring
    shrank) must come back bit for bit. Returns the largest ratio of an
    error to its bound."""
    import torch
    from repro_torch.bridge import to_torch, tree_leaves
    from repro_torch.core.checkpoint import _names, _read_leaf
    from repro_torch.kernels.ckpt_codec import ops as codec_ops
    step = manifest["step"]
    obj = f"ckpt/slot{manifest['slot']}"
    ring = manifest.get("nodes") or ck.nodes
    acks = ck.acks(step)
    bstep = manifest["delta_base"]
    bman = ck._meta_get_json(f"ckpt/manifest_step{bstep}.json")
    srcs, bases = {}, {}

    def source(nid):
        if nid not in srcs:
            s = ck._locate_shard(nid, obj, step, acks, ring, lost)
            srcs[nid] = s if s is not None else \
                ("flat", ck._drained_leaves(nid, step))
        return srcs[nid]

    def base(nid):
        if nid not in bases:
            bases[nid] = ck._base_source(nid, bstep, bman, lost)
        return bases[nid]

    live = dict(tree_leaves(live))
    worst = 0.0
    for path, got in tree_leaves(restored):
        want = live[path]
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"restore {path}: {got.shape} {got.dtype}, want {want.shape} "
              f"{want.dtype}")
        for nid, start, rows in manifest["leaves"][path]["shards"]:
            if got.dim():
                g, w = got[start:start + rows], want[start:start + rows]
            else:
                g, w = got, want
            if path + ".__ds" not in _names(source(nid)):
                check(torch.equal(g, w), f"restore {path} on {nid}: a raw "
                                         f"shard differs from the saved one")
                continue
            w = w.double().reshape(-1)
            sc = to_torch(_read_leaf(ck.stores, source(nid), path + ".__ds"),
                          got.device)
            tile = sc.double().expand(-1, 1024).reshape(-1)[:w.numel()]
            if got.dtype.is_floating_point:
                gd = g.double().reshape(-1)
                mag = torch.maximum(gd.abs(), w.abs())
                mant = 7 if got.dtype == torch.bfloat16 else 23
                half_ulp = torch.exp2(torch.floor(torch.log2(
                    mag.clamp_min(1e-38))) - mant - 1)
            else:
                q = to_torch(_read_leaf(ck.stores, source(nid),
                                        path + ".__dq"), got.device)
                b = to_torch(_read_leaf(ck.stores, base(nid), path,
                                        verify=False), got.device)
                f = codec_ops.delta_decode(q, sc, b.to(torch.int32),
                                           shape=tuple(b.shape),
                                           dtype=torch.float32,
                                           interpret=True)
                check(torch.equal(f.to(torch.int32).to(got.dtype), g),
                      f"restore {path} on {nid}: the int leaf is not its "
                      f"float32 decode truncated")
                gd = f.double().reshape(-1)
                mag = torch.maximum(gd.abs(), w.abs())
                half_ulp = torch.zeros_like(mag)
                del q, b, f
            # the float32 arithmetic: d = new - base, d / scale and
            # base + q * scale round to float32 (base within 128 scales)
            slack = (mag + 128 * tile) * 2 ** -22
            ratio = ((gd - w).abs() / (tile / 2 + half_ulp + slack)).max()
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
        worst = check_restore_bound(cluster.checkpointer, man4, got4,
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


def disk_root(need_bytes: int) -> Path:
    """A temp dir on disk with room for ``need_bytes``: the external
    store of the recovery phase (the paper's external filesystem), kept
    off /dev/shm, which holds the pmem pools in the host's memory."""
    root = Path(tempfile.mkdtemp(prefix="repro_torch_external_"))
    free = shutil.disk_usage(root).free
    check(free >= need_bytes, f"no room for {need_bytes} B of drains: "
                              f"{root} has {free} B free")
    return root


def diff_launches(now: dict, then: dict) -> dict:
    return {k: now[k] - then[k] for k in ("encode_tiles", "decode_tiles")}


def ckpt_copies(ck, step: int, lost) -> dict:
    """Each shard owner's surviving acked copy holders at ``step``."""
    from repro_torch.core.dataset_exchange import ack_targets
    rec = ck.ack_record(step)
    acks = rec.get("acks") or {}
    return {nid: ({nid} | set(ack_targets(acks.get(nid, {}).get("replica"))))
            - set(lost) for nid in rec.get("ring") or ck.nodes}


def check_save_traces(cluster, ck, steps, lost) -> dict:
    """The telemetry plane's record of the recovery loop, read off the
    surviving flight rings: each save of ``steps`` is one ``ckpt.save``
    trace whose id its manifest carries, every span in it connected to
    its root; each ``ckpt.ack.replica``/``ckpt.ack.drain`` point hangs on
    a ``ckpt.replicate``/``ckpt.drain`` transfer span; every drain ack
    record carries the save's trace, every replica ack the save's or the
    repair sweep's (a copy repair made); the repair after ``lost`` left a
    ``repair.sweep`` trace. Returns counts for the report line."""
    from repro_torch.obs.trace import connected_to_root
    events, traces = ring_traces(cluster)
    saves = rooted_at(traces, "ckpt.save")
    sweeps = {tid: tr for tid, tr in rooted_at(traces, "repair.sweep")
              .items() if any(tr["spans"][r]["attrs"].get("lost") ==
                              sorted(lost) for r in tr["roots"])}
    check(len(sweeps) >= 1, f"recovery: no repair.sweep trace for {lost}")
    check(len(saves) == len(steps),
          f"recovery: {len(saves)} ckpt.save traces for saves {steps}")
    acks = {"ckpt.ack.replica": 0, "ckpt.ack.drain": 0}
    for st in steps:
        tid = ck._meta_get_json(f"ckpt/manifest_step{st}.json")["trace"][
            "trace"]
        tr = saves.get(tid)
        check(tr is not None and len(tr["roots"]) == 1 and
              tr["spans"][tr["roots"][0]]["attrs"].get("step") == st,
              f"recovery: save {st}'s manifest trace {tid:x} is no "
              f"ckpt.save tree of its own")
        check(all(connected_to_root(tr, sid) for sid in tr["spans"]),
              f"recovery: save {st}'s trace has spans off its root")
        for sp in tr["spans"].values():
            for ev in sp["events"]:
                want = {"ckpt.ack.replica": "ckpt.replicate",
                        "ckpt.ack.drain": "ckpt.drain"}.get(ev["name"])
                if want is not None:
                    check(sp["name"] == want and ev["parent"] in tr["spans"],
                          f"recovery: {ev['name']} of save {st} on a "
                          f"{sp['name']} span")
                    acks[ev["name"]] += 1
        rec = ck.ack_record(st)
        for nid, kinds in rec["acks"].items():
            for kind, info in kinds.items():
                ok = {tid} | (set(sweeps) if kind == "replica" else set())
                check(info.get("trace") in ok,
                      f"recovery: step {st}'s {kind} ack of {nid} carries "
                      f"trace {info.get('trace')}, want the save's {tid}")
    check(all(acks.values()), f"recovery: ack points {acks}")
    return {"events": len(events), "save_traces": len(saves),
            "sweep_traces": len(sweeps), "ack_points": acks}


def recovery_phase(device, card: str):
    """gemma2-9b at full width (2 layers) trained with AdamW's int8
    blockwise moments through a node loss, on a 4-node cluster whose
    saves are replicated through the strict wire codec and drained
    (``drain_every=1``): a full save at step 2, deltas at 4 and 6. After
    step 5 the loop kills node3, restores step 4 (node3's shard from its
    buddy replica, decoded on the card), repairs and resumes. The
    restored state is held to the step-4 state within the codec's
    bound (int leaves before their cast), the repair leaves every acked
    shard two live copies, and the final save is DRAINED. Then a new
    buddy that repair chose is lost (the newest step still restores),
    then its ring buddy too (the restore reads the drained copy,
    bit-identical), and repair rehydrates the drained shards into pmem
    (the next restore reads no external copy). Launches are counted on
    each leg: the saves, the restore, the repair, the restores after the
    second and third losses and after the rehydration."""
    import torch
    from repro_torch.bridge import tree_leaves, tree_map
    from repro_torch.configs import ShapeConfig, registry
    from repro_torch.core.cluster import SimCluster
    from repro_torch.data.pipeline import StagedDataset
    from repro_torch.models import transformer as tfm
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    full = registry.get_config("gemma2-9b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    rt = tfm.ModelRuntime(tp=1, attn_impl="blockwise", remat=True,
                          max_seq=TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats(device)
    phase_peak = 0
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, rt, torch.Generator(device=device)
                             .manual_seed(SEED), device=device)
    adamw = opt.AdamWConfig(lr=1e-3, warmup=10, moments_dtype="int8")
    opt_state = opt.init_opt_state(params, adamw)
    sync()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    param_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_leaves(params))
    state_bytes = sum(t.numel() * t.element_size() for _, t in
                      tree_leaves({"params": params, "opt": opt_state}))
    f32_bytes = param_bytes + 8 * n_params + 4
    print(f"recovery {cfg.name}: n_layers {full.n_layers} -> {TRAIN_LAYERS}"
          f" at full width, {n_params} parameters; state {state_bytes} B "
          f"with int8 AdamW moments against {f32_bytes} B with float32 "
          f"moments ({state_bytes / f32_bytes} of it), made on the card in "
          f"{time.perf_counter() - t0:.3f}s [{card}]")
    phase_peak = max(phase_peak, peak_line(device, "recovery init"))
    step_fn = ts.make_train_step(cfg, rt, adamw, ce_chunk=128)
    # pmem: two slots of state and replica, repair's and rehydration's
    # copies and a slot's shadow (a state more), 1 GiB of slack; the
    # drains (three saves) go to the external store on disk
    need = 5 * state_bytes + (1 << 30)
    root = pool_root(need)
    ext_root = disk_root(3 * state_bytes + (1 << 30))
    print(f"recovery: pmem pools under {root} ({need} B allowed), the "
          f"external store under {ext_root}")
    cluster = SimCluster(root, n_nodes=TRAIN_NODES, pmem_capacity=need,
                         delta=True, wire_codec=True, device=device)
    cluster.external.root = ext_root
    ck, tiered = cluster.checkpointer, cluster.tiered
    steps, saves, acks_at, legs, ref, last = [], {}, [], {}, {}, {}
    first = {"params": params, "opt": opt_state}
    del params, opt_state
    leg = ["loop"]

    def recorded_step(p, o, batch):
        if p is None:
            p, o = first.pop("params"), first.pop("opt")
        t0 = time.perf_counter()
        p, o, m = step_fn(p, o, batch)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        step = len(steps) + 1
        peak = peak_line(device, f"recovery step {step}")
        steps.append(dict(step=step, seconds=dt, loss=loss, peak=peak))
        print(f"recovery step {step}: step_s={dt} loss={loss} "
              f"max_memory_allocated={peak} [{card}]")
        if step == 4:  # what the step-4 save holds, for the restore check
            ref[4] = tree_map(torch.clone, {"params": p, "opt": o})
        last.update(params=p, opt=o)
        return p, o, m

    save_async, record_ack = tiered.save_async, ck.record_ack
    restore_latest, repair = ck.restore_latest_recoverable, tiered.repair

    def recorded_save(step, tree, **kw):
        rec = saves[step] = dict(t0=time.perf_counter(),
                                 base=kw.get("base_step"))
        ticket = save_async(step, tree, **kw)
        ticket.device_done.add_done_callback(
            lambda f: rec.update(device_s=time.perf_counter() - rec["t0"]))

        def committed(f):
            rec["commit_s"] = time.perf_counter() - rec["t0"]
            if f.exception() is None:
                man = f.result()
                rec["bytes"] = sum(
                    cluster.stores[n].manifest(f"ckpt/slot{man['slot']}")
                    ["nbytes"] for n in man["nodes"])
        ticket.future.add_done_callback(committed)
        rec["ticket"] = ticket
        return ticket

    def timed_ack(step, nid, kind, info=None):
        record_ack(step, nid, kind, info)
        acks_at.append((step, nid, kind, time.perf_counter(), leg[0]))

    def fault_restore(**kw):
        last.clear()  # the loop dropped the live state for the restore
        c0 = read_launches()
        t0 = time.perf_counter()
        out = restore_latest(**kw)
        sync()
        legs["restore"] = dict(
            seconds=time.perf_counter() - t0, step=out[1]["step"],
            launches=diff_launches(read_launches(), c0),
            stats=dict(ck.last_restore_stats), lost=kw["lost_nodes"])
        legs["restore"]["worst"] = check_restore_bound(
            ck, out[1], out[0], ref.pop(4), kw["lost_nodes"])
        return out

    def fault_repair(lost, **kw):
        leg[0] = "repair"
        c0 = read_launches()
        t0 = time.perf_counter()
        report = repair(lost, **kw)
        legs["repair"] = dict(seconds=time.perf_counter() - t0,
                              launches=diff_launches(read_launches(), c0),
                              report=report, lost=list(lost),
                              steps=ck.available_steps())
        leg[0] = "loop"
        for st in ck.available_steps():
            for nid, holders in ckpt_copies(ck, st, lost).items():
                check(len(holders) >= 2, f"after repair step {st}'s shard "
                      f"of {nid} has live copies {sorted(holders)}")
        return report

    try:
        data = StagedDataset(cluster, cfg, ShapeConfig(
            "train", TRAIN_SEQ, TRAIN_BATCH, "train"), n_shards=4,
            seqs_per_shard=16)
        tiered.save_async, ck.record_ack = recorded_save, timed_ack
        ck.restore_latest_recoverable, tiered.repair = \
            fault_restore, fault_repair
        lc = train_loop.LoopConfig(steps=RECOVERY_STEPS,
                                   ckpt_every=TRAIN_CKPT_EVERY,
                                   delta_ckpt=True, drain_every=1)
        reset_launches()
        t0 = time.perf_counter()
        state = train_loop.run(recorded_step, None, None,
                               data.batches(RECOVERY_STEPS), cluster, lc,
                               fault_at=RECOVERY_FAULT_AT)
        loop_s = time.perf_counter() - t0
        loop_launches = read_launches()
        tiered.save_async, ck.record_ack = save_async, record_ack
        ck.restore_latest_recoverable, tiered.repair = restore_latest, repair
        phase_peak = max([phase_peak] + [s["peak"] for s in steps])
        check(state.step == RECOVERY_STEPS and
              all(np.isfinite(state.losses)),
              f"loop ended at step {state.step}, losses {state.losses}")
        check(state.recovered_at == [RECOVERY_FAULT_AT],
              f"recovered_at {state.recovered_at}, want "
              f"[{RECOVERY_FAULT_AT}]")
        check({st: saves[st]["base"] for st in saves} ==
              {2: None, 4: 2, 6: 2},
              f"saves {sorted(saves)}: want a full save at 2 and deltas "
              f"at 4 and 6 against it")
        r = legs["restore"]
        check(r["step"] == 4 and r["stats"] == {"skipped_by_ack": 0,
                                                "probed": 1},
              f"the fault restored step {r['step']} ({r['stats']}), want "
              f"step 4 on its acks alone")
        report = legs["repair"]["report"]
        check(not report["errors"] and report["unrepairable"] == 0 and
              report["checkpoint"] > 0,
              f"repair after the loss: {report}")
        check(state.final_ckpt_durability == "DRAINED",
              f"final durability {state.final_ckpt_durability}, want "
              f"DRAINED")
        saved = {k: loop_launches[k] - r["launches"][k] -
                 legs["repair"]["launches"][k] for k in r["launches"]}
        legs["save"] = dict(launches=saved)
        check(saved["encode_tiles"] > 0 and r["launches"]["decode_tiles"] > 0,
              f"codec launches: saves {saved}, restore {r['launches']}")
        print(f"recovery loop: {RECOVERY_STEPS} steps in {loop_s} s with "
              f"the loss after step {RECOVERY_FAULT_AT} (its end joins the "
              f"replicas and drains); losses {state.losses}; ckpt_seconds "
              f"{state.ckpt_seconds}; recovered_at {state.recovered_at}; "
              f"final durability {state.final_ckpt_durability} [{card}]")
        for st in sorted(saves):
            rec = saves[st]
            rep = sorted(t - rec["t0"] for s_, _n, k, t, lg in acks_at
                         if s_ == st and k == "replica" and lg == "loop")
            drn = sorted(t - rec["t0"] for s_, _n, k, t, lg in acks_at
                         if s_ == st and k == "drain")
            kind = "full" if rec["base"] is None else \
                f"delta vs step {rec['base']}"
            print(f"recovery save step {st} ({kind}): device phase "
                  f"{rec['device_s']} s, committed {rec['commit_s']} s, "
                  f"{rec['bytes']} B on pmem; replicas acked at {rep} s, "
                  f"drains acked at {drn} s from submit [{card}]")
        ext_bytes = sum(f.stat().st_size for f in ext_root.iterdir())
        print(f"recovery restore after {r['lost']}'s loss: step {r['step']}"
              f" in {r['seconds']} s, last_restore_stats {r['stats']}, "
              f"every element within its tile's scale/2 (worst {r['worst']}"
              f" of the bound; int leaves before the cast); launches "
              f"{r['launches']} [{card}]")
        rp = legs["repair"]
        print(f"recovery repair: {rp['seconds']} s, launches "
              f"{rp['launches']}, report "
              f"{ {k: v for k, v in report.items() if k != 'repaired'} }; "
              f"copies {report['repaired']}; every acked shard of steps "
              f"{rp['steps']} on >= 2 live copies [{card}]")
        print(f"recovery saves: launches {saved}; drains hold {ext_bytes} B "
              f"on disk")
        # the plane's record, before a second loss can take the home ring
        rings = check_save_traces(cluster, ck, sorted(saves),
                                  [cluster.node_ids[-1]])
        spans = span_means(cluster.obs.registry,
                           ("ckpt.save", "ckpt.replicate", "ckpt.drain",
                            "sched.replicate", "sched.drain",
                            "repair.sweep"))
        print(f"recovery telemetry: {rings}; every "
              f"save one connected ckpt.save trace, its id in the manifest "
              f"and the ack records; span means {spans} [{card}]")

        # a second loss: a new buddy that repair chose
        victim = cluster.node_ids[-1]
        second = next(rec[3] for rec in report["repaired"]
                      if rec[0] == "checkpoint" and
                      rec[1].endswith("/" + victim))
        cluster.kill_node(second)
        lost = [victim, second]
        final = {"params": last.pop("params"), "opt": last.pop("opt")}
        c0 = read_launches()
        t0 = time.perf_counter()
        got, man = ck.restore_latest_recoverable(lost_nodes=lost)
        sync()
        legs["second"] = dict(seconds=time.perf_counter() - t0,
                              launches=diff_launches(read_launches(), c0),
                              stats=dict(ck.last_restore_stats))
        check(man["step"] == RECOVERY_STEPS and
              legs["second"]["stats"] == {"skipped_by_ack": 0, "probed": 1},
              f"after losing {lost}: step {man['step']}, "
              f"{legs['second']['stats']}")
        legs["second"]["worst"] = check_restore_bound(ck, man, got, final,
                                                      lost)
        digests = state_digests(got)
        del got, final
        phase_peak = max(phase_peak, peak_line(device, "second restore"))
        print(f"recovery after also losing {second} (a buddy repair "
              f"chose): step {man['step']} restored in "
              f"{legs['second']['seconds']} s, {legs['second']['stats']}, "
              f"within the bound of the final state (worst "
              f"{legs['second']['worst']}); launches "
              f"{legs['second']['launches']} [{card}]")

        # two adjacent nodes lost: a home and its buddy -> the drain tier
        buddy = ck.buddy_of(second, man["nodes"])
        check(buddy not in lost, f"{second}'s buddy {buddy} already lost")
        cluster.kill_node(buddy)
        lost.append(buddy)
        ext_get, ext_reads = cluster.external.get, []
        cluster.external.get = \
            lambda name: (ext_reads.append(name), ext_get(name))[1]
        c0 = read_launches()
        t0 = time.perf_counter()
        got, man = ck.restore_latest_recoverable(lost_nodes=lost)
        sync()
        legs["drain"] = dict(seconds=time.perf_counter() - t0,
                             launches=diff_launches(read_launches(), c0),
                             stats=dict(ck.last_restore_stats),
                             external=list(ext_reads))
        check(man["step"] == RECOVERY_STEPS and ext_reads and
              state_digests(got) == digests,
              f"after losing {lost}: step {man['step']}, external reads "
              f"{ext_reads}: want the newest step read from the drain, "
              f"bit-identical to the restore from the replicas")
        del got
        print(f"recovery after losing {lost} (a home and its buddy): step "
              f"{man['step']} restored from the drained copies {ext_reads} "
              f"in {legs['drain']['seconds']} s, bit-identical to the "
              f"replica restore; launches {legs['drain']['launches']} "
              f"[{card}]")
        ext_reads.clear()
        c0 = read_launches()
        t0 = time.perf_counter()
        rehyd = cluster.repair(lost)
        legs["rehydrate"] = dict(seconds=time.perf_counter() - t0,
                                 launches=diff_launches(read_launches(), c0),
                                 report=rehyd, external=list(ext_reads))
        check(rehyd["rehydrated"] > 0 and not rehyd["errors"],
              f"repair after losing {lost}: {rehyd}")
        ext_reads.clear()
        c0 = read_launches()
        t0 = time.perf_counter()
        got, man = ck.restore_latest_recoverable(lost_nodes=lost)
        sync()
        legs["rehydrated"] = dict(seconds=time.perf_counter() - t0,
                                  launches=diff_launches(read_launches(),
                                                         c0),
                                  stats=dict(ck.last_restore_stats))
        check(man["step"] == RECOVERY_STEPS and not ext_reads and
              state_digests(got) == digests,
              f"after rehydration: step {man['step']}, external reads "
              f"{ext_reads}: want the newest step from pmem alone")
        del got
        cluster.external.get = ext_get
        rh = legs["rehydrate"]
        print(f"recovery rehydration: {rh['seconds']} s, staged "
              f"{rh['external']}, report "
              f"{ {k: v for k, v in rehyd.items() if k != 'repaired'} }; "
              f"launches {rh['launches']}; the next restore read pmem "
              f"alone in {legs['rehydrated']['seconds']} s, bit-identical; "
              f"launches {legs['rehydrated']['launches']} [{card}]")
        rehydrate_leg = {k: rh["launches"][k] +
                         legs["rehydrated"]["launches"][k]
                         for k in rh["launches"]}
        check(rehydrate_leg["decode_tiles"] > 0,
              f"the rehydrate leg launched no decode_tiles: {rehydrate_leg}")
        legs["rehydrate_leg"] = dict(launches=rehydrate_leg)
        phase_peak = max(phase_peak, peak_line(device, "recovery restores"))
        print(f"recovery: launches by leg "
              f"{ {k: v['launches'] for k, v in legs.items()} }; peak "
              f"device memory {phase_peak} B [{card}]")
    finally:
        tiered.save_async, ck.record_ack = save_async, record_ack
        ck.restore_latest_recoverable, tiered.repair = restore_latest, repair
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(ext_root, ignore_errors=True)
        last.clear()
        ref.clear()
        first.clear()
        release()
    return dict(legs=legs, steps=steps, losses=state.losses, spans=spans,
                ckpt_seconds=state.ckpt_seconds, state_bytes=state_bytes,
                f32_state_bytes=f32_bytes, peak=phase_peak,
                saves={st: {k: v for k, v in rec.items() if k != "ticket"}
                       for st, rec in saves.items()})


def audit_store_reads(cluster) -> list:
    """Wrap every store's object-data entry points (``get_with_manifest``,
    ``exists``, ``get_leaf``) to record the (node, object) each touches,
    as the serve example's audit does; pool JSON reads are not probes."""
    reads = []
    for nid, st in cluster.stores.items():
        for meth in ("get_with_manifest", "exists", "get_leaf"):
            orig = getattr(st, meth)

            def wrapped(name, *a, _orig=orig, _nid=nid, **kw):
                reads.append((_nid, name))
                return _orig(name, *a, **kw)

            setattr(st, meth, wrapped)
    return reads


def hist_line(reg, name: str) -> dict:
    """A histogram's count, mean and p50/p99 from a registry."""
    h = reg.histogram(name)
    return {"count": h.count, "mean": h.sum / h.count if h.count else None,
            "p50": h.percentile(50), "p99": h.percentile(99)}


def ring_traces(cluster):
    """Every surviving flight ring of ``cluster`` replayed (events tagged
    with their node) and the span trees built from them."""
    from repro_torch.obs.recorder import FlightRecorder
    from repro_torch.obs.trace import build_traces
    events = []
    for nid, pool in cluster.pools.items():
        for ev in FlightRecorder.replay(pool):
            ev["node"] = nid
            events.append(ev)
    return events, build_traces(events)


def rooted_at(traces: dict, name: str) -> dict:
    """The traces whose roots include a span named ``name``."""
    return {tid: tr for tid, tr in traces.items()
            if tid and any(tr["spans"][r]["name"] == name
                           for r in tr["roots"])}


def span_means(reg, names) -> dict:
    """Each span's ``span.<name>.s`` histogram: count and mean seconds."""
    out = {}
    for n in names:
        h = reg.histogram(f"span.{n}.s")
        out[n] = {"count": h.count,
                  "mean_s": h.sum / h.count if h.count else None}
    return out


def timed_suspend(sm, user: str, out: dict) -> None:
    """``suspend(wait=False)``: the call's return, the record durable
    (the publish future), recorded into ``out`` in seconds."""
    t0 = time.perf_counter()
    fut = sm.suspend(user, wait=False)
    out["return_s"] = time.perf_counter() - t0
    rec = fut.result()
    out["durable_s"] = time.perf_counter() - t0
    out["t0"] = t0
    out["version"] = rec["version"]
    out["home"] = rec["home"]


def fleet_telemetry(cluster, root: Path, victim: str, owners: dict,
                    adopter) -> dict:
    """The fleet's post-crash diagnosis, after ``victim`` was killed and
    the adopter resumed and suspended every session: ``python -m
    repro_torch.obs.report <root>/pmem --json`` in a subprocess exits 0
    and its events hold one ``serve.session`` trace per user, each
    user's record carries that trace (``annotations["trace"]``), the
    spill and resume spans hang off a ``serve.session`` root in it, and
    the adopter's resume sits in the same trace; the text report (no
    clean shutdown yet) says no metrics snapshot was found."""
    import contextlib
    import io
    import os
    from repro_torch.obs import report
    from repro_torch.obs.trace import build_traces, connected_to_root
    pmem = root / "pmem"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(pmem),
         "--json"], capture_output=True, text=True, env=env, timeout=300)
    report_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"fleet: the report CLI exited "
                                f"{proc.returncode}: {proc.stderr[-2000:]}")
    dump = json.loads(proc.stdout)
    events = dump["events"]
    check(dump["snapshot"] is None, "fleet: a metrics snapshot before "
                                    "shutdown")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = report.main([str(pmem)])
    text = text.getvalue()
    check(rc == 0 and "no metrics snapshot found" in text and
          "last event per ring:" in text,
          f"fleet: the text report (rc {rc}) ends {text[-400:]!r}")
    traces = build_traces(events)
    sessions = rooted_at(traces, "serve.session")
    tids = {}
    for user, sm in owners.items():
        rec = cluster.catalog.record(f"sess/{user}", "serve")
        tid = rec["annotations"]["trace"]
        tids[user] = tid
        check(tid == sm._sessions[user].span.trace ==
              adopter._sessions[user].span.trace and tid in sessions,
              f"fleet: {user}'s record trace {tid} is not its session "
              f"trace")
        tr = sessions[tid]
        names = sorted(sp["name"] for sp in tr["spans"].values())
        check(names.count("serve.spill") >= 2 and
              names.count("serve.resume") == 1 and
              all(connected_to_root(tr, sid) for sid in tr["spans"]),
              f"fleet: {user}'s trace holds {names}")
        resume = next(sp for sp in tr["spans"].values()
                      if sp["name"] == "serve.resume")
        parent = tr["spans"].get(resume["parent"], {})
        check(parent.get("name") == "serve.session" and
              resume["parent"] == adopter._sessions[user].span.span,
              f"fleet: {user}'s resume hangs on {parent.get('name')}, not "
              f"the adopter's session span")
    check(sorted(sessions) == sorted(tids.values()),
          f"fleet: {len(sessions)} serve.session traces for "
          f"{sorted(owners)}")
    nodes = sorted({ev["node"] for ev in events})
    check(victim not in nodes, f"fleet: {victim}'s ring still replayed")
    return {"report_s": report_s, "events": len(events), "rings": nodes,
            "session_traces": len(sessions),
            "spans": span_means(cluster.obs.registry,
                                ("sched.replicate", "serve.spill",
                                 "serve.resume"))}


def fleet_phase(device, card: str):
    """examples/serve_longcontext.py on the card at gemma2-9b's full width
    (d_model 3584), its depth cut to FLEET_LAYERS: one parameter set
    shared by two workers' engines (labels workerA and workerB) and the
    reference engine, on a 3-node SimCluster with a DLM cache of
    FLEET_DLM_CAPACITY. A 5120-token system prompt (past the 4096
    window: the ring rolls) is prefilled once by worker A
    and published as ``prefix/system``; alice on A and bob on B fork from
    it and decode FLEET_GEN tokens each; both are suspended and their
    replicas acked; the home of ``sess/alice`` is killed; ``peek`` reads
    alice's cursor off the replica; worker B's manager resumes both
    (adopting alice from her record), decodes FLEET_GEN more and
    suspends them. Checks: ``recoverable_sessions`` before the kill is
    both users with zero object-store reads, the resumes make 0 blind
    probes, ``gc()`` reclaims the superseded versions and no leased one,
    every engine holds the same parameter storage, every flash launch
    takes wgmma, and each user's 2 * FLEET_GEN tokens equal an
    uninterrupted reference engine's. Then the codec leg
    (``fleet_codec_leg``)."""
    import torch
    from repro_torch.bridge import tree_leaves
    from repro_torch.core.cluster import SimCluster
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sessions import SessionManager

    cfg, rt, params = gemma2_9b(device, FLEET_LAYERS)
    check([s.mixer for s in cfg.pattern] == ["attn_local", "attn_global"]
          and cfg.groups == ((cfg.pattern, FLEET_LAYERS // 2),),
          "the fleet's cut model must alternate local and global layers")
    rt = dataclasses.replace(rt, max_seq=FLEET_PROMPT + 2 * FLEET_GEN + 8)
    rng = np.random.default_rng(SEED + 19)
    system = rng.integers(0, cfg.vocab_size,
                          (1, FLEET_PROMPT)).astype(np.int32)
    users = {u: int(rng.integers(0, cfg.vocab_size)) for u in FLEET_USERS}
    torch.cuda.reset_peak_memory_stats(device)
    eng_a = ServeEngine(cfg, rt, params, label="workerA", device=device)
    reset_launches()
    t0 = time.perf_counter()
    eng_a.prefill(system)
    sync()
    prefill_s = time.perf_counter() - t0
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_leaves(eng_a.cache))
    # the prefix and both sessions, up to 2 versions each, on their home
    # and one replica, and 1 GiB of slack
    need = 2 * 5 * state_bytes + (1 << 30)
    root = pool_root(need)
    out = {"state_bytes": state_bytes, "prefill_s": prefill_s,
           "suspends": {}, "resumes": {}}
    cluster = SimCluster(root, n_nodes=3, pmem_capacity=need,
                         dlm_capacity=FLEET_DLM_CAPACITY, device=device)
    try:
        eng_b = ServeEngine(cfg, rt, params, tiered=cluster.tiered,
                            label="workerB", device=device)
        ref = ServeEngine(cfg, rt, params, device=device)
        for other in (eng_b, ref):
            for (path, x), (_, y) in zip(tree_leaves(eng_a.params),
                                         tree_leaves(other.params)):
                check(x.data_ptr() == y.data_ptr(),
                      f"fleet: {path} is not shared between engines")
        sm_a = cluster.sessions
        sm_b = SessionManager(cluster.tiered, cluster.catalog,
                              owner="workerB", obs=cluster.obs)

        # 1. the shared prefix, published for the fleet
        t0 = time.perf_counter()
        rec = sm_a.publish_prefix("system", eng_a)
        out["publish_s"] = time.perf_counter() - t0  # returns when durable
        check(cluster.tiered.quiesce() == [], "fleet: publish errors")
        out["publish_acked_s"] = time.perf_counter() - t0
        out["prefix_home"] = rec["home"]

        # 2. one session a user, forked from the prefix, then 3. suspended
        toks, out["fork_s"] = {}, {}
        for (user, tok), (sm, eng) in zip(
                users.items(), ((sm_a, eng_a), (sm_b, eng_b))):
            t0 = time.perf_counter()
            sm.start(user, eng, prefix="system")
            sync()
            out["fork_s"][user] = time.perf_counter() - t0
            toks[user] = eng.decode(np.array([tok], np.int32), FLEET_GEN)
            out["suspends"][f"{user}@A"] = s = {}
            timed_suspend(sm, user, s)
        check(cluster.tiered.quiesce() == [], "fleet: suspend errors")
        t_acked = time.perf_counter()
        for key, s in out["suspends"].items():
            s["acked_s"] = t_acked - s["t0"]
        victim = cluster.catalog.record("sess/alice", "serve")["home"]
        reads = audit_store_reads(cluster)
        survivors = sm_b.recoverable_sessions([victim])
        check(survivors == sorted(users) and reads == [],
              f"fleet: recoverable_sessions([{victim}]) = {survivors} with "
              f"store reads {reads}, want {sorted(users)} and none")
        cluster.kill_node(victim)

        # the cursor, one leaf read off the acked replica
        t0 = time.perf_counter()
        pos = int(sm_b.peek("alice", "pos"))
        out["peek_s"] = time.perf_counter() - t0
        check(pos == FLEET_PROMPT + FLEET_GEN, f"fleet: peek pos {pos}")

        # 4. worker B resumes both, decodes on and suspends them
        del reads[:]
        for user in users:
            r = cluster.catalog.record(f"sess/{user}", "serve")
            key = f"exch/serve/sess/{user}@v{r['version']}"
            cluster.catalog.cache.drop(key)  # read pmem, as the example
            rr = cluster.catalog.stats["replica_reads"]
            t0 = time.perf_counter()
            sm_b.resume(user, eng_b)
            sync()
            source = "replica" if cluster.catalog.stats["replica_reads"] > \
                rr else ("home " + r["home"])
            out["resumes"][user] = {"s": time.perf_counter() - t0,
                                    "from": source}
            more = eng_b.decode(toks[user][:, -1], FLEET_GEN)
            toks[user] = np.concatenate([toks[user], more[:, 1:]], axis=1)
            out["suspends"][f"{user}@B"] = s = {}
            timed_suspend(sm_b, user, s)
        check(out["resumes"]["alice"]["from"] == "replica",
              f"fleet: alice resumed from {out['resumes']['alice']}")
        check(cluster.tiered.quiesce() == [], "fleet: suspend errors")
        t_acked = time.perf_counter()
        for key in ("alice@B", "bob@B"):
            out["suspends"][key]["acked_s"] = \
                t_acked - out["suspends"][key]["t0"]
        blind = [(n, o) for n, o in reads
                 if not o.endswith(".json") and n != victim
                 and not o.startswith(("replica/", "wf/serve/"))]
        check(blind == [], f"fleet: blind probes {blind}")
        out["audited_reads"] = len(reads)
        out["telemetry"] = fleet_telemetry(cluster, root, victim,
                                           {"alice": sm_a, "bob": sm_b},
                                           sm_b)
        out["launches"] = read_launches()
        out["routes"] = read_routes()
        check(out["launches"]["flash_attention"] == cfg.n_layers,
              f"fleet: flash launched {out['launches']['flash_attention']} "
              f"times, want {cfg.n_layers} (the one prefix prefill)")
        check_wgmma("fleet prefix prefill", out["launches"], out["routes"])
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)

        # 5. gc: worker A's manager lets go of its cold session (lease
        # release), then the superseded versions go and no leased one
        sm_a.evict_cold(0.0)
        leased = {(l.workflow, l.name, l.version)
                  for l in list(sm_a.catalog._leases.values())}
        t0 = time.perf_counter()
        reclaimed = cluster.catalog.gc()
        out["gc_s"] = time.perf_counter() - t0
        want_gc = {("serve", f"sess/{u}", 1) for u in users}
        check(set(reclaimed) == want_gc and not (set(reclaimed) & leased),
              f"fleet: gc reclaimed {reclaimed}, want {sorted(want_gc)} "
              f"(leased {sorted(leased)})")
        out["gc"] = reclaimed
        # both managers keep their instruments in the cluster's plane
        out["resume_ms"] = hist_line(cluster.obs.registry, "serve.resume_ms")
        out["spill_to_ack_s"] = hist_line(cluster.obs.registry,
                                          "serve.spill_to_ack_s")
        out["dlm"] = {"used_bytes": cluster.dlm.used_bytes(),
                      "hits": cluster.dlm.hits,
                      "misses": cluster.dlm.misses,
                      "bypasses": cluster.dlm.bypasses,
                      "evictions": cluster.dlm.evictions}
        out["catalog"] = dict(cluster.catalog.stats)
        del eng_a, eng_b
    finally:
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)

    # the uninterrupted reference: the same prompt, 2 * FLEET_GEN tokens
    for user, tok in users.items():
        ref.prefill(system)
        full = ref.decode(np.array([tok], np.int32), 2 * FLEET_GEN)
        check(np.array_equal(full, toks[user]),
              f"fleet: {user}'s tokens {toks[user].tolist()} differ from "
              f"the uninterrupted reference's {full.tolist()}")
    del ref, params
    release()
    print(f"fleet gemma2-9b (full width, {cfg.n_layers} layers; 3-node "
          f"SimCluster, DLM capacity {FLEET_DLM_CAPACITY} B): system "
          f"prompt {FLEET_PROMPT} tokens, session state {state_bytes} B; "
          f"prefill_s={prefill_s}; prefix publish returned (durable) in "
          f"{out['publish_s']} s, replica acked at {out['publish_acked_s']}"
          f" s (home {out['prefix_home']}) [{card}]")
    for key, s in out["suspends"].items():
        print(f"fleet suspend {key}: v{s['version']} home {s['home']}: "
              f"call returned in {s['return_s']} s, record durable at "
              f"{s['durable_s']} s, replica acked at {s['acked_s']} s "
              f"[{card}]")
    print(f"fleet: fork_s={out['fork_s']}; killed {victim}; peek pos "
          f"{pos} in {out['peek_s']} s; resumes "
          f"{ {u: (r['s'], r['from']) for u, r in out['resumes'].items()} }"
          f"; {out['audited_reads']} audited reads, 0 blind probes; "
          f"recoverable_sessions({victim}) = {survivors} with 0 store "
          f"reads [{card}]")
    print(f"fleet: serve.resume_ms {out['resume_ms']}; "
          f"serve.spill_to_ack_s {out['spill_to_ack_s']}")
    print(f"fleet telemetry: `python -m repro_torch.obs.report --json` "
          f"over the surviving rings in {out['telemetry']['report_s']} s: "
          f"{out['telemetry']['events']} events on "
          f"{out['telemetry']['rings']}, one serve.session trace per user "
          f"({out['telemetry']['session_traces']}), each in its record "
          f"and continued by workerB's resume; no metrics snapshot before "
          f"shutdown; span means {out['telemetry']['spans']} [{card}]")
    print(f"fleet: dlm {out['dlm']}; catalog.stats {out['catalog']}; gc "
          f"reclaimed {out['gc']} in {out['gc_s']} s")
    print(f"fleet: flash launches {out['launches']['flash_attention']} by "
          f"route {out['routes']['flash_attention']}; "
          f"max_memory_allocated={out['peak_bytes']}; every engine shares "
          f"the parameter storage; tokens of "
          f"{', '.join(users)} ({2 * FLEET_GEN} each) equal the "
          f"uninterrupted reference's [{card}]")
    out["codec"] = fleet_codec_leg(device, card)
    return out


def fleet_codec_leg(device, card: str):
    """The fleet's codec leg: mamba2-1.3b at full width on a 3-node
    SimCluster with the strict wire codec. One session is prefilled
    (FLEET_CODEC_PROMPT tokens, 48 ssd launches), started and suspended
    (the replica's strict round trip runs decode_tiles on the card), and
    its home killed; the manager's ``peek`` of a float32 leaf off the
    codec replica equals the suspended state bit for bit, and a second
    manager resumes the session bit-identical, decoding the tokens the
    first engine decoded from the same state."""
    import torch
    from repro_torch.bridge import to_numpy, tree_leaves
    from repro_torch.core.cluster import SimCluster
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sessions import SessionManager

    cfg, rt, params = recurrent_model(device, CODEC_ARCH, FLEET_CODEC_PROMPT)
    prompt = np.random.default_rng(SEED + 19).integers(
        0, cfg.vocab_size, (1, FLEET_CODEC_PROMPT)).astype(np.int32)
    out = {}
    eng = ServeEngine(cfg, rt, params, label="codecA", device=device)
    reset_launches()
    t0 = time.perf_counter()
    first = eng.prefill(prompt)
    out["prefill_s"] = time.perf_counter() - t0
    prefill = read_launches()
    check(prefill["ssd"] == cfg.n_layers,
          f"fleet codec: ssd launched {prefill['ssd']} times in a prefill, "
          f"want {cfg.n_layers}")
    toks = eng.decode(first, EXTRA)
    state = eng.export_state()
    direct = eng.decode(toks[:, -1], EXTRA)
    eng.install_state(state)
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in tree_leaves(state["cache"]))
    leaf, want = next((p, t) for p, t in tree_leaves(state["cache"])
                      if t.dtype == torch.float32)
    root = pool_root(6 * nbytes + (1 << 30))
    cluster = SimCluster(root, n_nodes=3, wire_codec=True, device=device)
    try:
        reset_launches()
        cluster.sessions.start("mamba", eng)
        t0 = time.perf_counter()
        cluster.sessions.suspend("mamba")
        out["suspend_s"] = time.perf_counter() - t0
        check(cluster.tiered.quiesce() == [], "fleet codec: errors")
        out["acked_s"] = time.perf_counter() - t0
        rec = cluster.catalog.record("sess/mamba", "serve")
        cluster.kill_node(rec["home"])
        t0 = time.perf_counter()
        got = cluster.sessions.peek("mamba", "cache/" + leaf)
        out["peek_s"] = time.perf_counter() - t0
        check(to_numpy(got).tobytes() == to_numpy(want).tobytes(),
              f"fleet codec: peek of {leaf} off the codec replica differs "
              f"from the suspended state")
        sm2 = SessionManager(cluster.tiered, cluster.catalog,
                             owner="codecB", obs=cluster.obs)
        eng2 = ServeEngine(cfg, rt, params, tiered=cluster.tiered,
                           label="codecB", device=device)
        t0 = time.perf_counter()
        sm2.resume("mamba", eng2)
        sync()
        out["resume_s"] = time.perf_counter() - t0
        check(state_bits_equal(eng2.export_state(), state),
              "fleet codec: the resumed state differs from the suspended")
        again = eng2.decode(toks[:, -1], EXTRA)
        check(np.array_equal(again, direct), f"fleet codec: tokens "
              f"{again} after the resume, want {direct}")
        out["launches"] = read_launches()
        out["launches"]["ssd_prefill"] = prefill["ssd"]
        check(out["launches"]["decode_tiles"] > 0,
              "fleet codec: decode_tiles never launched")
        out["replica_reads"] = cluster.catalog.stats["replica_reads"]
        del eng, eng2
    finally:
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    del params
    release()
    print(f"fleet codec {cfg.name} (full width, 3-node SimCluster, strict "
          f"wire codec): prompt {FLEET_CODEC_PROMPT}, state {nbytes} B, "
          f"prefill_s={out['prefill_s']} (ssd launches {prefill['ssd']}); "
          f"suspend_s={out['suspend_s']} acked_s={out['acked_s']}; home "
          f"{rec['home']} killed; peek {leaf} off the codec replica in "
          f"{out['peek_s']} s, bit-identical; second manager's resume_s="
          f"{out['resume_s']}, state bit-identical, tokens identical; "
          f"launches from the session's start {out['launches']}; "
          f"replica_reads={out['replica_reads']} [{card}]")
    return out


def workflow_phase(device, card: str):
    """examples/torch_workflow_pipeline.py's Fig. 8 pipeline on the card
    (its ``make_jobs``), at gemma2-9b's full width cut to TRAIN_LAYERS
    layers, batch TRAIN_BATCH x TRAIN_SEQ, TRAIN_STEPS steps, on a 4-node
    SimCluster: prep -> {train, stats} -> eval, train running on a
    scheduler worker thread (its device work waited on through the
    watchdog), its parameters published as the ``model`` dataset. Checks:
    the event log has stage_in, in_situ, retain and drain; train and
    stats overlap in time; eval_report's lineage reaches
    external:raw_corpus; after the home of ``model`` is killed,
    ``resume`` replays nothing; ``catalog.get("model")`` then reads the
    replica and its bytes equal the trained parameters; the losses are
    finite. Last, one SLMTier round trip of the trained embedding leaf,
    bit-identical."""
    import importlib.util
    import math
    import torch
    from repro_torch.bridge import to_numpy, tree_leaves
    from repro_torch.configs import ShapeConfig, registry
    from repro_torch.core.cluster import SimCluster
    from repro_torch.core.tiering import SLMTier
    from repro_torch.data.pipeline import synthetic_shard
    from repro_torch.models import transformer as tfm

    spec = importlib.util.spec_from_file_location(
        "torch_workflow_pipeline",
        ROOT / "examples" / "torch_workflow_pipeline.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)

    full = registry.get_config("gemma2-9b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    rt = tfm.ModelRuntime(tp=1, attn_impl="blockwise", remat=True,
                          max_seq=TRAIN_SEQ)
    shape = ShapeConfig("wf", TRAIN_SEQ, TRAIN_BATCH, "train")
    # the model's bf16 bytes from the analytic count (untied embeddings)
    model_bytes = 2 * cfg.param_count()
    need = 4 * model_bytes + (2 << 30)
    root = pool_root(need)
    out = {"model_bytes": model_bytes}
    torch.cuda.reset_peak_memory_stats(device)
    cluster = SimCluster(root, n_nodes=4, pmem_capacity=need, device=device)
    try:
        cluster.external.put("raw_corpus", synthetic_shard(
            SEED, 16, TRAIN_SEQ, cfg.vocab_size))
        res = {}
        jobs = example.make_jobs(cfg, rt, shape, device, steps=TRAIN_STEPS,
                                 ce_chunk=128, out=res)
        # when each dataset's publish returned and its replica was acked
        pub = out["publish"] = {}
        publish = cluster.catalog.publish

        def timed_publish(name, tree, **kw):
            t0 = time.perf_counter()
            p = pub[name] = {}

            def acked():
                p["acked_s"] = time.perf_counter() - t0
            rec = publish(name, tree, on_replica=acked, **kw)
            p["durable_s"] = time.perf_counter() - t0
            p["nbytes"] = rec["nbytes"]
            return rec
        cluster.catalog.publish = timed_publish
        t0 = time.perf_counter()
        cluster.workflows.run(jobs, workflow="pipeline")
        out["run_s"] = time.perf_counter() - t0
        check(cluster.tiered.quiesce() == [], "workflow: in-flight errors")
        kinds = {k for _, k, _ in cluster.workflows.events}
        check({"stage_in", "in_situ", "retain", "drain"} <= kinds,
              f"workflow: events {sorted(kinds)}")
        spans = res["spans"]
        out["jobs_s"] = {n: b - a for n, (a, b) in spans.items()}
        (a0, a1), (b0, b1) = spans["train"], spans["stats"]
        check(max(a0, b0) < min(a1, b1),
              f"workflow: train {spans['train']} and stats "
              f"{spans['stats']} never overlapped")
        # the plane: every job of the run in one wf.job trace
        _, traces = ring_traces(cluster)
        wf = {tid: sorted(sp["attrs"].get("job") for sp in tr["spans"]
                          .values() if sp["name"] == "wf.job")
              for tid, tr in traces.items() if tid and any(
                  sp["name"] == "wf.job" for sp in tr["spans"].values())}
        check(list(wf.values()) == [sorted(spans)],
              f"workflow: wf.job spans by trace {wf}, want one trace with "
              f"{sorted(spans)}")
        out["wf_trace"] = {"jobs": sorted(spans), "spans": span_means(
            cluster.obs.registry, ("wf.job", "stage.stage_in",
                                   "sched.stage_in", "exch.prefetch"))}
        chain = cluster.catalog.lineage("eval_report", "pipeline")
        check({"external": "raw_corpus"} in chain,
              f"workflow: eval_report's lineage {chain}")
        losses = res["losses"]
        check(all(math.isfinite(x) for x in losses) and
              math.isfinite(res["eval_loss"]),
              f"workflow: losses {losses} eval {res['eval_loss']}")
        out["losses"], out["eval_loss"] = losses, res["eval_loss"]
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)

        victim = cluster.catalog.record("model", "pipeline")["home"]
        cluster.kill_node(victim)
        t0 = time.perf_counter()
        res2 = cluster.workflows.resume(jobs, "pipeline",
                                        lost_nodes=[victim])
        out["resume_s"] = time.perf_counter() - t0
        check(res2.replayed == [],
              f"workflow: resume replayed {res2.replayed}")
        rep = res2.repair_report
        out["resume"] = {"skipped": sorted(res2.skipped),
                         "replayed": res2.replayed,
                         "repair": {k: rep.get(k) for k in
                                    ("dataset", "dlm", "checkpoint",
                                     "healthy", "skipped")},
                         "errors": len(rep.get("errors", ()))}
        check(out["resume"]["errors"] == 0, f"workflow: repair {rep}")
        cluster.tiered.evict_cold(0.0)
        rr = cluster.catalog.stats["replica_reads"]
        t0 = time.perf_counter()
        got = cluster.catalog.get("model", "pipeline")
        out["replica_get_s"] = time.perf_counter() - t0
        out["replica_reads"] = cluster.catalog.stats["replica_reads"] - rr
        check(out["replica_reads"] >= 1, "workflow: model not read off a "
                                         "replica")
        trained = dict(tree_leaves(res["params"]))
        gl = dict(tree_leaves(got))
        check(sorted(gl) == sorted(trained) and all(
            to_numpy(gl[p]).tobytes() == to_numpy(trained[p]).tobytes()
            for p in trained), "workflow: the replica's model differs from "
                               "the trained parameters")
        del got, gl

        # one SLM round trip of the trained embedding leaf
        emb_path = "in_embed"
        emb = trained[emb_path]
        check(tuple(emb.shape) == (cfg.vocab_size, cfg.d_model) and
              emb.dtype == torch.bfloat16,
              f"workflow: embedding leaf {tuple(emb.shape)} {emb.dtype}")
        live = next(n for n in cluster.node_ids if n != victim)
        tier = SLMTier(cluster.stores[live], "embed")
        t0 = time.perf_counter()
        resident, handle = tier.offload({emb_path: emb}, [emb_path])
        out["slm_offload_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = tier.fetch(resident, handle)[emb_path]
        out["slm_fetch_s"] = time.perf_counter() - t0
        check(to_numpy(back).tobytes() == to_numpy(emb).tobytes(),
              "workflow: SLM fetch of the embedding differs")
        out["slm_bytes"] = emb.numel() * emb.element_size()
        del trained, emb, back, res
    finally:
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    release()
    m = out["publish"]["model"]
    print(f"workflow gemma2-9b (full width, {TRAIN_LAYERS} layers; batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps; 4-node "
          f"SimCluster): run_s={out['run_s']} jobs_s={out['jobs_s']}; "
          f"losses {out['losses']} eval {out['eval_loss']}; "
          f"max_memory_allocated={out['peak_bytes']} [{card}]")
    print(f"workflow telemetry: the jobs {out['wf_trace']['jobs']} in one "
          f"wf.job trace; span means {out['wf_trace']['spans']} [{card}]")
    print(f"workflow: model dataset {m['nbytes']} B: publish durable at "
          f"{m['durable_s']} s, replica acked at {m.get('acked_s')} s; "
          f"train and stats overlapped; lineage reaches "
          f"external:raw_corpus [{card}]")
    print(f"workflow: after killing {victim}: resume_s={out['resume_s']} "
          f"{out['resume']}; catalog.get(model) off the replica in "
          f"{out['replica_get_s']} s ({out['replica_reads']} replica reads),"
          f" bytes equal to the trained parameters [{card}]")
    print(f"workflow: SLMTier round trip of the embedding "
          f"({out['slm_bytes']} B bf16): offload_s={out['slm_offload_s']} "
          f"fetch_s={out['slm_fetch_s']}, bit-identical [{card}]")
    return out


def telemetry_phase(device, card: str, spans: dict):
    """The plane's cost on the save path, the torch counterpart of
    benchmarks/bench_obs.py: a 2-node SimCluster on the card runs
    ``tiered.save_async(step, state, drain=True)`` for each step of a run,
    joined, with ``telemetry=False`` (registry only) and ``True`` (pmem
    rings, spans) alternating, TELEMETRY_REPS runs each, for each state
    of TELEMETRY_STATES (JAX's 8 MiB float32 and a 512 MiB bf16 tensor,
    both on the card). Prints each leg's median s/step, the overhead and
    the rings' committed events and drops; the overhead is printed, not
    gated (host clocks vary run to run). Then the span means the earlier
    phases recorded: the first per-layer split of the host path."""
    import statistics
    import torch
    from repro_torch.core.cluster import SimCluster

    out = {}
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    for tag, (shape, dtype, steps) in TELEMETRY_STATES.items():
        state = {"w": torch.randn(shape, generator=gen, device=device,
                                  dtype=getattr(torch, dtype))}
        nbytes = state["w"].numel() * state["w"].element_size()
        need = 2 * (steps + 4) * nbytes + (1 << 30)
        legs = {False: [], True: []}
        rings = None
        for _ in range(TELEMETRY_REPS):
            for on in (False, True):
                root = pool_root(need)
                c = SimCluster(root, n_nodes=2, pmem_capacity=need,
                               telemetry=on, device=device)
                try:
                    sync()
                    t0 = time.perf_counter()
                    for step in range(1, steps + 1):
                        c.tiered.save_async(step, state, drain=True)
                    # a strict barrier: a replicate superseded by a
                    # newer save of its slot is benign, any other error
                    # raises
                    c.tiered.join()
                    c.checkpointer.wait_async()
                    legs[on].append((time.perf_counter() - t0) / steps)
                    check(c.tiered.stats["saves"] == steps,
                          f"telemetry {tag}: {c.tiered.stats}")
                    if on:
                        rings = c.obs.snapshot()["recorder"]
                        _, traces = ring_traces(c)
                        check(len(rooted_at(traces, "ckpt.save")) ==
                              steps, f"telemetry {tag}: "
                              f"{len(rooted_at(traces, 'ckpt.save'))} "
                              f"ckpt.save traces")
                    else:
                        check(not c.obs.recorders,
                              f"telemetry {tag}: rings with the plane off")
                finally:
                    c.shutdown()
                    shutil.rmtree(root, ignore_errors=True)
        off, on = statistics.median(legs[False]), statistics.median(legs[True])
        out[tag] = {"bytes": nbytes, "saves": steps, "off_s": off,
                    "on_s": on,
                    "overhead": (on - off) / off, "runs_off": legs[False],
                    "runs_on": legs[True],
                    "committed": sum(r["committed"] for r in rings.values()),
                    "drops": sum(r["drops"] for r in rings.values())}
        r = out[tag]
        print(f"telemetry {tag} ({nbytes} B on the card, 2 nodes, "
              f"{steps} x save_async(drain=True) joined, "
              f"{TELEMETRY_REPS} runs a leg): off {off} s/step, on {on} "
              f"s/step, overhead {r['overhead'] * 100:+.2f}% (JAX's budget "
              f"5%, not gated); runs off {legs[False]} on {legs[True]}; "
              f"ring events committed {r['committed']}, drops {r['drops']} "
              f"[{card}]")
        del state
        release()
    print(f"telemetry span means (span.<name>.s, host clock): {spans} "
          f"[{card}]")
    out["spans"] = spans
    return out


def elastic_phase(device, card: str, ref_save_s: float):
    """gemma2-9b at full width (the train phase's 2 layers, batch and
    sequence) through ``repro_torch.launch.elastic.run`` with
    ELASTIC_MOMENTS AdamW moments: 4 steps on 4 nodes, a full save of
    parameters and AdamW state (to its replicas' acks), a second cluster
    over the same pools restores it (every leaf bit-identical to the
    saved state, by per-leaf digests), 4 more steps on a fresh 2-node
    cluster and a save of the parameters, the resumed loss below the
    first. The whole phase, the clusters' shutdowns included, runs under
    the port's ``PMemSanitizer`` (installed before the first cluster,
    removed after the last shutdown) and must end with no violation.
    ``ref_save_s``, the recovery phase's full ``save_async`` of the same
    state to its commit, is printed beside the sanitized save."""
    import os
    import torch
    from repro_torch.analysis import PMemSanitizer
    from repro_torch.bridge import tree_leaves
    from repro_torch.configs import ShapeConfig, registry
    from repro_torch.launch import elastic
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt

    full = registry.get_config("gemma2-9b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    shape = ShapeConfig("elastic", TRAIN_SEQ, TRAIN_BATCH, "train")
    rt = elastic._runtime(cfg, shape)
    check(rt.attn_impl == "blockwise" and rt.remat,
          f"elastic runtime {rt.attn_impl} remat={rt.remat}")
    # held in a dict and popped into the call: run() drops the live state
    # after its save, which a reference here would keep on the card
    first = {"params": tfm.init_params(cfg, rt, torch.Generator(
        device=device).manual_seed(SEED), device=device)}
    n_params = sum(t.numel() for _, t in tree_leaves(first["params"]))
    params_bytes = sum(t.numel() * t.element_size()
                       for _, t in tree_leaves(first["params"]))
    # bf16 parameters and the AdamW state run() makes for them (int8 m
    # and v with their float32 block scales, the int32 step)
    moments = opt.init_opt_state(first["params"], opt.AdamWConfig(
        moments_dtype=ELASTIC_MOMENTS))
    state_bytes = params_bytes + sum(t.numel() * t.element_size()
                                     for _, t in tree_leaves(moments))
    del moments
    release()
    torch.cuda.reset_peak_memory_stats(device)
    # phase 1 holds the state and its buddy replicas, phase 2 the
    # parameters and theirs; no pool holds more than the whole state
    need = 2 * state_bytes + 2 * params_bytes + (1 << 30)
    root = pool_root(need)
    print(f"elastic {cfg.name}: n_layers {full.n_layers} -> {TRAIN_LAYERS} "
          f"(d_model={cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv "
          f"heads of {cfg.resolved_head_dim}, vocab {cfg.vocab_size}); "
          f"{n_params} parameters, state {state_bytes} B (bf16 "
          f"parameters, {ELASTIC_MOMENTS} AdamW moments); batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}; {ELASTIC_STEPS} steps on "
          f"{ELASTIC_NODES[0]} nodes, then {ELASTIC_STEPS} on "
          f"{ELASTIC_NODES[1]}; pools under {root}")
    digests = {}

    def on_state(kind, tree):
        sync()
        digests[kind] = state_digests(tree)
        if kind == "restored":
            bad = [p for p in digests["restored"]
                   if digests["restored"][p] != digests["saved"].get(p)]
            check(not bad and len(digests["restored"]) ==
                  len(digests["saved"]),
                  f"elastic restore differs from the saved state in "
                  f"{bad[:5]}")

    san = PMemSanitizer()
    try:
        reset_launches()
        t0 = time.perf_counter()
        san.install()
        try:
            out = elastic.run(cfg, shape, first.pop("params"), device,
                              root=root, steps=ELASTIC_STEPS,
                              nodes_before=ELASTIC_NODES[0],
                              nodes_after=ELASTIC_NODES[1],
                              pmem_capacity=state_bytes,
                              moments_dtype=ELASTIC_MOMENTS,
                              check=on_state)
        finally:
            san.uninstall()
        phase_s = time.perf_counter() - t0
        launches = read_launches()
        # regions left dirty on a live pool are checked while the pools
        # still exist
        san.check_no_dirty_regions()
        stats = dict(san.stats)
        print(f"elastic sanitizer: {stats['writes']} writes, "
              f"{stats['flushes']} flushes, {stats['tail_advances']} tail "
              f"advances, {stats['closes']} closes over "
              f"{len(san.regions)} regions; {len(san.violations)} "
              f"violations [{card}]")
        for v in san.violations[:10]:
            print(f"  violation: {v}")
        check(not san.violations, f"{len(san.violations)} persistence-"
                                  f"order violations in the elastic phase")
        # the phase-1 rings, each opened by two live recorders
        rep = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report",
             str(root / "phase1" / "pmem"), "--json"],
            capture_output=True, text=True, timeout=300, check=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        ring = json.loads(rep.stdout)
        check(ring["snapshot"] is not None,
              "the phase-1 pools hold no shutdown snapshot")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        release()
    losses, losses2 = out["losses"], out["losses2"]
    check(all(np.isfinite(losses + losses2)) and losses2[0] < losses[0],
          f"elastic losses {losses} then {losses2}")
    check(out["saved"]["nodes"] == [f"node{i}" for i in
                                    range(ELASTIC_NODES[0])] and
          out["resumed"]["nodes"] == [f"node{i}" for i in
                                      range(ELASTIC_NODES[1])],
          f"rings {out['saved']['nodes']} -> {out['resumed']['nodes']}")
    check(all(c == 0 for c in launches.values()),
          f"the elastic path launched kernels: {launches}")
    peak = peak_line(device, "elastic phase")
    print(f"elastic phase 1: losses {losses}; train_s={out['train_s']}; "
          f"save (commit) {out['save_s']} s under the sanitizer (the "
          f"recovery phase's save_async of this state to its commit, "
          f"while its loop ran: {ref_save_s} s); replicas acked "
          f"{out['replicate_s']} s after the commit [{card}]")
    print(f"elastic restore({ELASTIC_STEPS}) on a second cluster over the "
          f"phase-1 pools: {len(digests['restored'])} leaves bit-identical "
          f"to the saved state (per-leaf digests); restore_s="
          f"{out['restore_s']}")
    print(f"elastic phase 2 ({ELASTIC_NODES[1]} nodes): losses {losses2}; "
          f"resume_s={out['resume_s']} ({ELASTIC_STEPS} steps and the "
          f"parameters' save to its acks); phase_s={phase_s}; phase-1 "
          f"rings replay {len(ring['events'])} events; launches "
          f"{launches}")
    return dict(stats=stats, violations=len(san.violations),
                losses=losses, losses2=losses2, phase_s=phase_s,
                peak=peak, ring_events=len(ring["events"]),
                **{k: out[k] for k in ("train_s", "save_s", "replicate_s",
                                       "restore_s", "resume_s")})


def sanitize_phase(device, card: str):
    """The port's three crash tests under a capture-mode ``PMemSanitizer``
    on the card's host (JAX's ``tests/test_analysis.py``,
    ``tests/test_obs.py`` and ``tests/test_zero_copy.py``): every crash
    image of a MetaLog append sequence and of a flight ring replays to a
    committed prefix, and no crash image of a copy that failed at its
    commit makes the partial replica visible. The copied object is made
    on the card and goes through the lossy wire codec, so its encode runs
    in encode_tiles on the card; the counts are reset just before that
    copy and read after it, after the retried copy and after the
    replica's read-back (decode_tiles, one launch a delta8 leaf). The
    replica's stored codes and scales equal the plain encode of the
    source, and its read-back the plain decode, bit for bit."""
    import torch
    from repro_torch.analysis import PMemSanitizer
    from repro_torch.bridge import tree_leaves
    from repro_torch.core.meta_log import MetaLog
    from repro_torch.core.object_store import PMemObjectStore, copy_object
    from repro_torch.core.pmem import PMemPool
    from repro_torch.obs.recorder import EVT_POINT, FlightRecorder

    root = pool_root(1 << 30)
    res = {}

    def fold(state, ev):
        state[str(ev["i"])] = ev["v"]

    def captured(fn):
        san = PMemSanitizer(capture=True).install()
        try:
            out = fn(san)
        finally:
            san.uninstall()
        san.raise_violations()
        return san, out

    try:
        # leg 1: MetaLog appends
        def appends(san):
            store = PMemObjectStore(PMemPool(root / "mlog", "node0"),
                                    device=device)
            log = MetaLog({"node0": store}, ["node0"], "t/log", fold=fold)
            for i in range(SANITIZE_APPENDS):
                log.append({"i": i, "v": i * 10})

        san, _ = captured(appends)
        prefixes = [{str(j): j * 10 for j in range(k)}
                    for k in range(SANITIZE_APPENDS + 1)]
        reached, n = set(), 0
        for label, img in san.crash_images("t/log"):
            rpool = PMemPool(root / "mlog_replay", "node0")
            san.materialize(img, rpool, "t/log")
            state = dict(MetaLog({"node0": PMemObjectStore(
                rpool, device=device)}, ["node0"], "t/log", fold=fold)
                .state())
            check(state in prefixes, f"MetaLog crash image {label} replayed "
                                     f"to a non-prefix {state}")
            reached.add(len(state))
            n += 1
        check(n >= 3 * SANITIZE_APPENDS and
              reached == set(range(SANITIZE_APPENDS + 1)),
              f"{n} MetaLog crash images reaching prefixes {reached}")
        res["metalog"] = dict(images=n, reached=sorted(reached),
                              stats=dict(san.stats))
        print(f"sanitize metalog: {SANITIZE_APPENDS} appends, {n} crash "
              f"images, each replayed to a committed prefix; prefix "
              f"lengths reached {sorted(reached)}; {san.stats}")

        # leg 2: the flight ring's torn tail
        def ring(san):
            pool = PMemPool(root / "ring", "node0")
            rec = FlightRecorder(pool, slots=8, slot_bytes=128)
            for i in range(SANITIZE_RING_EVENTS):
                rec.record(EVT_POINT, f"ev{i}", attrs={"i": i})
            return [e["attrs"]["i"] for e in FlightRecorder.replay(pool)]

        san, full = captured(ring)
        check(full == list(range(SANITIZE_RING_EVENTS)), f"ring {full}")
        spool = PMemPool(root / "ring_replay", "node0")
        lens, n = set(), 0
        for label, img in san.crash_images("flightring"):
            san.materialize(img, spool, "obs/flightring")
            got = [e["attrs"]["i"] for e in FlightRecorder.replay(spool)]
            check(got == full[:len(got)], f"ring crash image {label} "
                                          f"replayed {got}")
            lens.add(len(got))
            n += 1
        check(lens == set(range(SANITIZE_RING_EVENTS + 1)),
              f"ring prefixes reached {lens}")
        res["ring"] = dict(images=n, reached=sorted(lens))
        print(f"sanitize flight ring: {SANITIZE_RING_EVENTS} events, {n} "
              f"crash images, each a clean prefix; lengths {sorted(lens)}")

        # leg 3: a crash mid-copy through the wire codec, from the card
        gen = torch.Generator(device=device).manual_seed(SEED)
        rows, cols = SANITIZE_COPY_SHAPE
        tree = {"layer": {"w": torch.randn(rows, cols, generator=gen,
                                           device=device),
                          "b": torch.randn(cols, generator=gen,
                                           device=device)},
                "ids": torch.arange(rows, dtype=torch.int32, device=device)}
        codec = {"strict": False}

        def crash_copy(san):
            st = {nid: PMemObjectStore(PMemPool(root / "copy", nid),
                                       device=device) for nid in ("a", "b")}
            st["a"].put("obj", tree, meta={"step": 3})
            orig = st["b"].pool.put_json

            def failing_put_json(name, obj):
                if name.endswith(".manifest"):
                    raise IOError("injected crash at the commit point")
                return orig(name, obj)

            st["b"].pool.put_json = failing_put_json
            reset_launches()
            acked = []
            try:
                acked.append(copy_object(st["a"], st["b"], "obj",
                                         expect_meta={"step": 3},
                                         chunk_bytes=SANITIZE_CHUNK,
                                         codec=codec))
            except IOError:
                pass
            else:
                raise SmokeFailure("the copy's failing commit did not raise")
            launches = read_launches()
            st["b"].pool.put_json = orig
            check(acked == [] and not st["b"].exists("obj"),
                  "a copy that failed at its commit left the object visible")
            images = [(label, img) for label, img in
                      san.crash_images("b/objects/obj") if ".data" in label]
            check(bool(images), "no destination write states captured")
            for label, img in images:
                check(".shadow" in label, f"a destination write outside the "
                                          f"shadow: {label}")
                san.materialize(img, st["b"].pool, "objects/obj@v0.data")
                check(not st["b"].exists("obj"),
                      f"crash image {label} made the partial replica "
                      f"visible")
            man = copy_object(st["a"], st["b"], "obj",
                              expect_meta={"step": 3}, codec=codec)
            copied = read_launches()
            got = dict(tree_leaves(st["b"].get("obj", verify=True)))
            total = read_launches()
            read = diff_launches(total, copied)
            src = dict(tree_leaves(tree))
            check(man["meta"]["step"] == 3 and np.array_equal(
                got["ids"], src["ids"].cpu().numpy()),
                "the retried copy did not commit the object whole")
            wc = man["meta"]["wire_codec"]["leaves"]
            enc = sorted(p for p, ce in wc.items() if ce["mode"] == "delta8")
            check(enc == ["layer/b", "layer/w"] and
                  read["decode_tiles"] == len(enc),
                  f"the replica's delta8 leaves {enc}, its read-back "
                  f"launched {read}")
            # the replica's codes against the plain encode of the source,
            # its kernel decode against the plain decode, bit for bit
            plain = dict(tree_leaves(PMemObjectStore(
                st["b"].pool, device="cpu").get("obj")))
            for path in enc:
                q, sc = stored_codes(st["b"], "obj", wc[path])
                pq, psc = plain_codes(src[path], device)
                check(q.tobytes() == pq.tobytes() and
                      sc.tobytes() == psc.tobytes(),
                      f"sanitize copy {path}: encode_tiles' stored codes "
                      f"and scales differ from its plain version")
                check(got[path].dtype == plain[path].dtype and
                      got[path].tobytes() == plain[path].tobytes(),
                      f"sanitize copy {path}: kernel decode differs from "
                      f"the plain decode of the same codes")
            return len(images), launches, total, enc

        san, (n, launches, total, enc) = captured(crash_copy)
        check(launches["encode_tiles"] > 0,
              f"the failing codec copy launched encode_tiles "
              f"{launches['encode_tiles']} times")
        res["copy"] = dict(images=n, launches=total, failing=launches)
        print(f"sanitize copy: {rows} x {cols} float32 made on the card, "
              f"copied through the lossy wire codec in {SANITIZE_CHUNK} B "
              f"chunks, the commit failing: {n} crash images of the "
              f"destination's writes, none makes the replica visible; "
              f"the failing copy launched encode_tiles "
              f"{launches['encode_tiles']} times, decode_tiles "
              f"{launches['decode_tiles']}; with the retried copy and the "
              f"replica's read-back {total['encode_tiles']} and "
              f"{total['decode_tiles']}; {enc} stored "
              f"codes and scales equal the plain encode, the read-back the "
              f"plain decode, bit for bit [{card}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def dist_local_bytes(tree) -> int:
    """Bytes this process holds of a tree: a DTensor's local block, a
    plain tensor whole."""
    from repro_torch.bridge import tree_leaves
    from repro_torch.distributed.compat import is_sharded_tensor
    n = 0
    for _, t in tree_leaves(tree):
        t = t.to_local() if is_sharded_tensor(t) else t
        n += t.numel() * t.element_size()
    return n


def dist_legs(rank: int, device) -> dict:
    """The compressed reduction over ("data",) of size 2 against the plain
    mean, and the GPipe pipeline over ("pod",) of size 2 against the
    stages run in turn, on the card."""
    import torch
    from repro_torch.distributed import compat
    from repro_torch.distributed.compression import (
        compressed_psum_scatter_gather, init_error_state)
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh

    rng = np.random.default_rng(SEED)
    n = DIST_COMPRESS_N
    x = torch.from_numpy((rng.standard_normal((DIST_WORLD, n)) * 0.1)
                         .astype(np.float32)).to(device)
    # each rank's error-feedback state, [n / ranks], stacked as the
    # shard_map's global view
    err0 = init_error_state(n, DIST_WORLD, device)[None] \
        .expand(DIST_WORLD, -1).contiguous()
    mesh_c = make_mesh((DIST_WORLD,), ("data",), device)

    def body(xl, el):
        y, e = compressed_psum_scatter_gather(xl[0], "data", el[0])
        return y[None], e[None]

    f = compat.shard_map(body, mesh=mesh_c,
                         in_specs=(compat.P("data"), compat.P("data")),
                         out_specs=(compat.P("data"), compat.P("data")))
    compat.reset_stats()
    y, _ = f(x, err0)
    ref = x.mean(0)
    rel1 = ((y.to_local()[0] - ref).abs().max() / ref.abs().max()).item()
    stats1 = compat.stats()
    acc, eacc = torch.zeros_like(ref), err0
    for _ in range(DIST_COMPRESS_ROUNDS):
        yy, eacc = f(x, eacc)
        acc = acc + yy.to_local()[0]
    rel8 = ((acc / DIST_COMPRESS_ROUNDS - ref).abs().max() /
            ref.abs().max()).item()

    stages, n_micro, mb, d = DIST_PIPE
    ws = torch.from_numpy((rng.standard_normal((stages, d, d)) * 0.3)
                          .astype(np.float32)).to(device)
    xm = torch.from_numpy(rng.standard_normal((n_micro, mb, d))
                          .astype(np.float32)).to(device)
    mesh_p = make_mesh((DIST_WORLD,), ("pod",), device)
    compat.reset_stats()
    out = pipeline_apply(mesh_p, lambda w, h: torch.tanh(h @ w), ws, xm,
                         axis="pod")
    seq = xm
    for i in range(stages):
        seq = torch.tanh(seq @ ws[i])
    pipe_err = (out - seq).abs().max().item()
    return {"compress_rel": rel1, "compress_rel8": rel8,
            "compress_stats": stats1, "pipeline_err": pipe_err,
            "pipeline_stats": compat.stats()}


class RoutingLog:
    """Within a ``with``, the experts each decode-step MoE call routes to
    (calls of ``batch`` tokens; both the hooks' and the single-device
    routes go through ``models.moe.router_probs``), in call order."""

    def __init__(self, batch: int):
        self.batch, self.ids = batch, []

    def __enter__(self):
        from repro_torch.distributed import moe_parallel
        from repro_torch.models import moe
        self.mods = (moe, moe_parallel)
        self.orig = moe.router_probs

        def router_probs(p, x, cfg):
            gates, ids, probs = self.orig(p, x, cfg)
            if x.numel() // x.shape[-1] == self.batch:
                self.ids.append(ids.reshape(self.batch, -1).cpu())
            return gates, ids, probs

        for m in self.mods:
            m.router_probs = router_probs
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.router_probs = self.orig


def dist_serve(mesh, cfg, pre, dec, params, tokens, feed):
    """The two-rank serve: prefill through the prefill plan's runtime
    (the cache comes back as this rank's blocks), then a decode step
    through the decode plan's for each of ``feed``'s tokens. Returns the
    logits of the prefill and of each step, gathered whole."""
    import torch
    from repro_torch.distributed.compat import to_replicated
    from repro_torch.models import transformer as tfm
    with torch.no_grad():
        logits, cache = tfm.prefill(params, cfg, pre, tokens)
        out = [to_replicated(logits, mesh)]
        for i, tok in enumerate(feed):
            lg, cache = tfm.decode_step(params, cfg, dec, cache, tok,
                                        tokens.shape[1] + i)
            out.append(to_replicated(lg, mesh))
    sync()
    return out


def dist_plan_bytes(cfg, rt, mesh) -> int:
    """The parameter bytes a rank holds under the reference's plan
    without FSDP (``tree_shardings``, ``zero1=False``)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tfm
    shapes, specs = tfm.abstract_params(cfg, rt)
    return dryrun._sharded_bytes(shapes, shd.tree_shardings(shapes, specs,
                                                            mesh))


def dist_reference(cfg, full, tokens, gen: int, ring: int) -> dict:
    """Rank 0's single-device port path (flash and gmm kernels, no hooks)
    on the whole tree, its experts re-laid to one slot (not redrawn):
    the prefill logits and ``gen`` greedy decode steps' logits, the
    tokens it fed and the experts each decode step routed to."""
    import torch
    from repro_torch.bridge import relayout_experts
    from repro_torch.models import transformer as tfm
    rt = tfm.ModelRuntime(tp=1, max_seq=ring)
    ref = relayout_experts(full, cfg, tp=1)
    with torch.no_grad(), RoutingLog(tokens.shape[0]) as log:
        logits, cache = tfm.prefill(ref, cfg, rt, tokens)
        out, fed = [logits], []
        for i in range(gen):
            fed.append(out[-1].argmax(-1))
            lg, cache = tfm.decode_step(ref, cfg, rt, cache, fed[-1],
                                        tokens.shape[1] + i)
            out.append(lg)
    sync()
    return {"logits": out, "fed": torch.stack(fed), "ids": log.ids}


def dist_gaps(got, want, ids_got, ids_want, layers: int) -> list:
    """Per step (prefill, then each decode step): max |diff| as a share
    of the reference's largest logit, whether the greedy tokens agree,
    and in how many of the step's MoE layers the two paths routed a
    token to other experts (0 for the prefill: not recorded)."""
    flips = [0] + [sum(not bool((a == b).all()) for a, b in zip(
        ids_got[i * layers:(i + 1) * layers],
        ids_want[i * layers:(i + 1) * layers]))
        for i in range(len(got) - 1)]
    return [{"rel": ((g - w).abs().max() / w.abs().max()).item(),
             "argmax_equal": bool((g.argmax(-1) == w.argmax(-1)).all()),
             "routing_flips": f}
            for g, w, f in zip(got, want, flips)]


def dist_model(mesh, cfg, pre, device, seed: int, dtype, tokens, gen: int,
               ring: int, reference: bool, ref_fn=None):
    """Random bf16 parameters drawn on the card from ``seed`` in the
    plan's (tp=2) layout, cast leaf by leaf to ``dtype``, and this rank's
    blocks of them under the plan's layout (owned copies). On the
    ``reference`` rank the whole tree is drawn, first serves ``ref_fn``
    (``dist_reference``), and is freed once cut; any other rank keeps its
    block of each leaf as it is drawn, so it never holds the whole tree.
    The fed tokens [gen, batch] are then broadcast from rank 0 to every
    rank. Returns (blocks, the reference's result or None, fed tokens,
    init s)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import transformer as tfm
    t0 = time.perf_counter()
    gen_ = torch.Generator(device=device).manual_seed(seed)
    specs = tfm.param_specs(cfg, pre)
    ref = None
    if reference:
        full = tfm.init_params(cfg, pre, gen_, device=device)
        if dtype != torch.bfloat16:
            cast_leaves_(full, dtype)
        ref = (ref_fn or dist_reference)(cfg, full, tokens, gen, ring)
        params = pre.layout.shard(full, specs, copy=True)
        del full
    else:
        params = tfm.init_params(cfg, pre, gen_, device=device,
                                 keep=pre.layout.block)
    torch.cuda.empty_cache()
    if dtype != torch.bfloat16 and not reference:
        cast_leaves_(params, dtype)
    sync()
    init_s = time.perf_counter() - t0
    fed = ref["fed"] if reference else \
        torch.empty((gen, tokens.shape[0]), dtype=torch.int64, device=device)
    dist.broadcast(fed, 0)
    return params, ref, fed, init_s


def dist_rank_body(rank: int, device, out: dict) -> None:
    """One rank's part of ``distributed_phase``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ParallelConfig, ShapeConfig
    from repro_torch.configs.base import DECODE, PREFILL
    from repro_torch.distributed import compat
    from repro_torch.distributed import moe_parallel as mp
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm

    def say(msg):
        free, total = torch.cuda.mem_get_info(device)
        print(f"distributed rank {rank}: {msg} (reserved "
              f"{torch.cuda.memory_reserved(device)} B, card "
              f"free {free} of {total} B)", flush=True)

    batch, prompt, ring, gen = DIST_BATCH, DIST_PROMPT, DIST_RING, GEN_A
    out["legs"] = dist_legs(rank, device)
    mesh = make_mesh((1, DIST_WORLD), ("data", "model"), device)
    cfg = dist_config()
    par = ParallelConfig(attn_impl="pallas")
    pre = shd.Plan(mesh, cfg, ShapeConfig("dist_prefill", ring, batch,
                                          PREFILL), par).runtime()
    dec = shd.Plan(mesh, cfg, ShapeConfig("dist_decode", ring, batch,
                                          DECODE), par).runtime()
    out["hooks"] = {"prefill_moe": pre.moe_fn.__qualname__,
                    "decode_moe": dec.moe_fn.__qualname__,
                    "decode_attn": dec.decode_attn_fn.__qualname__}
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int64), device=device)
    torch.cuda.reset_peak_memory_stats(device)
    params, ref, fed, init_s = dist_model(
        mesh, cfg, pre, device, SEED, torch.bfloat16, tokens, gen, ring,
        reference=(rank == 0))
    wi = params["group0"]["p0"]["mlp"]["wi"]
    out["params"] = {
        "init_s": init_s, "resident_bytes": dist_local_bytes(params),
        "plan_bytes": dist_plan_bytes(cfg, pre, mesh),
        "whole_leaves": dist_whole_leaves(params, tfm.param_specs(cfg, pre),
                                          pre.layout),
        "expert_bytes": dist_local_bytes(params["group0"]["p0"]["mlp"]),
        "wi_local": list(wi.to_local().shape), "wi_global": list(wi.shape),
        "init_peak": torch.cuda.max_memory_allocated(device)}
    del wi  # a view of the expert block: it would outlive ``params``
    say(f"blocks {out['params']['resident_bytes']} B, init peak "
        f"{out['params']['init_peak']} B")

    # the main path, at the config's capacity factor: counts reset just
    # before it, read just after
    torch.cuda.reset_peak_memory_stats(device)
    fa_ops.launches = 0
    fa_ops.launches_by_route = dict.fromkeys(fa_ops.ROUTES, 0)
    compat.reset_stats()
    mp.reset_route_stats()
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = tfm.prefill(params, cfg, pre, tokens)
        sync()
        prefill_s = time.perf_counter() - t0
    out["prefill"] = {
        "s": prefill_s, "flash_launches": fa_ops.launches,
        "flash_routes": dict(fa_ops.launches_by_route),
        "pairs": int(mp.route_stats["pairs"]),
        "dropped": int(mp.route_stats["dropped"]),
        "collectives": compat.stats(),
        "peak": torch.cuda.max_memory_allocated(device)}
    say(f"prefill {prefill_s:.3f}s, flash launches {fa_ops.launches} "
        f"{dict(fa_ops.launches_by_route)}")
    with torch.no_grad():
        cache = shd.shard(cache, tfm.cache_specs(cfg, dec, batch), mesh)
        k0 = cache["group0"]["p0"]["self"]["k"]
        out["cache"] = {"k_local": list(k0.to_local().shape),
                        "k_global": list(k0.shape),
                        "bytes": dist_local_bytes(cache)}
        tok = compat.to_replicated(logits, mesh).argmax(-1)
        torch.cuda.reset_peak_memory_stats(device)
        compat.reset_stats()
        sync()
        t0 = time.perf_counter()
        for i in range(gen):
            lg, cache = tfm.decode_step(params, cfg, dec, cache, tok,
                                        prompt + i)
            tok = compat.to_replicated(lg, mesh).argmax(-1)
        sync()
        decode_s = time.perf_counter() - t0
    out["decode"] = {
        "s": decode_s, "tokens_per_s": batch * gen / decode_s,
        "bytes_model": compat.bytes_over("model"),
        "collectives": compat.stats(),
        "flash_launches_total": fa_ops.launches,
        "peak": torch.cuda.max_memory_allocated(device)}
    say(f"decode {gen} steps {decode_s:.3f}s")
    del logits, cache, lg, tok
    torch.cuda.empty_cache()

    # the dropless comparison with rank 0's single-device path, fed its
    # greedy tokens
    cfg8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=DIST_DROPLESS_CF))
    mp.reset_route_stats()
    with RoutingLog(batch) as log:
        got = dist_serve(mesh, cfg8, pre, dec, params, tokens, fed)
    out["dropless_dropped"] = int(mp.route_stats["dropped"])
    if rank == 0:
        out["gaps_bfloat16"] = dist_gaps(got, ref["logits"], log.ids,
                                         ref["ids"], cfg.n_layers)
    say("bf16 comparison run")
    del got, params, ref, fed
    torch.cuda.empty_cache()
    dist.barrier()

    # float32 at one layer, dropless
    one = dataclasses.replace(cfg8, n_layers=1)
    pre1 = shd.Plan(mesh, one, ShapeConfig("dist_prefill", ring, batch,
                                           PREFILL), par).runtime()
    torch.cuda.reset_peak_memory_stats(device)
    params, ref, fed, _ = dist_model(
        mesh, one, pre1, device, SEED + 1, torch.float32, tokens, gen, ring,
        reference=(rank == 0))
    with RoutingLog(batch) as log:
        got = dist_serve(mesh, one, pre1, dec, params, tokens, fed)
    if rank == 0:
        out["gaps_float32"] = dist_gaps(got, ref["logits"], log.ids,
                                        ref["ids"], one.n_layers)
    out["float32_peak"] = torch.cuda.max_memory_allocated(device)
    say("float32 comparison run")
    del got, params, ref, fed
    torch.cuda.empty_cache()
    dist.barrier()

    # the collectives' backward: a training step's gradients through the
    # MoE hook on the two ranks against rank 0's single device
    out["backward"] = dist_backward(rank, device, mesh)
    say("backward run")
    dist.barrier()

    # the dense layout: gemma2-9b served at full width, then trained at
    # full width on (2, 1) and (1, 2)
    out["dense"] = dist_dense_serve(rank, device, mesh, say)
    dist.barrier()
    out["dense_train"] = dist_dense_train(rank, device, say)
    dist.barrier()
    # FSDP and ZeRO-2: a step of grok-1 (1 layer) on (2, 1)
    out["fsdp_train"] = dist_fsdp_train(rank, device, say)
    dist.barrier()


def dist_backward(rank: int, device, mesh) -> dict:
    """One backward of the training cross-entropy of DIST_TRAIN_ARCH's
    smoke config, in float32 and then in bf16 (``DIST_GRAD_TOL``'s
    keys), through the train plan's runtime as it is
    at the phase's (1, 2) mesh (the dense layout: each rank its rows,
    heads, MLP and vocabulary blocks and expert blocks, ``make_moe_etp``;
    blockwise attention), from parameters drawn alike on both ranks, at
    a capacity factor that drops nothing; on rank 0 also the
    single-device path (the same parameters relaid to one slot, the
    1 x 1 plan). Returns, by dtype, the loss, the backward's collectives
    (compat's counters) and, on rank 0, each leaf's distance from the
    single-device gradient in the same dtype: the norm of the difference
    as a share of the gradient's norm (``rel``), and the largest |diff|
    as a share of its largest element (``rel_max``, printed); in bf16
    also the distance of either side from the single-device float32
    gradient (``rel_f32``, ``rel_f32_single``: the bf16 gap is rounding
    when the two sides stand alike far from float32)."""
    import torch
    from repro_torch.bridge import (relayout_experts, tree_from_leaves,
                                    tree_leaves)
    from repro_torch.configs import ParallelConfig, ShapeConfig, registry
    from repro_torch.configs.base import TRAIN
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train import train_step

    cfg = registry.get_smoke_config(DIST_TRAIN_ARCH)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=DIST_DROPLESS_CF))
    b, s = DIST_TRAIN_SHAPE
    shape = ShapeConfig("dist_train", s, b, TRAIN)
    rng = np.random.default_rng(SEED + 3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)),
             "loss_mask": (rng.random((b, s)) < 0.9).astype(np.float32)}
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    def grads(mesh_, params, count: bool):
        rt = shd.Plan(mesh_, cfg, shape, ParallelConfig()).runtime()
        tfm.check_trainable(cfg, rt)
        leaves = dict(tree_leaves(params))
        live = {k: t.detach().requires_grad_() for k, t in leaves.items()}
        _, m = train_step.make_loss_fn(cfg, rt)(tree_from_leaves(live),
                                                batch)
        # the cross-entropy: the load-balance term is a mean of per-shard
        # losses on a mesh (JAX's too), not the single device's one loss
        loss = m["nll"] / m["ntok"].clamp_min(1.0)
        if count:
            compat.reset_stats()
        g = torch.autograd.grad(loss, list(live.values()))
        stats = compat.stats() if count else None
        with torch.no_grad():
            whole = {k: compat.to_replicated(x, mesh_)
                     for k, x in zip(live, g)}
        return float(loss.detach()), whole, stats, rt

    def rel(a, b):
        return {k: ((a[k].float() - w.float()).norm() /
                    w.float().norm().clamp_min(1e-30)).item()
                for k, w in b.items()}

    rt2 = shd.Plan(mesh, cfg, shape, ParallelConfig()).runtime()
    specs = tfm.param_specs(cfg, rt2)
    res, want32 = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=device).manual_seed(SEED + 3)
        full = tfm.init_params(cfg, rt2, gen, device=device)
        if dtype != torch.bfloat16:
            cast_leaves_(full, dtype)
        params = rt2.layout.shard(full, specs, copy=True)
        loss, got, stats, _ = grads(mesh, params, True)
        out = {"loss": loss, "collectives": stats,
               "hook": rt2.moe_fn.__qualname__,
               "sharded": sum(compat.is_sharded_tensor(t)
                              for _, t in tree_leaves(params)),
               "whole_leaves": dist_whole_leaves(params, specs, rt2.layout)}
        if rank == 0:
            one = make_mesh((1, 1), ("data", "model"), device)
            loss1, want, _, rt1 = grads(
                one, relayout_experts(full, cfg, tp=1), False)
            got = dict(tree_leaves(relayout_experts(tree_from_leaves(got),
                                                    cfg, tp=1)))
            out["loss_single"] = loss1
            out["hook_single"] = rt1.moe_fn.__qualname__
            out["rel"] = rel(got, want)
            out["rel_max"] = {
                k: ((got[k].float() - w.float()).abs().max() /
                    w.float().abs().max().clamp_min(1e-30)).item()
                for k, w in want.items()}
            if want32 is None:
                want32 = want
            else:
                out["rel_f32"] = rel(got, want32)
                out["rel_f32_single"] = rel(want, want32)
        res[str(dtype).split(".")[-1]] = out
    sync()
    return res


def dist_whole_leaves(params, specs, layout) -> list:
    """The leaves the layout cuts that this rank holds whole (none, or
    the phase fails)."""
    from repro_torch.bridge import tree_leaves
    from repro_torch.distributed.compat import local_of
    from repro_torch.distributed.sharding import NamedSharding
    want = layout.specs(params, specs)
    flat = dict(tree_leaves(want))
    return [k for k, t in tree_leaves(params)
            if tuple(local_of(t).shape) != NamedSharding(
                layout.mesh, flat[k]).shard_shape(tuple(t.shape))]


def dist_dense_reference(cfg, full, tokens, gen: int, ring: int) -> dict:
    """Rank 0's single-device path of the dense leg (the flash kernel,
    no layout) on the whole tree: the prefill logits and ``gen`` greedy
    decode steps' logits, and the tokens it fed."""
    import torch
    from repro_torch.models import transformer as tfm
    rt = tfm.ModelRuntime(tp=1, max_seq=ring)
    with torch.no_grad():
        logits, cache = tfm.prefill(full, cfg, rt, tokens)
        out, fed = [logits], []
        for i in range(gen):
            fed.append(out[-1].argmax(-1))
            lg, cache = tfm.decode_step(full, cfg, rt, cache, fed[-1],
                                        tokens.shape[1] + i)
            out.append(lg)
    sync()
    return {"logits": out, "fed": torch.stack(fed)}


def dist_dense_serve(rank: int, device, mesh, say) -> dict:
    """gemma2-9b at full width, DIST_DENSE_LAYERS layers, on (1, 2):
    each rank draws its blocks of the plan's layout leaf by leaf (rank 0
    the whole tree first, for its single-device reference), then the
    main path: the
    prefill (flash on this rank's 8 q / 4 kv heads, each layer) and
    GEN_A decode steps through flash-decoding, fed the reference's
    greedy tokens, with the flash counters and compat's reset just
    before. Returns bytes held and planned, the leaves held whole where
    the plan cuts them, times, peaks, collectives, flash launches and,
    on rank 0, the logits' gaps against the reference."""
    import torch
    from repro_torch.configs import ParallelConfig, ShapeConfig, registry
    from repro_torch.configs.base import DECODE, PREFILL
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(registry.get_config(DIST_DENSE_ARCH),
                              n_layers=DIST_DENSE_LAYERS)
    b, prompt, ring, gen = DIST_DENSE_BATCH, DIST_DENSE_PROMPT, \
        DIST_DENSE_RING, GEN_A
    par = ParallelConfig(attn_impl="pallas")
    pre = shd.Plan(mesh, cfg, ShapeConfig("dense_prefill", ring, b,
                                          PREFILL), par).runtime()
    dec = shd.Plan(mesh, cfg, ShapeConfig("dense_decode", ring, b,
                                          DECODE), par).runtime()
    rng = np.random.default_rng(SEED + 5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, prompt))
                             .astype(np.int64), device=device)
    torch.cuda.reset_peak_memory_stats(device)
    params, ref, fed, init_s = dist_model(
        mesh, cfg, pre, device, SEED + 5, torch.bfloat16, tokens, gen, ring,
        reference=(rank == 0), ref_fn=dist_dense_reference)
    wq = params["group0"]["p0"]["mixer"]["wq"]
    out = {"init_s": init_s, "resident_bytes": dist_local_bytes(params),
           "plan_bytes": dist_plan_bytes(cfg, pre, mesh),
           "whole_leaves": dist_whole_leaves(
               params, tfm.param_specs(cfg, pre), pre.layout),
           "wq_local": list(compat.local_of(wq).shape),
           "wq_global": list(wq.shape),
           "init_peak": torch.cuda.max_memory_allocated(device)}
    say(f"dense blocks {out['resident_bytes']} B (plan "
        f"{out['plan_bytes']} B), init {init_s:.3f}s")
    torch.cuda.reset_peak_memory_stats(device)
    fa_ops.launches = 0
    fa_ops.launches_by_route = dict.fromkeys(fa_ops.ROUTES, 0)
    compat.reset_stats()
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = tfm.prefill(params, cfg, pre, tokens)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["flash_launches"] = fa_ops.launches
        out["flash_routes"] = dict(fa_ops.launches_by_route)
        out["prefill_collectives"] = compat.stats()
        out["prefill_peak"] = torch.cuda.max_memory_allocated(device)
        k0 = cache["group0"]["p1"]["self"]["k"]
        out["cache"] = {"k_local": list(compat.local_of(k0).shape),
                        "k_global": list(k0.shape)}
        got = [compat.to_replicated(logits, mesh)]
        compat.reset_stats()
        torch.cuda.reset_peak_memory_stats(device)
        sync()
        t0 = time.perf_counter()
        for i in range(gen):
            lg, cache = tfm.decode_step(params, cfg, dec, cache, fed[i],
                                        prompt + i)
            got.append(compat.to_replicated(lg, mesh))
        sync()
        out["decode_s"] = time.perf_counter() - t0
    out["tokens_per_s"] = b * gen / out["decode_s"]
    out["decode_collectives"] = compat.stats()
    out["decode_peak"] = torch.cuda.max_memory_allocated(device)
    out["flash_launches_total"] = fa_ops.launches
    if rank == 0:
        out["gaps"] = [{"rel": ((g - w).abs().max() /
                                w.abs().max()).item(),
                        "argmax_equal": bool((g.argmax(-1) ==
                                              w.argmax(-1)).all())}
                       for g, w in zip(got, ref["logits"])]
    say(f"dense prefill {out['prefill_s']:.3f}s, decode "
        f"{out['decode_s']:.3f}s, flash {out['flash_launches']} "
        f"{out['flash_routes']}")
    del params, ref, fed, got, logits, cache, lg
    torch.cuda.empty_cache()
    return out


def dist_dense_train(rank: int, device, say) -> dict:
    """gemma2-9b at full width, DIST_TRAIN_LAYERS layers: one AdamW step
    (float32 moments) on (2, 1) (ZeRO-1) and on (1, 2), each rank
    against its own single-device step on the same parameters and batch
    (both ranks run the reference at once, each keeping its blocks of
    the reference's first moments and updated parameters; blockwise
    attention: the kernels refuse training). Returns per mesh the loss,
    the moments' bytes held and whole, and the worst gaps."""
    import torch
    import torch.distributed as dist
    from repro_torch.bridge import tree_leaves, tree_map
    from repro_torch.configs import ParallelConfig, ShapeConfig, registry
    from repro_torch.configs.base import TRAIN
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg = dataclasses.replace(registry.get_config(DIST_DENSE_ARCH),
                              n_layers=DIST_TRAIN_LAYERS)
    b, s = DIST_TRAIN_BATCH, DIST_TRAIN_SEQ
    shape = ShapeConfig("dense_train", s, b, TRAIN)
    par = ParallelConfig(attn_impl="blockwise")
    adamw = opt.AdamWConfig(lr=DIST_TRAIN_LR, warmup=1)
    rng = np.random.default_rng(SEED + 6)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)),
             "loss_mask": (rng.random((b, s)) < 0.9).astype(np.float32)}
    meshes = {"2x1": make_mesh((2, 1), ("data", "model"), device),
              "1x2": make_mesh((1, 2), ("data", "model"), device)}
    rts = {m: shd.Plan(mesh, cfg, shape, par).runtime()
           for m, mesh in meshes.items()}
    one = tfm.ModelRuntime(tp=1, attn_impl="blockwise", max_seq=s)

    def draw():
        return tfm.init_params(cfg, one, torch.Generator(
            device=device).manual_seed(SEED + 6), device=device)

    def blocks_of(tree, m, zero):
        """This rank's blocks of a whole tree of moments (``zero``) or
        parameters under mesh ``m``'s layout, as bf16 copies on the host
        (the card keeps room for the two ranks' steps)."""
        rt = rts[m]
        out = {}
        for k, t in tree_leaves(tree):
            spec = zero.moment[f"{k}/m"] if zero is not None else \
                rt.layout.specs({"x": t}, {"x": specs[k]})["x"]
            out[k] = compat.local_block(t, spec, meshes[m]).to(
                torch.bfloat16).cpu()
        return out

    specs = dict(tree_leaves(tfm.param_specs(cfg, one)))
    refs = {}
    # each rank's reference, both at once: the zero moments are expanded
    # views (no storage), so a rank's step holds its parameters,
    # gradients, new moments and new parameters, ~34 GB
    params = draw()
    zero_m = torch.zeros((), dtype=torch.float32, device=device)
    state = {"moments": tree_map(lambda p: {"m": zero_m.expand(p.shape),
                                            "v": zero_m.expand(p.shape)},
                                 params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    newp, st, m1 = ts.make_train_step(cfg, one, adamw)(params, state, batch)
    mom = tfm_moments(st)
    for m in meshes:
        zero = ts.zero1_plan(cfg, rts[m], adamw)
        refs[m] = {"loss": float(m1["loss"]), "m": blocks_of(mom, m, zero),
                   "p": blocks_of(newp, m, None)}
    del params, state, newp, st, mom
    torch.cuda.empty_cache()
    dist.barrier()
    say("dense train references")
    res = {}
    for m, mesh in meshes.items():
        rt = rts[m]
        torch.cuda.reset_peak_memory_stats(device)
        params = rt.layout.shard(draw(), tfm.param_specs(cfg, rt), copy=True)
        torch.cuda.empty_cache()
        zero = ts.zero1_plan(cfg, rt, adamw)
        state = opt.init_opt_state(params, adamw, zero=zero)
        compat.reset_stats()
        sync()
        t0 = time.perf_counter()
        newp, st, m1 = ts.make_train_step(cfg, rt, adamw)(params, state,
                                                          batch)
        sync()
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        del state
        ref = refs[m]
        mom = tfm_moments(st)
        # squared norms by leaf: the first moments' difference and the
        # reference's; the updates' difference (new - reference) and the
        # reference's update (reference - old)
        old = dict(tree_leaves(params))
        m_sq = {k: (dist_sq(mom[k].bfloat16(), ref["m"][k]),
                    dist_sq(ref["m"][k], None)) for k in mom}
        p_sq = {k: (dist_sq(compat.local_of(t), ref["p"][k]),
                    dist_sq(ref["p"][k], compat.local_of(old[k])))
                for k, t in tree_leaves(newp)}
        whole = sum(2 * 4 * t.numel() for _, t in
                    tree_leaves(tfm.abstract_params(cfg, one)[0]))
        res[m] = {"loss": float(m1["loss"]), "loss_ref": ref["loss"],
                  "step_s": step_s,
                  "moment_bytes": dist_local_bytes(st["moments"]),
                  "moment_bytes_whole": whole,
                  "param_bytes": dist_local_bytes(newp),
                  "m_sq": m_sq, "p_sq": p_sq,
                  "collectives": compat.stats(), "peak": peak}
        say(f"dense train {m}: loss {res[m]['loss']} vs {ref['loss']}, "
            f"step {step_s:.3f}s")
        del params, newp, st, mom
        torch.cuda.empty_cache()
        dist.barrier()
    return res


def dist_fsdp_train(rank: int, device, say) -> dict:
    """grok-1-314b at full width, DIST_FSDP_LAYERS layer: one AdamW step
    on (2, 1) with FSDP of the parameters, ZeRO-2 gradient blocks and
    int8 moments (DIST_FSDP_ARCH's note), after rank 0's single-device
    forward and backward on the same parameters and batch (run first and
    freed). Returns each rank's resident parameter, moment and gradient
    bytes beside the reference plan's (``dryrun.plan_shardings``,
    ``opt_state_specs`` and ``grad_shardings`` under ``tree_shardings(...,
    zero1=True)``), the step's collectives, loss, gradient norm and
    seconds."""
    import torch
    import torch.distributed as dist
    from repro_torch.bridge import tree_from_leaves, tree_leaves
    from repro_torch.configs import ParallelConfig, ShapeConfig, registry
    from repro_torch.configs.base import TRAIN
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    full = registry.get_config(DIST_FSDP_ARCH)
    cfg = dataclasses.replace(full, n_layers=DIST_FSDP_LAYERS,
                              moe=dataclasses.replace(
                                  full.moe, capacity_factor=DIST_DROPLESS_CF))
    b, s = DIST_FSDP_BATCH, DIST_FSDP_SEQ
    shape = ShapeConfig("fsdp_train", s, b, TRAIN)
    mesh = make_mesh((DIST_WORLD, 1), ("data", "model"), device)
    fsdp = dryrun.plan_fsdp(cfg, shape, mesh)
    rt = shd.Plan(mesh, cfg, shape,
                  ParallelConfig(attn_impl="blockwise")).runtime(fsdp=fsdp)
    adamw = dataclasses.replace(dryrun.adamw_for(full), lr=DIST_TRAIN_LR,
                                warmup=1)
    gsh = ts.zero2_shardings(cfg, rt)
    rng = np.random.default_rng(SEED + 7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)),
             "loss_mask": (rng.random((b, s)) < 0.9).astype(np.float32)}
    # the single device's runtime draws the same tree (the experts in the
    # 2-D layout of the mesh's etp2d) and runs them densely
    one = tfm.ModelRuntime(tp=1, attn_impl="blockwise", moe_impl="gshard",
                           max_seq=s, moe_dp=rt.moe_dp)

    def gen():
        return torch.Generator(device=device).manual_seed(SEED + 7)

    out = {"fsdp": fsdp, "moments_dtype": adamw.moments_dtype,
           "hook": rt.moe_fn.__qualname__}
    if rank == 0:
        t0 = time.perf_counter()
        params = tfm.init_params(cfg, one, gen(), device=device)
        live = {k: t.requires_grad_() for k, t in tree_leaves(params)}
        loss, m = ts.make_loss_fn(cfg, one)(tree_from_leaves(live), {
            k: torch.as_tensor(v, device=device) for k, v in batch.items()})
        g = torch.autograd.grad(loss, list(live.values()))
        out["ref"] = {
            "loss": float(m["nll"].detach() / m["ntok"].clamp_min(1.0)),
            "grad_norm": float(opt.global_norm(dict(zip(live, g)))),
            "peak": torch.cuda.max_memory_allocated(device),
            "s": time.perf_counter() - t0}
        del params, live, loss, m, g
        torch.cuda.empty_cache()
    dist.barrier()
    say("fsdp reference")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, rt, gen(), device=device,
                             keep=rt.layout.block)
    zero = ts.zero1_plan(cfg, rt, adamw, gsh)
    state = opt.init_opt_state(params, adamw, zero=zero)
    sync()
    out["init_s"] = time.perf_counter() - t0
    shapes, pspecs = tfm.abstract_params(cfg, rt)
    psh, _ = dryrun.plan_shardings(cfg, shape, mesh, shapes, pspecs)
    ostate = opt.init_opt_state(shapes, adamw)
    osh = shd.tree_shardings(ostate, opt.opt_state_specs(pspecs, adamw),
                             mesh, zero1=True)
    out["params"] = {"resident_bytes": dist_local_bytes(params),
                     "plan_bytes": dryrun._sharded_bytes(shapes, psh),
                     "whole_bytes": sum(t.numel() * t.element_size()
                                        for _, t in tree_leaves(shapes)),
                     "fsdp_leaves": len(tfm.fsdp_cuts(cfg, rt))}
    out["moments"] = {"resident_bytes": dist_local_bytes(state["moments"]),
                      "plan_bytes": dryrun._sharded_bytes(
                          ostate["moments"], osh["moments"])}
    grad_plan = dryrun._sharded_bytes(shapes, gsh)
    seen = {}
    apply_updates = opt.apply_updates

    def spy(p, grads, *args, **kwargs):  # the gradients as they arrive
        seen["bytes"] = dist_local_bytes(grads)
        return apply_updates(p, grads, *args, **kwargs)

    compat.reset_stats()
    opt.apply_updates = spy
    try:
        sync()
        t0 = time.perf_counter()
        newp, st, m1 = ts.make_train_step(cfg, rt, adamw,
                                          grad_shardings=gsh)(params, state,
                                                              batch)
        sync()
        out["step_s"] = time.perf_counter() - t0
    finally:
        opt.apply_updates = apply_updates
    out["grads"] = {"resident_bytes": seen["bytes"], "plan_bytes": grad_plan}
    out["collectives"] = compat.stats()
    out["loss"] = float(m1["loss"])
    out["grad_norm"] = float(m1["grad_norm"])
    out["new_bytes"] = dist_local_bytes(newp) + dist_local_bytes(
        st["moments"])
    out["peak"] = torch.cuda.max_memory_allocated(device)
    say(f"fsdp step {out['step_s']:.3f}s, loss {out['loss']}")
    del params, state, newp, st
    torch.cuda.empty_cache()
    return out


def dist_fsdp_report(ranks: list, card: str) -> dict:
    """Print the FSDP leg's ``distributed fsdp`` lines of both ranks and
    check them: FSDP in the plan; each rank's parameter, moment and
    gradient bytes the plan's; no psum of a gradient over "data" (every
    psum over it a float32 scalar: the loss's sums, the norm's squares),
    the gradients reduce-scattered (``grad_scatter``); loss and gradient
    norm within DIST_TRAIN_LOSS_TOL of rank 0's single device."""
    ref = ranks[0]["fsdp_train"]["ref"]
    print(f"distributed fsdp reference (rank 0, one device, dense gshard "
          f"experts): {DIST_FSDP_ARCH} full width, reduced n_layers "
          f"{DIST_FSDP_LAYERS}, batch {DIST_FSDP_BATCH} x {DIST_FSDP_SEQ}: "
          f"loss {ref['loss']}, grad_norm {ref['grad_norm']}, peak "
          f"{ref['peak']} B, {ref['s']:.3f}s [{card}]")
    for r, res in enumerate(ranks):
        fs = res["fsdp_train"]
        coll = fs["collectives"]
        psum = coll.get("psum", {}).get("data", {"calls": 0, "bytes": 0})
        scat = coll.get("grad_scatter", {}).get("data", {"bytes": 0})
        print(f"distributed fsdp rank {r}: mesh ({DIST_WORLD}, 1), fsdp "
              f"{fs['fsdp']} ({fs['params']['fsdp_leaves']} leaves cut over "
              f"data), ZeRO-2 gradients, {fs['moments_dtype']} moments, "
              f"experts "
              f"through {fs['hook']}; parameters resident "
              f"{fs['params']['resident_bytes']} B (plan "
              f"{fs['params']['plan_bytes']} B, whole "
              f"{fs['params']['whole_bytes']} B), moments "
              f"{fs['moments']['resident_bytes']} B (plan "
              f"{fs['moments']['plan_bytes']} B), gradients "
              f"{fs['grads']['resident_bytes']} B (plan "
              f"{fs['grads']['plan_bytes']} B); new parameters and moments "
              f"{fs['new_bytes']} B; init {fs['init_s']:.3f}s, step "
              f"{fs['step_s']:.3f}s, peak {fs['peak']} B [{card}]")
        print(f"distributed fsdp rank {r}: loss {fs['loss']} (single device "
              f"{ref['loss']}), grad_norm {fs['grad_norm']} (single device "
              f"{ref['grad_norm']}); gradient reduce-scatter payload over "
              f"data {scat['bytes']} B; psum over data {psum['calls']} "
              f"calls, {psum['bytes']} B; collectives {coll}")
        check(fs["fsdp"] and fs["params"]["fsdp_leaves"] > 0,
              f"rank {r}: the FSDP leg's plan has no FSDP")
        for what in ("params", "moments", "grads"):
            check(fs[what]["resident_bytes"] == fs[what]["plan_bytes"],
                  f"rank {r} fsdp {what}: {fs[what]['resident_bytes']} B, "
                  f"the plan {fs[what]['plan_bytes']} B")
        check(psum["bytes"] <= 4 * psum["calls"] and scat["bytes"] > 0,
              f"rank {r} fsdp: a gradient psum over data ({psum}) or no "
              f"reduce-scatter ({scat})")
        for k in ("loss", "grad_norm"):
            check(abs(fs[k] - ref[k]) <= DIST_TRAIN_LOSS_TOL * abs(ref[k]),
                  f"rank {r} fsdp {k} {fs[k]} vs single device {ref[k]}")
    return {"step_s": ranks[0]["fsdp_train"]["step_s"],
            "param_bytes": ranks[0]["fsdp_train"]["params"]["resident_bytes"]}


def dist_sq(x, y) -> float:
    """sum((x - y)^2) in float64 (``y`` None: sum(x^2)), a slab of 2^26
    elements at a time, each slab moved to the card (the host's copies
    too), so no float32 copy of a whole leaf is made."""
    import torch
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else x.device
    x = x.reshape(-1)
    y = None if y is None else y.reshape(-1)
    tot = torch.zeros((), dtype=torch.float64, device=dev)
    for lo in range(0, x.numel(), 1 << 26):
        d = x[lo:lo + (1 << 26)].to(dev).float()
        if y is not None:
            d = d - y[lo:lo + (1 << 26)].to(dev).float()
        tot += (d * d).sum(dtype=torch.float64)
    return float(tot)


def tfm_moments(state) -> dict:
    """``{path: first moment}`` of a float32 AdamW state."""
    from repro_torch.bridge import tree_leaves
    return {k[:-2]: t for k, t in tree_leaves(state["moments"])
            if k.endswith("/m")}


def dist_config(cut: bool = True):
    """The phase's model config: DIST_ARCH at full width, depth cut."""
    from repro_torch.configs import registry
    cfg = registry.get_config(DIST_ARCH)
    return dataclasses.replace(cfg, n_layers=DIST_LAYERS) if cut else cfg


def distributed_rank(rank: int, tmp: str) -> None:
    """One rank of the distributed phase (a spawned process): joins the
    world through a FileStore in ``tmp``, runs ``dist_rank_body`` and
    writes its results (or its error) to ``tmp/rank{r}.json``."""
    import os
    import traceback
    # two processes share the card: segments that grow in place keep
    # either from stranding the other's free memory in cached blocks
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    path = Path(tmp) / f"rank{rank}.json"
    try:
        out["backend"] = init_world(rank, DIST_WORLD, Path(tmp) / "store",
                                    device="cuda")
        device = torch.device("cuda", torch.cuda.current_device())
        dist_rank_body(rank, device, out)
    except BaseException:
        out["error"] = traceback.format_exc()
        path.write_text(json.dumps(out, default=str))
        raise
    path.write_text(json.dumps(out, default=str))
    dist.destroy_process_group()


def distributed_phase(device, card: str):
    """grok-1-314b at full width, depth cut to DIST_LAYERS, served by two
    processes on the one card (mesh (1, 2)) through the port's
    ``distributed/``: the prefill plan's runtime (``make_moe_etp``, tokens
    sequence-sharded, a tiled all_to_all each way; flash on each rank),
    then GEN_A decode steps through the decode plan's
    (``make_flash_decode`` over the ring sharded by sequence,
    ``make_moe_replicated(expert_2d=True)``), each rank its blocks of the
    plan's dense layout. Checks: each rank holds exactly the plan's
    parameter bytes, half the ring and [1, 4, ...] expert stacks;
    decode's bytes over "model" are the dense layout's and the (m, l, o)
    combine's and the MoE's (compat's counters); 2 flash launches a rank
    in prefill, all wgmma; logits against rank 0's single-device path
    (bf16 at the cut depth, float32 on 1 layer, both at a capacity factor
    that drops nothing); the compressed reduction, the pipeline and the
    MoE hook's backward on the same two ranks; the dense legs
    (``dist_dense_report``) and the FSDP leg (``dist_fsdp_report``); both
    ranks exit 0 by DIST_DEADLINE_S."""
    import torch.multiprocessing as tmp_mp

    release()
    cfg = dist_config()
    b, ring, gen = DIST_BATCH, DIST_RING, GEN_A
    check(ring % DIST_WORLD == 0, f"ring {ring} does not shard over "
                                  f"{DIST_WORLD} ranks")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    t0 = time.perf_counter()
    ctx = tmp_mp.start_processes(distributed_rank, args=(tmp,),
                                 nprocs=DIST_WORLD, join=False,
                                 start_method="spawn")
    try:
        done = False
        while not done:
            left = DIST_DEADLINE_S - (time.perf_counter() - t0)
            check(left > 0, f"distributed phase: ranks still running after "
                            f"{DIST_DEADLINE_S} s")
            done = ctx.join(timeout=min(left, 10.0))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(timeout=30)
    wall = time.perf_counter() - t0
    ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
             for r in range(DIST_WORLD)]
    shutil.rmtree(tmp, ignore_errors=True)
    for r, res in enumerate(ranks):
        check("error" not in res, f"distributed rank {r}: {res.get('error')}")
        check(ctx.processes[r].exitcode == 0,
              f"distributed rank {r} exit code {ctx.processes[r].exitcode}")

    e, k = cfg.moe.n_experts, cfg.moe.top_k
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    # one decode step over "model", a layer: the q heads' all_gather (this
    # rank's [B, H/2, Dh], bf16), pmax of m [B, H] and psums of l [B, H]
    # and o [B, H, Dh] (float32), the attention output's psum [B, D] and
    # the MoE's psum of y [B, D] (bf16 summed in float32) and its pmean of
    # the aux loss; a step: the embedding's psum [B, D] and the logits'
    # all_gather for the greedy token (this rank's [B, V/2], float32)
    step_bytes = cfg.n_layers * (
        b * (h // DIST_WORLD) * dh * 2 + b * h * 4 * 2 + b * h * dh * 4 +
        2 * b * d * 4 + 4) + b * d * 4 + \
        b * (cfg.padded_vocab // DIST_WORLD) * 4
    pairs = sum(r["prefill"]["pairs"] for r in ranks)
    dropped = sum(r["prefill"]["dropped"] for r in ranks)
    print(f"distributed {cfg.name}: reduced n_layers "
          f"{dist_config(cut=False).n_layers} -> {cfg.n_layers} "
          f"(full width: d_model={d}, {h} q / {cfg.n_kv_heads} kv heads of "
          f"{dh}, {e} experts top-{k}, expert d_ff={cfg.expert_d_ff}, "
          f"capacity factor {cfg.moe.capacity_factor}, vocab "
          f"{cfg.vocab_size}); {DIST_WORLD} processes on the one card, mesh "
          f"(1, {DIST_WORLD}) (data, model), backend {ranks[0]['backend']}; "
          f"phase wall {wall:.3f}s [{card}]")
    print(f"distributed hooks: {ranks[0]['hooks']}")
    for r, res in enumerate(ranks):
        pp, pf, dc = res["params"], res["prefill"], res["decode"]
        print(f"distributed rank {r}: parameters resident "
              f"{pp['resident_bytes']} B (plan without FSDP "
              f"{pp['plan_bytes']} B; experts {pp['expert_bytes']} B, wi "
              f"block {pp['wi_local']} of {pp['wi_global']}), drawn"
              f"{' and served whole for the reference' if r == 0 else ''} "
              f"in {pp['init_s']:.3f}s, init peak {pp['init_peak']} B; "
              f"cache block "
              f"{res['cache']['k_local']} of {res['cache']['k_global']} "
              f"({res['cache']['bytes']} B)")
        print(f"distributed rank {r} prefill ({b} x {DIST_PROMPT}): "
              f"{pf['s']}s, flash launches {pf['flash_launches']} by route "
              f"{pf['flash_routes']}, pairs routed {pf['pairs']} dropped "
              f"{pf['dropped']}, peak {pf['peak']} B; collectives "
              f"{pf['collectives']}")
        print(f"distributed rank {r} decode ({gen} steps): {dc['s']}s, "
              f"{dc['tokens_per_s']} tokens/s, bytes over model "
              f"{dc['bytes_model']} ({dc['bytes_model'] / gen} a step, "
              f"want {step_bytes}), peak {dc['peak']} B; collectives "
              f"{dc['collectives']}; float32 1-layer peak "
              f"{res['float32_peak']} B")
        lg = res["legs"]
        print(f"distributed rank {r} legs: compressed psum_scatter/gather "
              f"rel {lg['compress_rel']} (tol 0.02), over "
              f"{DIST_COMPRESS_ROUNDS} rounds {lg['compress_rel8']} (tol "
              f"0.005), collectives {lg['compress_stats']}; pipeline "
              f"{DIST_PIPE} max |diff| {lg['pipeline_err']} (tol 1e-5), "
              f"collectives {lg['pipeline_stats']}")
    print(f"distributed capacity factor {cfg.moe.capacity_factor}: "
          f"{dropped} of {pairs} (token, choice) pairs dropped in prefill "
          f"({dropped / pairs:.6f}); prefill {ranks[0]['prefill']['s']}s, "
          f"decode {ranks[0]['decode']['tokens_per_s']} tokens/s [{card}]")
    for dtype in DIST_LOGIT_TOL:
        gaps = ranks[0][f"gaps_{dtype}"]
        worst = max(g["rel"] for g in gaps)
        depth = 1 if dtype == "float32" else cfg.n_layers
        print(f"distributed {dtype} ({depth} layers, capacity factor "
              f"{DIST_DROPLESS_CF}): two ranks vs rank 0's single-device "
              f"path, prefill and {gen} decode steps: worst rel {worst} "
              f"(tol {DIST_LOGIT_TOL[dtype]}), per step "
              f"{[round(g['rel'], 9) for g in gaps]}, argmax equal "
              f"{[g['argmax_equal'] for g in gaps]}, MoE layers routed "
              f"otherwise {[g['routing_flips'] for g in gaps]}")
        check(worst <= DIST_LOGIT_TOL[dtype],
              f"distributed {dtype} logits rel {worst} > "
              f"{DIST_LOGIT_TOL[dtype]}")
        if dtype == "float32":
            check(all(g["argmax_equal"] for g in gaps),
                  "distributed float32: greedy tokens differ")
    for dtype, tol in DIST_GRAD_TOL.items():
        bw = ranks[0]["backward"][dtype]
        worst = max(bw["rel"].items(), key=lambda kv: kv[1])
        line = (f"distributed backward: {DIST_TRAIN_ARCH} smoke config "
                f"({dtype}, batch {DIST_TRAIN_SHAPE[0]} x "
                f"{DIST_TRAIN_SHAPE[1]}, capacity factor {DIST_DROPLESS_CF})"
                f" through the train plan's layout and {bw['hook']} on mesh "
                f"(1, {DIST_WORLD}) vs rank 0's single device "
                f"({bw['hook_single']} on 1 x 1): loss "
                f"{[r['backward'][dtype]['loss'] for r in ranks]} vs "
                f"{bw['loss_single']}; worst gradient rel (norm of the "
                f"difference / norm) {worst[1]} ({worst[0]}; tol {tol}) over "
                f"{len(bw['rel'])} leaves, worst max|diff| / max "
                f"{max(bw['rel_max'].values())}")
        if "rel_f32" in bw:
            ratio = max(bw["rel_f32"].items(), key=lambda kv: kv[1] / max(
                bw["rel_f32_single"][kv[0]], 1e-30))
            r_ratio = ratio[1] / max(bw["rel_f32_single"][ratio[0]], 1e-30)
            line += (f"; from the single device's float32 gradient: worst "
                     f"{max(bw['rel_f32'].values())} (mesh) and "
                     f"{max(bw['rel_f32_single'].values())} (single "
                     f"device), worst leaf ratio {r_ratio} ({ratio[0]}; tol "
                     f"{DIST_GRAD_F32_RATIO})")
            check(r_ratio <= DIST_GRAD_F32_RATIO,
                  f"distributed backward {dtype}: {ratio[0]} stands "
                  f"{r_ratio} times as far from float32 as the single "
                  f"device's")
        print(f"{line}; the backward's collectives {bw['collectives']} "
              f"[{card}]")
        check(worst[1] <= tol,
              f"distributed backward {dtype}: {worst[0]} gradient rel "
              f"{worst[1]} > {tol}")
        for r, res in enumerate(ranks):
            got = res["backward"][dtype]
            coll = got["collectives"]
            check(got["sharded"] > 0 and not got["whole_leaves"] and
                  coll.get("all_to_all", {}).get("model", {}).get(
                      "calls", 0) > 0 and "psum" in coll,
                  f"rank {r}: the {dtype} backward ran no all_to_all or "
                  f"psum over model, or held leaves whole "
                  f"({got['whole_leaves']}): {coll}")
    dense = dist_dense_report(ranks, card)
    fsdp = dist_fsdp_report(ranks, card)
    for r, res in enumerate(ranks):
        pf = res["prefill"]
        check(res["params"]["resident_bytes"] == res["params"]["plan_bytes"]
              and not res["params"]["whole_leaves"],
              f"rank {r}: {DIST_ARCH} holds {res['params']['resident_bytes']}"
              f" B of parameters, the plan {res['params']['plan_bytes']} B; "
              f"whole where the plan cuts: {res['params']['whole_leaves']}")
        check(res["dropless_dropped"] == 0,
              f"rank {r}: {res['dropless_dropped']} pairs dropped at "
              f"capacity factor {DIST_DROPLESS_CF}")
        check(res["params"]["wi_local"] ==
              [cfg.n_layers, 1, e // DIST_WORLD, d, cfg.expert_d_ff],
              f"rank {r} expert block {res['params']['wi_local']}")
        check(res["cache"]["k_local"][2] * DIST_WORLD ==
              res["cache"]["k_global"][2] == ring,
              f"rank {r} cache block {res['cache']['k_local']}")
        check(pf["flash_launches"] == cfg.n_layers and
              pf["flash_routes"].get("wgmma", 0) == cfg.n_layers,
              f"rank {r} prefill flash launches {pf['flash_launches']} "
              f"{pf['flash_routes']}, want {cfg.n_layers} by wgmma")
        check(res["decode"]["flash_launches_total"] == cfg.n_layers,
              f"rank {r}: decode launched flash")
        check(res["decode"]["bytes_model"] == gen * step_bytes,
              f"rank {r} decode bytes over model "
              f"{res['decode']['bytes_model']} != {gen} x {step_bytes}")
        lg = res["legs"]
        check(lg["compress_rel"] < 0.02 and lg["compress_rel8"] < 0.005,
              f"rank {r} compressed reduction {lg['compress_rel']} "
              f"{lg['compress_rel8']}")
        check(lg["pipeline_err"] < 1e-5,
              f"rank {r} pipeline {lg['pipeline_err']}")
    return {"ranks": ranks, "wall_s": wall, "step_bytes": step_bytes,
            "dense": dense, "fsdp": fsdp,
            "launches": {f"rank {r}": res["prefill"]["flash_launches"]
                         for r, res in enumerate(ranks)}}


def dist_dense_report(ranks: list, card: str) -> dict:
    """Print and check the dense layout's legs (``dist_dense_serve``,
    ``dist_dense_train``) of both ranks."""
    from repro_torch.configs import registry
    full = registry.get_config(DIST_DENSE_ARCH)
    cfg = dataclasses.replace(full, n_layers=DIST_DENSE_LAYERS)
    tol = DIST_LOGIT_TOL["bfloat16"]
    for r, res in enumerate(ranks):
        dn = res["dense"]
        print(f"distributed dense rank {r}: {DIST_DENSE_ARCH} full width, "
              f"reduced n_layers {full.n_layers} -> {cfg.n_layers} "
              f"({cfg.n_heads} q / "
              f"{cfg.n_kv_heads} kv heads, wq block {dn['wq_local']} of "
              f"{dn['wq_global']}): parameters resident "
              f"{dn['resident_bytes']} B (plan without FSDP "
              f"{dn['plan_bytes']} B), drawn "
              f"{'whole, then cut' if r == 0 else 'leaf by leaf'} in "
              f"{dn['init_s']:.3f}s, init peak {dn['init_peak']} B; "
              f"cache block {dn['cache']['k_local']} of "
              f"{dn['cache']['k_global']} [{card}]")
        print(f"distributed dense rank {r} prefill ({DIST_DENSE_BATCH} x "
              f"{DIST_DENSE_PROMPT}): {dn['prefill_s']}s, flash launches "
              f"{dn['flash_launches']} by route {dn['flash_routes']}, peak "
              f"{dn['prefill_peak']} B; collectives (payload and staged "
              f"bytes, by op and axis) {dn['prefill_collectives']}")
        print(f"distributed dense rank {r} decode ({GEN_A} steps, fed the "
              f"reference's tokens): {dn['decode_s']}s, "
              f"{dn['tokens_per_s']} tokens/s, peak {dn['decode_peak']} B; "
              f"collectives {dn['decode_collectives']}")
        check(dn["resident_bytes"] == dn["plan_bytes"] and
              not dn["whole_leaves"],
              f"rank {r}: {DIST_DENSE_ARCH} holds {dn['resident_bytes']} B, "
              f"the plan {dn['plan_bytes']} B; whole where the plan cuts: "
              f"{dn['whole_leaves']}")
        check(dn["wq_local"][2] * DIST_WORLD == dn["wq_global"][2],
              f"rank {r}: wq block {dn['wq_local']} of {dn['wq_global']}")
        check(dn["flash_launches"] == cfg.n_layers and
              dn["flash_routes"].get("wgmma", 0) == cfg.n_layers,
              f"rank {r} dense prefill flash launches "
              f"{dn['flash_launches']} {dn['flash_routes']}, want "
              f"{cfg.n_layers} by wgmma")
        check(dn["flash_launches_total"] == cfg.n_layers,
              f"rank {r}: dense decode launched flash")
        check(dn["cache"]["k_local"][2] * DIST_WORLD ==
              dn["cache"]["k_global"][2],
              f"rank {r} dense cache block {dn['cache']['k_local']}")
    gaps = ranks[0]["dense"]["gaps"]
    worst = max(g["rel"] for g in gaps)
    print(f"distributed dense bfloat16 ({cfg.n_layers} layers): two ranks "
          f"vs rank 0's single-device path, prefill and {GEN_A} decode "
          f"steps: worst rel {worst} (tol {tol}), per step "
          f"{[round(g['rel'], 9) for g in gaps]}, argmax equal "
          f"{[g['argmax_equal'] for g in gaps]} [{card}]")
    check(worst <= tol, f"distributed dense logits rel {worst} > {tol}")
    def rel(sq: dict):
        """(the tree's norm of the difference over the reference's, the
        leaf with the largest such share and that share)"""
        by = {k: (d / max(w, 1e-60)) ** 0.5 for k, (d, w) in sq.items()}
        worst = max(by, key=by.get)
        return (sum(d for d, _ in sq.values()) /
                max(sum(w for _, w in sq.values()), 1e-60)) ** 0.5, \
            worst, by[worst]

    for r, res in enumerate(ranks):
        for m, tr in res["dense_train"].items():
            tr["m_rel"], m_leaf, m_leaf_rel = rel(tr["m_sq"])
            tr["p_rel"], p_leaf, p_leaf_rel = rel(tr["p_sq"])
            print(f"distributed dense train rank {r} mesh {m}: "
                  f"{DIST_DENSE_ARCH} full width, {DIST_TRAIN_LAYERS} "
                  f"layers, batch {DIST_TRAIN_BATCH} x {DIST_TRAIN_SEQ}, "
                  f"lr {DIST_TRAIN_LR}: loss {tr['loss']} vs single device "
                  f"{tr['loss_ref']}; moments held {tr['moment_bytes']} B "
                  f"of {tr['moment_bytes_whole']} B; parameters "
                  f"{tr['param_bytes']} B; first moments rel (norm of the "
                  f"difference / norm, this rank's blocks) {tr['m_rel']} "
                  f"(tol {DIST_MOMENT_TOL}; worst leaf {m_leaf} "
                  f"{m_leaf_rel}),"
                  f" updates (new - old) rel {tr['p_rel']} (tol "
                  f"{DIST_UPDATE_TOL}; worst leaf {p_leaf} {p_leaf_rel}); "
                  f"step {tr['step_s']}s, "
                  f"peak {tr['peak']} B; collectives {tr['collectives']} "
                  f"[{card}]")
            check(abs(tr["loss"] - tr["loss_ref"]) <=
                  DIST_TRAIN_LOSS_TOL * abs(tr["loss_ref"]),
                  f"rank {r} dense train {m}: loss {tr['loss']} vs "
                  f"{tr['loss_ref']}")
            check(tr["m_rel"] <= DIST_MOMENT_TOL and
                  tr["p_rel"] <= DIST_UPDATE_TOL,
                  f"rank {r} dense train {m}: moments rel {tr['m_rel']}, "
                  f"updates rel {tr['p_rel']}")
            if m == "2x1":
                check(2 * tr["moment_bytes"] == tr["moment_bytes_whole"],
                      f"rank {r} dense train (2, 1): moments "
                      f"{tr['moment_bytes']} B, not half of "
                      f"{tr['moment_bytes_whole']} B (ZeRO-1)")
    return {"launches": {f"rank {r}": res["dense"]["flash_launches"]
                         for r, res in enumerate(ranks)},
            "prefill_s": ranks[0]["dense"]["prefill_s"],
            "tokens_per_s": ranks[0]["dense"]["tokens_per_s"]}


def start_dryrun_cells() -> dict:
    """Start each DRYRUN_CELLS cell of ``python -m
    repro_torch.launch.dryrun`` as a process of its own (a fake world a
    process; they touch no card), writing under a temporary directory;
    ``cli_phase`` collects them."""
    import os
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for arch, shape, mesh, extra in DRYRUN_CELLS:
        log = open(out / f"{arch}_{shape}.log", "w")
        procs[(arch, shape, mesh)] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", str(out),
             *extra], stdout=log, stderr=subprocess.STDOUT, env=env,
            cwd=str(ROOT)), log, time.perf_counter())
    return {"dir": out, "procs": procs}


def dryrun_cells(dry: dict) -> dict:
    """Wait for the dry-run cells (each by PHASE_DEADLINE_S from its
    start): rc 0, an ``ok:`` line and a JSON each; prints their summary
    lines."""
    res = {}
    try:
        for (arch, shape, mesh), (proc, log, t0) in dry["procs"].items():
            try:
                rc = proc.wait(timeout=max(
                    1.0, PHASE_DEADLINE_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = None
            wall = time.perf_counter() - t0
            log.close()
            text = (dry["dir"] / f"{arch}_{shape}.log").read_text()
            name = "2x16x16" if mesh == "multi" else "16x16"
            path = dry["dir"] / f"{arch}_{shape}_{name}.json"
            check(rc == 0 and "  ok: " in text and path.exists(),
                  f"dryrun {arch} {shape} --mesh {mesh}: rc {rc}\n"
                  f"{text[-3000:]}")
            cell = json.loads(path.read_text())
            m, r = cell["memory"], cell["roofline"]
            ok = [ln.strip() for ln in text.splitlines() if "  ok: " in ln]
            print(f"cli: repro_torch.launch.dryrun --arch {arch} --shape "
                  f"{shape} --mesh {mesh}: {ok[0]} (collected {wall:.1f}s "
                  f"after its start); plan peak {m['plan']['peak_model']} B, "
                  f"traced args {m['traced']['arg_bytes']} B peak "
                  f"{m['traced']['peak_bytes']} B; collectives "
                  f"{ {k: v['count'] for k, v in cell['collectives'].items()} }"
                  f"; dominant {r['dominant']}, useful "
                  f"{r['useful_compute_ratio']:.6f} (analytic, meta trace, "
                  f"at H100 SXM 80 GB datasheet peaks)")
            res[arch] = cell
    finally:
        stop_dryrun_cells(dry)
    return res


def stop_dryrun_cells(dry: dict) -> None:
    """Kill the dry-run cells still running, close their logs and remove
    their directory (a second call does nothing more)."""
    for proc, log, _ in dry["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    shutil.rmtree(dry["dir"], ignore_errors=True)


def cli_phase(dry: dict):
    import contextlib
    import io
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import elastic
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
                         ("arctic-480b", "gmm"),
                         *((a, "flash_attention") for a in ARCHS_SERVE)):
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
    # a node lost after step 12: the restore decodes the delta of step 10
    reset_launches()
    state = train.main(["--smoke", "--delta-ckpt", "--fault-at", "12"])
    launches = read_launches()
    check(state.recovered_at == [12] and launches["decode_tiles"] > 0,
          f"the training CLI with --fault-at 12: recovered_at "
          f"{state.recovered_at}, launches {launches}")
    print(f"cli: repro_torch.launch.train --smoke --delta-ckpt --fault-at "
          f"12: recovered_at {state.recovered_at}, loss {state.losses[0]} "
          f"-> {state.losses[-1]}, launches {launches}")
    # the elastic CLI at JAX's defaults: it raises unless the resumed loss
    # is below the first
    out = elastic.main([])
    print(f"cli: repro_torch.launch.elastic: 4 -> 2 nodes, losses "
          f"{out['losses']} then {out['losses2']}")
    cells = dryrun_cells(dry)
    grok = cells["grok-1-314b"]["collectives"]
    check(grok["all-to-all"]["count"] > 0 and
          grok["all-reduce"]["count"] > 0,
          f"dryrun grok-1-314b train_4k: collectives {grok}")
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
    # the dry-run cells touch no card: they run beside the builds and
    # the first phases, and the cli phase collects them
    dry = start_dryrun_cells()
    try:
        builds = start_builds()
        wait_builds(builds, [n for n in builds["futs"] if n != "ssd"])
        kern = run_timed(kernel_phase, device)
        gmm = run_timed(gmm_kernel_phase, device)
        codec = run_timed(codec_kernel_phase, device)
        serve_res = run_timed(serve_phase, device, card)
        wait_builds(builds, ["ssd"])
        scan = run_timed(scan_kernel_phase, device)
        rec = {arch: run_timed(recurrent_phase, device, card, arch)
               for arch in RECURRENT}
        moe = {arch: run_timed(moe_phase, device, card, arch)
               for arch in MOE}
        distributed = run_timed(distributed_phase, device, card)
        archs = {arch: run_timed(archs_phase, device, card, arch)
                 for arch in ARCHS_SERVE}
        train_res = run_timed(train_phase, device, card)
        recovery = run_timed(recovery_phase, device, card)
        fleet = run_timed(fleet_phase, device, card)
        workflow = run_timed(workflow_phase, device, card)
        run_timed(telemetry_phase, device, card, {
            "recovery": recovery["spans"],
            "fleet": fleet["telemetry"]["spans"],
            "workflow": workflow["wf_trace"]["spans"]})
        run_timed(elastic_phase, device, card,
                  recovery["saves"][2]["commit_s"])
        sanitize = run_timed(sanitize_phase, device, card)
        run_timed(cli_phase, dry)
    finally:
        stop_dryrun_cells(dry)
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
            "fleet gemma2-9b": fleet["routes"]["flash_attention"],
            **{a: r["routes"]["flash_attention"]
               for a, r in (("recurrentgemma-9b", rec["recurrentgemma-9b"]),
                            ("grok-1-314b", grok),
                            ("arctic-480b", arctic),
                            *archs.items())}},
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
        "launches_fleet": fleet["launches"]["flash_attention"],
        "launches_distributed": distributed["launches"],
        "launches_distributed_case": f"{DIST_ARCH} ({DIST_LAYERS} layers) "
                                     f"prefill {DIST_BATCH} x {DIST_PROMPT} "
                                     f"on each of {DIST_WORLD} ranks of "
                                     f"mesh (1, {DIST_WORLD}), all wgmma",
        "launches_distributed_dense": distributed["dense"]["launches"],
        "launches_distributed_dense_case":
            f"{DIST_DENSE_ARCH} ({DIST_DENSE_LAYERS} layers) prefill "
            f"{DIST_DENSE_BATCH} x "
            f"{DIST_DENSE_PROMPT} on each of {DIST_WORLD} ranks of mesh "
            f"(1, {DIST_WORLD}), its heads cut over model, all wgmma",
        "launches_fleet_case": f"the fleet's prefix prefill, gemma2-9b "
                               f"({FLEET_LAYERS} layers), batch 1 x "
                               f"{FLEET_PROMPT}",
        "launches_archs": {a: r["launches"]["flash_attention"]
                           for a, r in archs.items()},
        "arch_cases": {n: {k: kern[n][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "row_err")} for n in kern if "shape" in kern[n]},
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
        "launches_fleet_codec": fleet["codec"]["launches"]["ssd_prefill"],
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
        "launches_sanitize_copy":
            sanitize["copy"]["launches"][f"{op}_tiles"],
        "launches_sanitize_copy_case": "a float32 object made on the card "
                                       "copied through the lossy wire "
                                       "codec under the capture-mode "
                                       "sanitizer: the copy whose commit "
                                       "fails, the retried copy and the "
                                       "replica's read-back",
        "launches_fleet_codec": fleet["codec"]["launches"][f"{op}_tiles"],
        "launches_fleet_codec_case": f"{CODEC_ARCH} session through the "
                                     f"fleet's strict codec replica: "
                                     f"suspend, peek, resume",
        "launches_wire_case": f"{CODEC_ARCH} session replicas: strict "
                              f"round trips, lossy encodes, replica reads, "
                              f"a grid tree",
        "launches_recovery": {
            leg: recovery["legs"][leg]["launches"][f"{op}_tiles"]
            for leg in ("save", "restore", "repair", "second", "drain",
                        "rehydrate_leg")},
        "launches_recovery_case": "gemma2-9b (2 layers) with int8 moments "
                                  "through node losses: delta saves and "
                                  "their wire-codec replicas and drains, "
                                  "the fault restore of the delta step 4, "
                                  "repair, restores after a second loss and "
                                  "from the drain, rehydration and the "
                                  "restore after it",
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
