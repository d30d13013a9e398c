"""Configuration dataclasses for models (copy of ``repro/configs/base.py``).

Every architecture is a ``ModelConfig`` built out of a repeating block
pattern of (mixer, mlp) layer specs. The port keeps its own copy so that it
imports nothing of the JAX package; the fields and derived properties are
the same, so one config describes the same model in both packages.
``ShapeConfig``, the dry run's shape table ``SHAPES``, ``ParallelConfig``
and ``RunConfig`` are JAX's, field for field. Of ``ParallelConfig`` the
port reads what JAX's plan reads: ``attn_impl``, ``remat``, ``ce_chunk``
and ``seq_parallel`` (``sharding.Plan.resid_spec``; its ``model`` cut is
not laid out yet: ROADMAP item 13 (c)); the mesh is ``launch/mesh.py``'s
own, the optimizer state always ZeRO-1 on a mesh, and FSDP of the
parameters and ZeRO-2 of the gradients the caller's choice, as JAX's
``in_shardings`` and ``grad_shardings`` are (``Plan.runtime(fsdp=)``,
``train_step.make_train_step(grad_shardings=)``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# mixer kinds
ATTN_GLOBAL = "attn_global"      # full (causal for decoder) attention
ATTN_LOCAL = "attn_local"        # sliding-window attention
RGLRU = "rglru"                  # RG-LRU recurrent block (RecurrentGemma)
SSD = "ssd"                      # Mamba2 state-space-duality block

# mlp kinds
MLP_GELU = "gelu"                # plain 2-matmul MLP
MLP_SWIGLU = "swiglu"            # gated 3-matmul MLP (llama-style)
MLP_GEGLU = "geglu"              # gated with gelu (gemma-style)
MLP_MOE = "moe"                  # mixture-of-experts FFN
MLP_NONE = "none"                # no MLP (mamba2 blocks are mixer-only)


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = ATTN_GLOBAL
    mlp: str = MLP_SWIGLU
    # MoE-with-parallel-dense-residual (snowflake-arctic style)
    dense_residual: bool = False


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    d_ff: int = 0                 # expert hidden size (0 -> ModelConfig.d_ff)
    router_softcap: float = 30.0  # grok-style router logit cap (0 = off)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64            # P
    n_groups: int = 1             # B/C groups
    conv_width: int = 4
    chunk_size: int = 256
    expand: int = 2               # d_inner = expand * d_model


@dataclass(frozen=True)
class RGLRUConfig:
    width: int = 0                # recurrent width (0 -> d_model)
    conv_width: int = 4
    block_width: int = 256        # kernel scan block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    # attention details
    window: int = 4096            # sliding window for ATTN_LOCAL
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    linear_bias: bool = False     # biases on all projections
    attn_softcap: float = 0.0     # gemma2: 50.0
    final_softcap: float = 0.0    # gemma2: 30.0
    post_norms: bool = False      # gemma2 sandwich norms
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    # multimodal prefix stub (vlm / audio frontends)
    prefix_len: int = 0           # precomputed embeddings prepended to tokens
    # numerics
    param_dtype: str = "bfloat16"
    # vocab padding granularity for TP
    vocab_pad_to: int = 256
    # whether long_500k applies (sub-quadratic decoders only)
    subquadratic: bool = False
    tie_embeddings: bool = False  # documented deviation: we always untie

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        g = self.vocab_pad_to
        return (self.vocab_size + g - 1) // g * g

    def padded_heads(self, model_par: int) -> int:
        """Q heads zero-padded up to a multiple of the TP degree."""
        return (self.n_heads + model_par - 1) // model_par * model_par

    @property
    def groups(self) -> Tuple[Tuple[Tuple[LayerSpec, ...], int], ...]:
        """Split n_layers into (period, repeats) + optional tail period."""
        p = len(self.pattern)
        reps, tail = divmod(self.n_layers, p)
        out = []
        if reps:
            out.append((tuple(self.pattern), reps))
        if tail:
            out.append((tuple(self.pattern[:tail]), 1))
        return tuple(out)

    def param_count(self, model_par: int = 1, padded: bool = False) -> int:
        """Analytic parameter count (untied embeddings), the JAX formula
        as it is: it leaves out the RG-LRU gates ``bd_a``/``bd_x`` and
        the SSD ``norm_w``, and counts two norms for every layer, mamba2's
        mixer-only ones included (ROADMAP Queue C). A MoE layer counts
        its ``n_experts`` SwiGLU experts and its router, a dense residual
        one more SwiGLU MLP of ``d_ff``. An encoder-decoder adds its
        encoder layers (attention, a two-matrix MLP, two norms) and each
        decoder layer's cross-attention and its norm; neither formula
        counts biases, learned positions or the final norms. With
        ``padded``, the heads padded to a multiple of ``model_par`` and the
        padded vocabulary are counted (the materialised parameters)."""
        d, dh = self.d_model, self.resolved_head_dim
        hq = self.padded_heads(model_par) if padded else self.n_heads
        v = self.padded_vocab if padded else self.vocab_size
        total = 2 * v * d
        nm = {MLP_GELU: 2, MLP_SWIGLU: 3, MLP_GEGLU: 3, MLP_NONE: 0}
        attn = 2 * d * hq * dh + 2 * d * self.n_kv_heads * dh
        if self.enc_dec:
            total += self.n_enc_layers * (attn + 2 * d * self.d_ff + 2 * d)
            total += self.n_layers * (attn + d)
        for period, reps in self.groups:
            for s in period:
                if s.mixer in (ATTN_GLOBAL, ATTN_LOCAL):
                    mix = attn
                elif s.mixer == RGLRU:
                    w = self.rglru.width or d
                    mix = 2 * d * w + w * d + w * self.rglru.conv_width + \
                        3 * w
                elif s.mixer == SSD:
                    sc = self.ssm
                    dinner = sc.expand * d
                    h = dinner // sc.head_dim
                    gn = 2 * sc.n_groups * sc.d_state
                    mix = d * (2 * dinner + gn + h) + \
                        (dinner + gn) * sc.conv_width + 2 * h + dinner * d
                else:
                    raise NotImplementedError(
                        f"param_count does not cover {s} (ROADMAP Queue A: "
                        f"other mixers and archs)")
                if s.mlp == MLP_MOE:
                    e = self.moe.n_experts
                    mlp = e * 3 * d * self.expert_d_ff + d * e
                else:
                    mlp = nm[s.mlp] * d * self.d_ff
                if s.dense_residual:
                    mlp += 3 * d * self.d_ff
                total += reps * (mix + mlp + 2 * d)
        return int(total)

    @property
    def expert_d_ff(self) -> int:
        """A MoE expert's hidden size (``MoEConfig.d_ff``, else d_ff)."""
        return self.moe.d_ff or self.d_ff

    def active_param_count(self) -> int:
        """Parameters a token uses: a MoE layer's ``top_k`` experts of
        ``n_experts`` (the JAX formula)."""
        if self.moe is None:
            return self.param_count()
        n_moe = sum(reps for period, reps in self.groups for s in period
                    if s.mlp == MLP_MOE)
        inactive = n_moe * (self.moe.n_experts - self.moe.top_k) * 3 * \
            self.d_model * self.expert_d_ff
        return int(self.param_count() - inactive)


# ---------------------------------------------------------------------------
# Shapes and parallelism
# ---------------------------------------------------------------------------

TRAIN, PREFILL, DECODE = "train", "prefill", "decode"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == DECODE


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, TRAIN),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, PREFILL),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, DECODE),
    "long_500k": ShapeConfig("long_500k", 524288, 1, DECODE),
}


# ---------------------------------------------------------------------------
# Run / parallelism config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelConfig:
    dp: int = 1                   # data axis
    tp: int = 1                   # model axis
    pods: int = 1                 # pod axis (DP by default, PP optional)
    pod_role: str = "dp"          # dp | pp
    seq_parallel: bool = False    # shard residual stream on seq over model
    microbatches: int = 1         # gradient-accumulation splits
    remat: str = "block"          # none | block (remat each layer body)
    zero1: bool = True            # shard optimizer moments over dp
    grad_compression: str = "none"  # none | int8ef
    moe_impl: str = "etp"         # etp | gshard (dense fallback)
    attn_impl: str = "blockwise"  # naive | blockwise | pallas | interpret
    ce_chunk: int = 512           # chunked cross-entropy sequence block


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig = ParallelConfig()
    seed: int = 0
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    opt_moments_dtype: str = "float32"   # float32 | int8 (blockwise-quantized)
    master_weights: bool = False
