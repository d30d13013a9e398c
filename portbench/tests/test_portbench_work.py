"""The work counts against hand counts at small shapes, and the frozen
copies against the port's wrappers they were copied from."""
import pytest

from portbench import weights
from portbench.work import flash, gmm, model, peaks, ssd


def test_gmm_counts_rows_and_only_used_experts():
    f, b = gmm.work(1024, 6144, 32768, 8)
    assert f == 2 * 1024 * 6144 * 32768
    assert b == (1024 * 6144 + 1024 * 32768 + 8 * 6144 * 32768) * 2
    assert gmm.work(16, 8, 4, 1)[1] == (16 * 8 + 16 * 4 + 8 * 4) * 2
    # short prompts are bound by the weights, long ones by the operations
    assert gmm.least_seconds(1024, 6144, 32768, 8) == \
        pytest.approx(b / peaks.HBM_BYTES)
    big = gmm.work(16384, 6144, 32768, 8)
    assert gmm.least_seconds(16384, 6144, 32768, 8) == \
        pytest.approx(big[0] / peaks.BF16_FLOPS)


def test_ssd_counts_by_hand_and_against_the_f32_peak():
    f, b = ssd.work(1, 4000, 64, 64, 1, 128, 2)
    assert f == 4 * 4000 * 64 * 64 * 128
    assert b == (2 * 4000 * 64 * 64 + 2 * 4000 * 128) * 2 + \
        4 * (4000 * 64 + 64 + 64 * 64 * 128)
    assert ssd.least_seconds(1, 4000, 64, 64, 1, 128) == \
        pytest.approx(f / peaks.F32_FLOPS)


def test_the_copies_agree_with_the_port_s_wrappers():
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    assert ssd.work(2, 300, 8, 16, 2, 32, 2) == \
        ssd_ops.work(2, 300, 8, 16, 2, 32, 2)
    # every expert holding a row: the wrapper's upper bound is exact
    assert gmm.work(500, 64, 48, 4) == gmm_ops.work(500, 64, 48, 4, 2)


def test_causal_pairs():
    assert flash.visible_pairs(1) == 1
    assert flash.visible_pairs(4) == 10
    assert flash.flops(2, 4, 3, 8) == 4 * 8 * 3 * 2 * 10


TINY_MOE = {"n_layers": 1, "d_model": 4, "n_heads": 2, "n_kv_heads": 1,
            "head_dim": 2, "d_ff": 3, "vocab_size": 8, "vocab_pad_to": 8,
            "pattern": [{"mixer": "attn_global", "mlp": "moe"}],
            "moe": {"n_experts": 2, "top_k": 1}}
TINY_SSD = {"n_layers": 2, "d_model": 4, "vocab_size": 6, "vocab_pad_to": 8,
            "pattern": [{"mixer": "ssd", "mlp": "none"}],
            "ssm": {"d_state": 2, "head_dim": 2, "n_groups": 1,
                    "conv_width": 3, "expand": 2}}


def test_prefill_flops_by_hand():
    # a token: q, k, v, o 2*4*(2*2 + 2*1)*2 = 96; router 2*4*2 = 16; one
    # expert 3*2*4*3 = 72 -> 184; 3 tokens; head 2*4*8 at the last;
    # attention 4*2 (dh) * 2 heads * 6 pairs
    assert model.prefill_flops(TINY_MOE, 1, 3) == 3 * 184 + 64 + 96
    # d_inner 8, 4 heads of 2, state 2, conv channels 8 + 4 = 12:
    # in 2*4*(16 + 4 + 4) = 192, out 2*8*4 = 64, conv 2*12*3 = 72,
    # scan 4*4*2*2 = 64 -> 392 a layer
    assert model.prefill_flops(TINY_SSD, 2, 5) == 2 * (5 * 2 * 392 + 64)


def test_decode_step_moves_every_weight_and_the_state_twice():
    flops, nbytes = model.decode_step(TINY_SSD, 3, 5)
    assert flops == 3 * (2 * 392 + 2 * 4 * 8)
    leaves = weights.layout(TINY_SSD)
    wbytes = sum(
        (3 * 4 if x.path == "in_embed" else _numel(x.shape)) *
        x.dtype.itemsize for x in leaves)
    state = 2 * 3 * (4 * 4 * 2 * 2 + 2 * 2 * 12)   # h f32, conv bf16
    assert nbytes == wbytes + 2 * state


def test_attention_and_moe_decode_by_hand():
    # a row at 3 held positions: q, k, v, o 96; 4 pairs of 4*2 (dh) * 2
    # heads = 64; router 16; one expert 72; head 2*4*8 = 64
    flops, nbytes = model.decode_step(TINY_MOE, 1, 3)
    assert flops == 96 + 64 + 16 + 72 + 64
    # bytes (bf16): the embedding's row, head and final norm
    # (4 + 32 + 4); norm1, wq, wk, wv, wo (4 + 16 + 8 + 8 + 16); K and V
    # of 4 positions (2 * 1 * 2 * 4); norm2 and router (4 + 8); one of
    # the two experts' wi, wg, wo (3 * 24 / 2)
    assert nbytes == 2 * (40 + 52 + 16 + 12 + 36)
    # two rows reach both experts
    assert model.decode_step(TINY_MOE, 2, 3)[1] == \
        2 * (44 + 52 + 2 * 16 + 12 + 72)


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def test_full_size_decode_bytes_are_the_issue_s_15_6_gb():
    import json
    from portbench.tests.smokebench import PB
    cfg = json.loads((PB / "configs" / "mamba2-1.3b.json").read_text())
    _, nbytes = model.decode_step(cfg, 64, 1024)
    assert 15.0e9 < nbytes < 16.2e9
