"""``seq_parallel``'s residual laid out over ``model`` against JAX's
GSPMD plan, on the CPU.

With ``ParallelConfig(seq_parallel=True)`` JAX's ``Plan.resid_spec``
cuts the residual stream's sequence over ``model`` in train and prefill,
and GSPMD turns each row-parallel product's all-reduce into a
reduce-scatter and gathers the sequence before each column-parallel
product. The port's ``Layout`` (its ``seq``) does the same by hand
inside its entry points.

The JAX side runs ``torch_worlds.DENSE_JAX_SIDE`` (the script of
``tests/test_torch_dense_layout.py``) with the flag, once a (mesh, arch,
sequence) case, in a subprocess with four host devices: on (2, 2)
gemma2-9b's smoke config (local and global layers, softcaps),
grok-1-314b's (``make_moe_etp`` on the sequence block) and whisper-tiny
(the encoder's residual cut, the decoder's cross-attention over the
gathered encoder output); on (1, 4) recurrentgemma-9b and mamba2-1.3b
(the RG-LRU and SSD scans on the gathered sequence) at 8 tokens, and
gemma2 at 6 tokens, which ``model`` does not divide: JAX cuts that
sequence unevenly, the port keeps the residual whole, and the values are
the same.

The port side runs the same inputs on JAX's parameters in a gloo world
of four processes a mesh (``torch_worlds.seq_parallel_cases``). Held to
JAX (float32 1e-5; whisper-tiny, whose encoder runs in bf16, 0.08): the
prefill logits and caches, four greedy decode steps fed the prefill's
caches (their logits, tokens and caches), the loss, every gradient and
every parameter after one AdamW step. Each rank's residual at every
``constrain`` site inside the entry points is its ``[B_rows, S / tp,
D]`` block (whole where ``model`` does not divide S), and no ``psum`` of
a residual over ``model`` is left in the forward passes: each is a
``psum_scatter``, with an ``all_gather`` of the block before the next
column-parallel product.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import torch_worlds
from repro_torch.distributed import sharding as shd

REPO = Path(__file__).resolve().parents[1]
#: (mesh, arch, prompt length)
PAIRS = [("2x2", "gemma2-9b", 8), ("2x2", "grok-1-314b", 8),
         ("2x2", "whisper-tiny", 8), ("1x4", "recurrentgemma-9b", 8),
         ("1x4", "mamba2-1.3b", 8), ("1x4", "gemma2-9b", 6)]
CASES = [f"{m}_{a}_s{s}" for m, a, s in PAIRS]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
#: JAX subprocesses at once (each compiles one case's programs)
JAX_JOBS = 4
#: as tests/test_torch_dense_layout.py's: float32, and whisper-tiny's bf16
#: encoder
TOLS = {"float32": 1e-5, "bfloat16": 0.08}
BF16_ARCHS = {"whisper-tiny"}


def _jax_case(tmp: Path, mesh: str, arch: str, seq: int) -> dict:
    name = f"{mesh}_{arch}_s{seq}"
    got = torch_worlds.jax_dense_pair(tmp, mesh, arch, seq_parallel=True,
                                      seq=seq, name=name)
    res = got[f"{mesh}_{arch}"]
    res.update(mesh=mesh, arch=arch)
    return {name: res}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's results, each rank's port results) of every case: JAX's
    cases ``JAX_JOBS`` at a time, each mesh's gloo world of four as soon
    as its cases are done."""
    tmp = tmp_path_factory.mktemp("seq_parallel")
    with ThreadPoolExecutor(JAX_JOBS) as jobs, \
            ThreadPoolExecutor(len(MESHES)) as worlds:
        cases = {m: [jobs.submit(_jax_case, tmp, m, a, s)
                     for m_, a, s in PAIRS if m_ == m] for m in MESHES}

        def mesh_side(m):
            ref = {}
            for f in cases[m]:
                ref.update(f.result())
            return ref, torch_worlds.run_world(
                torch_worlds.seq_parallel_cases, 4, tmp / f"port_{m}", ref)
        done = list(worlds.map(mesh_side, MESHES))
    ref, port = {}, [{} for _ in range(4)]
    for r, ranks in done:
        ref.update(r)
        for mine, got in zip(port, ranks):
            mine.update(got)
    return ref, port


@pytest.fixture(scope="module")
def jax_side(sides):
    return sides[0]


@pytest.fixture(scope="module")
def port_side(sides):
    return sides[1]


def _tol(case: str) -> float:
    return TOLS["bfloat16" if case.split("_")[1] in BF16_ARCHS
                else "float32"]


def _close(got, want, tol, rel=False, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if rel and want.size \
        else 1.0
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if want.size else 0.0
    assert err <= tol * scale, (what, err, tol * scale)


def _cut(case: str) -> bool:
    """Whether ``model`` divides the case's sequence (the residual is
    then this rank's block of it)."""
    mesh, _, seq = case.split("_")
    return int(seq[1:]) % MESHES[mesh][1] == 0


@pytest.mark.parametrize("case", CASES)
def test_serve_matches_jax(case, jax_side, port_side):
    """The prefill logits under the cut, then four greedy decode steps
    fed its caches (a MoE arch's decode plan's prefill, as JAX's): the
    logits gathered whole within the limit of JAX's on every rank, the
    greedy tokens equal (JAX's are fed), the caches after prefill and
    after the last step gathered whole within the limit."""
    ref, tol = jax_side[case], _tol(case)
    for res in port_side:
        got = res[case]
        _close(got["prefill_logits"], ref["prefill_logits"], tol)
        _close(got["decode_prefill_logits"], ref["decode_prefill_logits"],
               tol)
        for g, w in zip(got["decode_logits"], ref["decode_logits"]):
            _close(g, w, tol)
        assert len(got["greedy"]) == len(ref["decode_tokens"])
        for g, w in zip(got["greedy"], ref["decode_tokens"]):
            np.testing.assert_array_equal(g, w)
        for which in ("prefill_cache", "decode_cache"):
            assert set(got[which]) == set(ref[which])
            for k, w in ref[which].items():
                _close(got[which][k], w, tol, what=f"{which} {k}")


@pytest.mark.parametrize("case", CASES)
def test_train_step_matches_jax(case, jax_side, port_side):
    """The loss, the gradient of every parameter and every parameter
    after one AdamW step (ZeRO-1 moments), gathered whole, against JAX's
    with the flag: within the limit of the leaf's largest magnitude."""
    ref, tol = jax_side[case], _tol(case)
    for res in port_side:
        got = res[case]
        assert abs(got["loss"] - ref["loss"]) <= tol * max(1, ref["loss"])
        assert abs(got["step_loss"] - ref["step_loss"]) <= \
            tol * max(1, ref["step_loss"])
        assert set(got["grads"]) == set(ref["grads"])
        for k, w in ref["grads"].items():
            _close(got["grads"][k], w, tol, rel=True, what=k)
        for k, w in ref["new_params"].items():
            _close(got["new_params"][k], w, tol, rel=True, what=k)


@pytest.mark.parametrize("case", CASES)
def test_residual_is_the_block(case, jax_side, port_side):
    """At every ``constrain`` site inside prefill and the loss each rank's
    residual is ``[B_rows, S / tp, D]`` of a sequence of whole length S
    (the decoder's, or whisper's encoder's), whole where ``model`` does
    not divide S; the decode plan's is never cut. Outside the entry
    points the constraint hands a whole residual back as that block;
    inside them it refuses a residual that is not the block."""
    from repro_torch.configs import registry
    b, s = jax_side[case]["tokens"].shape
    d = registry.get_smoke_config(case.split("_")[1]).d_model
    dp, tp = MESHES[case.split("_")[0]]
    cut = _cut(case)
    for res in port_side:
        got = res[case]
        assert got["seq"] == {"prefill": True, "decode": False,
                              "train": True}
        assert got["dp_tp"] == (dp, tp)
        for phase in ("prefill", "loss_forward"):
            sites = got[phase]["sites"]
            assert sites, phase
            for shape, seq in sites:
                assert seq == s, (phase, seq)
                assert shape == (b // dp, s // tp if cut else s, d), \
                    (phase, shape)
        for shape, seq in got["decode"]["sites"]:  # and a MoE arch's
            # prefill through the decode plan: no cut there either
            assert shape == (b // dp, seq, d) and seq in (1, s), (shape,
                                                                  seq)
        assert got["resid_outside"] == (b // dp, s // tp if cut else s, d)
        if cut:
            assert "a residual of %d positions where the layout holds %d" \
                % (s, s // tp) in got["refused"]
        else:
            assert got["refused"] is None


@pytest.mark.parametrize("case", CASES)
def test_model_collectives(case, jax_side, port_side):
    """The forward passes (prefill, the loss) under the cut move no
    ``psum`` of a residual over ``model``: each row-parallel sum is a
    ``psum_scatter`` of the whole sequence's ``[B_rows, S, D]`` partial
    sums, each gather an ``all_gather`` of the ``[B_rows, S / tp, D]``
    block (or of the last row before the prefill's head), a gather for
    each scatter but the embedding's; none where ``model`` does not
    divide S, where the psums stay."""
    from repro_torch.configs import registry
    arch = case.split("_")[1]
    cfg = registry.get_smoke_config(arch)
    b, s = jax_side[case]["tokens"].shape
    dp, tp = MESHES[case.split("_")[0]]
    rows, d = b // dp, cfg.d_model
    for res in port_side:
        for phase in ("prefill", "loss_forward"):
            ops = [(op, shape) for op, axis, shape in res[case][phase]["ops"]
                   if axis == "model" and len(shape) == 3 and
                   shape[-1] == d]
            psums = [sh for op, sh in ops if op == "psum"]
            scatters = [sh for op, sh in ops if op == "psum_scatter"]
            gathers = [sh for op, sh in ops if op == "all_gather"]
            if not _cut(case):
                assert psums and not scatters and not gathers, ops
                continue
            assert not psums, (phase, psums)
            # the payloads as compat hands them over: the scattered or
            # gathered dim (the sequence) first
            assert scatters and all(sh == (s, rows, d)
                                    for sh in scatters), scatters
            blocks = [sh for sh in gathers if sh == (s // tp, rows, d)]
            last = [sh for sh in gathers if sh == (1, rows, d)]
            assert len(blocks) + len(last) == len(gathers), gathers
            assert len(last) == (phase == "prefill"), gathers
            # each cut sublayer gathers its input and scatters its output;
            # the embedding scatters only (a sublayer the layout leaves
            # whole, or the MoE hook's, gathers only or moves nothing)
            assert len(blocks) >= len(scatters) - 1, (len(blocks),
                                                      len(scatters))


def test_plan_layout_cuts_the_sequence_in_train_and_prefill():
    """``Plan.layout`` carries ``resid_spec``'s ``model`` entry: with
    ``seq_parallel`` in train and prefill on a mesh with a model axis,
    never in decode, on a mesh without one or without the flag; a layout
    cuts a sequence only where ``model`` divides it."""
    from repro_torch.configs import ParallelConfig, ShapeConfig, registry
    from repro_torch.launch import mesh as tmesh
    cfg = registry.get_smoke_config("gemma2-9b")
    for shape, kind, sp, want in (((2, 2), "train", True, True),
                                  ((2, 2), "prefill", True, True),
                                  ((2, 2), "decode", True, False),
                                  ((2, 2), "train", False, False),
                                  ((4, 1), "train", True, False)):
        plan = shd.Plan(tmesh.Mesh(shape, ("data", "model")), cfg,
                        ShapeConfig(kind, 64, 8, kind),
                        ParallelConfig(seq_parallel=sp))
        assert plan.layout().seq is want, (shape, kind, sp)
        assert (plan.resid_spec()[1] == "model") is \
            (sp and kind != "decode")
        rt = plan.runtime()
        assert rt.layout.seq is want
        assert rt.layout.cuts_seq(64) is want
        assert rt.layout.cuts_seq(7) is False


DRYRUN_CELL = r"""
import json, sys
from repro_torch.configs import ShapeConfig, base, registry
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
arch, kind = sys.argv[1], sys.argv[2]
dryrun.init_fake_world(4)
out = {}
for sp in (False, True):
    res = dryrun.build_and_trace(
        arch, kind, False, base.ParallelConfig(seq_parallel=sp), 1,
        shape=ShapeConfig(kind, 64, 8, kind),
        mesh=make_mesh((2, 2), ("data", "model"), "cpu"), mesh_name="2x2",
        cfg=registry.get_smoke_config(arch))
    out[str(sp)] = {"peak": res["memory"]["traced"]["peak_bytes"],
                    "held": res["held"]["traced"],
                    "seq_parallel": res["seq_parallel"],
                    "collectives": {k: v["count"] for k, v in
                                    res["collectives"].items()}}
print(json.dumps(out))
"""


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_dryrun_seq_parallel_peak_falls(kind):
    """gemma2's smoke cell traced on a fake world of four at (2, 2), with
    and without ``--seq-parallel``: with it the traced peak falls, the
    parameter and optimizer-state bytes a rank holds are equal, and the
    all-reduces over the residual become reduce-scatters and
    all-gathers."""
    import json
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    p = subprocess.run([sys.executable, "-c", DRYRUN_CELL, "gemma2-9b",
                        kind], capture_output=True, text=True, timeout=300,
                       env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    off, on = res["False"], res["True"]
    assert on["seq_parallel"] and not off["seq_parallel"]
    assert on["peak"] < off["peak"], (on["peak"], off["peak"])
    assert on["held"] == off["held"]
    assert off["collectives"]["reduce-scatter"] < \
        on["collectives"]["reduce-scatter"]
    assert on["collectives"]["all-reduce"] < \
        off["collectives"]["all-reduce"]
