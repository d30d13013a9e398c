"""The serve path's host spans (``repro_torch.obs.spans``) on the CPU.

With no profiler recording, a span enters no ``record_function`` range
and the engine's tokens are those of a run under the profiler. Under
``torch.profiler``, a tiny MoE-attention model and a tiny SSD model,
served through ``ServeEngine`` on the plain routes, export
``user_annotation`` ranges with the spans' names, nested as the program
nests them: a request's spans inside its ``serve.*`` span, one
``model.step`` a forward, one mixer span a layer and forward, the MoE's
``moe.*`` spans inside ``model.mlp.moe``. The watchdog's wait records
``sync.wait``, and the spans run inside the distributed ``Layout.run``
path too.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import watchdog
from repro_torch.models import transformer as T
from repro_torch.obs import spans
from repro_torch.serve.engine import ServeEngine

B, PROMPT, GEN, MAX_SEQ = 2, 12, 3, 32


def _engine(arch):
    cfg = registry.get_smoke_config(arch)
    rt = T.ModelRuntime(tp=1, max_seq=MAX_SEQ, remat=False)
    params = T.init_params(cfg, rt, torch.Generator().manual_seed(0),
                           device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return ServeEngine(cfg, rt, params, device="cpu"), prompts


def _serve(eng, prompts):
    first = eng.prefill(prompts)
    return first, eng.decode(first, GEN)


def _ranges(prof, tmp_path):
    """The ``user_annotation`` ranges of an exported trace: (name, start,
    end, thread)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("tid")) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(inner, outer) -> bool:
    return inner[3] == outer[3] and outer[1] <= inner[1] and \
        inner[2] <= outer[2]


def _within(ranges, outer, name):
    return [r for r in ranges if r[0] == name and _inside(r, outer)]


def _profiled(arch, tmp_path):
    eng, prompts = _engine(arch)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = _serve(eng, prompts)
    return eng, out, _ranges(prof, tmp_path)


def test_without_a_profiler_no_range_is_entered(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert spans.span(spans.STEP) is spans.span(spans.SYNC_WAIT)
    for arch in ("grok-1-314b", "mamba2-1.3b"):
        _serve(*_engine(arch))
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span(spans.STEP):
            pass
    assert entered == [spans.STEP]


def test_the_names_are_fixed_and_in_their_namespaces():
    assert len(set(spans.NAMES)) == len(spans.NAMES)
    assert all(n.startswith(spans.NAMESPACES) for n in spans.NAMES)
    assert "model.mlp.none" not in spans.NAMES
    assert {"model.mixer.ssd", "model.mixer.attn_global",
            "model.mlp.moe"} <= set(spans.NAMES)


def test_moe_attention_spans_nest_as_the_program_does(tmp_path):
    eng, (first, toks), ranges = _profiled("grok-1-314b", tmp_path)
    ours = [r for r in ranges if r[0].startswith(spans.NAMESPACES)]
    assert {r[0] for r in ours} <= set(spans.NAMES)
    (pre,) = [r for r in ranges if r[0] == spans.SERVE_PREFILL]
    (dec,) = [r for r in ranges if r[0] == spans.SERVE_DECODE]
    layers = eng.cfg.n_layers
    (step,) = _within(ranges, pre, spans.STEP)
    assert len(_within(ranges, step, spans.EMBED)) == 1
    mixers = _within(ranges, step, "model.mixer.attn_global")
    mlps = _within(ranges, step, "model.mlp.moe")
    assert len(mixers) == len(mlps) == layers
    for mlp in mlps:
        # the top_k expansion and the sort by expert; the unsort and the
        # gate-weighted sum
        assert len(_within(ranges, mlp, spans.MOE_ROUTE)) == 1
        assert len(_within(ranges, mlp, spans.MOE_SORT)) == 2
        assert len(_within(ranges, mlp, spans.MOE_UNSORT)) == 2
    assert len(_within(ranges, step, spans.CACHE)) == layers
    assert len(_within(ranges, step, spans.HEAD)) == 2  # norm, lm_head
    # the read-back of the first token waits through the watchdog only on
    # the card; the CPU's read-back is the tensor itself
    assert _within(ranges, pre, spans.SYNC_WAIT) == []
    steps = _within(ranges, dec, spans.STEP)
    assert len(steps) == GEN
    for s in steps:
        assert len(_within(ranges, s, "model.mixer.attn_global")) == layers
        assert len(_within(ranges, s, "model.mlp.moe")) == layers
        assert len(_within(ranges, s, spans.HEAD)) == 1
        # an attention layer writes its ring inside its mixer
        assert _within(ranges, s, spans.CACHE) == []
    assert toks.shape == (B, GEN + 1)


def test_ssd_spans_one_mixer_and_one_state_write_a_layer(tmp_path):
    eng, _, ranges = _profiled("mamba2-1.3b", tmp_path)
    layers = eng.cfg.n_layers
    (pre,) = [r for r in ranges if r[0] == spans.SERVE_PREFILL]
    (dec,) = [r for r in ranges if r[0] == spans.SERVE_DECODE]
    (step,) = _within(ranges, pre, spans.STEP)
    assert len(_within(ranges, step, "model.mixer.ssd")) == layers
    assert len(_within(ranges, step, spans.CACHE)) == layers
    assert not any(r[0].startswith(("model.mlp.", "moe.")) for r in ranges)
    steps = _within(ranges, dec, spans.STEP)
    assert len(steps) == GEN
    for s in steps:
        assert len(_within(ranges, s, "model.mixer.ssd")) == layers
        assert len(_within(ranges, s, spans.CACHE)) == layers
        assert len(_within(ranges, s, spans.EMBED)) == 1


@pytest.mark.parametrize("arch", ["grok-1-314b", "mamba2-1.3b"])
def test_spans_change_no_token(arch):
    plain = _serve(*_engine(arch))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _serve(*_engine(arch))
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)


class _Event:
    def __init__(self, polls):
        self.left = polls

    def query(self):
        self.left -= 1
        return self.left < 0


def test_the_watchdog_s_wait_records_sync_wait(tmp_path):
    now = [0.0]

    def sleep(s):
        now[0] += s

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        waited = watchdog.wait_event(_Event(3), clock=lambda: now[0],
                                     sleep=sleep)
        # a wait past the deadline raises with its span closed
        with pytest.raises(watchdog.KernelTimeout):
            watchdog.wait_event(_Event(10 ** 9), clock=lambda: now[0],
                                sleep=sleep)
    assert waited == pytest.approx(sum(watchdog.POLL_S * 2 ** i
                                       for i in range(3)))
    names = [r[0] for r in _ranges(prof, tmp_path)]
    assert names.count(spans.SYNC_WAIT) == 2


def layout_case(rank, world, tmp):
    """grok-1's smoke model on a (1, 2) mesh: a prefill and two decode
    steps through ``Layout.run``, without and then under the profiler;
    the span names recorded and whether the logits agree."""
    import dataclasses

    from repro_torch.configs import ParallelConfig, ShapeConfig
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    cfg = registry.get_smoke_config("grok-1-314b")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32))
    rt = dataclasses.replace(
        shd.Plan(mesh, cfg, ShapeConfig("d", MAX_SEQ, B, "decode"),
                 ParallelConfig()).runtime(), attn_impl="blockwise")
    whole = T.init_params(cfg, dataclasses.replace(rt, layout=None),
                          torch.Generator().manual_seed(0), device="cpu")

    def run():
        params = rt.layout.shard(whole, T.param_specs(cfg, rt))
        with torch.no_grad():
            lg, cache = T.prefill(params, cfg, rt, tokens)
            out = [compat.to_replicated(lg, mesh)]
            tok = out[0].argmax(-1).to(torch.int32)
            for i in range(2):
                lg, cache = T.decode_step(params, cfg, rt, cache, tok,
                                          PROMPT + i)
                out.append(compat.to_replicated(lg, mesh))
                tok = out[-1].argmax(-1).to(torch.int32)
        return [compat.local_of(t).float().numpy() for t in out]

    plain = run()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = run()
    path = tmp / f"trace{rank}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation"]
    return {"same": all(np.array_equal(a, b)
                        for a, b in zip(plain, traced)),
            "steps": names.count(spans.STEP),
            "names": sorted(set(names) & set(spans.NAMES))}


def test_spans_run_inside_the_layout(tmp_path):
    import torch_worlds
    res = torch_worlds.run_world(layout_case, 2, tmp_path)
    for r in res:
        assert r["same"]
        assert r["steps"] == 3
        assert {spans.STEP, spans.EMBED, spans.HEAD,
                "model.mixer.attn_global", "model.mlp.moe"} <= \
            set(r["names"])


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' wait and the kernels "
                    "they bracket run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_share_the_kernels_clock_on_card(cuda, tmp_path):
    """grok-1's smoke model through the kernel routes on the card: the
    read-back's ``sync.wait`` sits inside ``serve.prefill``, and the
    card's kernels of the prefill start inside it, on the same clock."""
    cfg = registry.get_smoke_config("grok-1-314b")
    rt = T.ModelRuntime(tp=1, max_seq=MAX_SEQ, remat=False)
    params = T.init_params(cfg, rt, torch.Generator(cuda).manual_seed(0),
                           device=cuda)
    eng = ServeEngine(cfg, rt, params, device=cuda)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    _serve(eng, prompts)  # builds and loads the kernels
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _serve(eng, prompts)
    path = tmp_path / "card.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
               e.get("tid")) for e in events if e.get("ph") == "X" and
              e.get("cat") == "user_annotation"]
    (pre,) = [r for r in ranges if r[0] == spans.SERVE_PREFILL]
    assert len(_within(ranges, pre, spans.SYNC_WAIT)) == 1
    kernels = [e for e in events if e.get("ph") == "X" and
               e.get("cat") == "kernel"]
    inside = [e for e in kernels if pre[1] <= float(e["ts"]) <= pre[2]]
    assert any("gmm_" in e["name"] for e in inside)
    assert any("flash_attention" in e["name"] for e in inside)
