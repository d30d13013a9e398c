"""The comparison that decides ``correct``, and its control.

What is compared is what the timed path produced for a sample, drawn
from the seed, of the requests the window finished (``Sampler``, with
the longest prompt among them): the tokens the engine served and the
session state it held after them. The plain float32 reference
(``reference/lm.py``) runs over each sampled prompt followed by its
served tokens, once the window has closed and the program's state is
freed, and gives these numbers (a cell compares those its
``limits/<cell>.json`` names):

  * ``state_err``: the worst layer and leaf of the held state (the
    attention layers' K and V rings over the positions written, the SSD
    layers' float32 state ``h`` and conv window; each mixer kind says how
    its leaves are cut), of the median over rows and positions of a
    position's relative error: the median, because a token that the bf16
    router sends to another expert than the float32 reference's (a
    difference that rounding alone decides) moves its own K and V by tens
    of percent in the later layers;
  * ``state_err_p90``: the same with the 90th percentile in place of the
    median, so that a fault confined to a minority of the rows or
    positions shows (where a request holds one vector a layer, as an SSD
    prefill does, both are that vector's error);
  * ``token_gap``: the widest gap by which a served token's reference
    logit lies below the reference's best logit at its position;
  * the mixer kinds' exact counts, such as ``kpos_mismatch`` (attention):
    ring slots whose recorded position is not the position written there
    (limit 0).

The control puts the reference in the program's place with every
projection's weights rounded to float8 e4m3, one scale an output channel
(``fp8_weights``): it reads ``state_err`` and ``state_err_p90`` on its
own state, and ``token_gap`` at the positions the program served (the
same statistic as the program's), for the token the control puts first.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import kinds
from portbench.reference import lm

#: positions a block of the head's logits
HEAD_BLOCK = 1024


class Sampler:
    """A seeded reservoir of ``k`` finished requests, plus the longest
    prompt finished, each with its prompt, its served tokens and the
    engine's state after them (the cache the engine held, by reference;
    of a batch, ``rows`` rows drawn from the seed, copied)."""

    def __init__(self, k: int, seed: int, batch: int, rows: int = 0):
        self.k = k
        self.rng = np.random.default_rng([int(seed) % 2 ** 64, 0x5A3])
        self.rows = None
        if rows and rows < batch:
            self.rows = np.sort(self.rng.choice(batch, rows, replace=False))
        self.slots: List[dict] = []
        self.longest: Optional[dict] = None
        self.seen = 0

    def _hold(self, i, prompt, served, cache) -> dict:
        from portbench.weights import flat_leaves
        state = flat_leaves(cache)
        if self.rows is not None:
            idx = torch.as_tensor(self.rows, device=next(
                iter(state.values())).device)
            state = {n: t.index_select(1, idx) for n, t in state.items()}
            prompt, served = prompt[self.rows], served[self.rows]
        return {"i": i, "prompt": prompt, "served": served, "state": state}

    def offer(self, i: int, prompt: np.ndarray, served: np.ndarray,
              cache) -> None:
        self.seen += 1
        held = None
        if len(self.slots) < self.k:
            held = self._hold(i, prompt, served, cache)
            self.slots.append(held)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                held = self._hold(i, prompt, served, cache)
                self.slots[j] = held
        if self.longest is None or \
                prompt.shape[1] > self.longest["prompt"].shape[1]:
            self.longest = held or self._hold(i, prompt, served, cache)

    def samples(self) -> List[dict]:
        out = {s["i"]: s for s in self.slots}
        if self.longest is not None:
            out[self.longest["i"]] = self.longest
        return [out[i] for i in sorted(out)]


def fp8_weights(w: torch.Tensor) -> torch.Tensor:
    """w [in, out] float32 rounded to float8 e4m3, one scale a column."""
    scale = w.abs().amax(0, keepdim=True).clamp_min(1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sequence(sample: dict, device) -> torch.Tensor:
    """The prompt followed by every served token but the last (which no
    position consumed)."""
    seq = np.concatenate([sample["prompt"], sample["served"][:, :-1]], 1)
    return torch.as_tensor(seq, dtype=torch.long, device=device)


def _state_err(cfg: dict, prog: Dict[str, torch.Tensor],
               ref: Dict[str, torch.Tensor], length: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each layer's worst leaf, of the median and of the 90th percentile
    over rows and positions of each position's relative error (a ring's
    slot, a row's recurrent state or conv window, as the layer's mixer
    kind cuts its leaves: the norm of the program's vector minus the
    reference's over the reference's norm)."""
    mixers = {f"group0/p{i}/": mixer for i, mixer, _ in kinds.layers(cfg)}
    worst = worst90 = None
    for name, r in ref.items():
        pre = name[:name.index("/", len("group0/")) + 1]
        pv, rv = kinds.held(mixers[pre], name, prog[name], r, length)
        rel = (pv.float() - rv).norm(dim=-1) / \
            rv.norm(dim=-1).clamp_min(1e-30)
        rel = rel.flatten(1)
        med = rel.median(dim=1).values
        p90 = torch.quantile(rel, 0.9, dim=1)
        worst = med if worst is None else torch.maximum(worst, med)
        worst90 = p90 if worst90 is None else torch.maximum(worst90, p90)
    return worst.cpu(), worst90.cpu()


def _merge(out: dict, layers: Tuple[torch.Tensor, torch.Tensor]) -> None:
    """Fold one sample's per-layer errors into ``state_err`` and
    ``state_err_p90`` (the worst layer's) and ``state_err_layers`` (the
    first, middle and last layer's median, shown beside them)."""
    med, p90 = layers
    out["state_err"] = max(out["state_err"], float(med.max()))
    out["state_err_p90"] = max(out["state_err_p90"], float(p90.max()))
    pick = [float(med[i]) for i in (0, len(med) // 2, -1)]
    old = out.get("state_err_layers", [0.0] * 3)
    out["state_err_layers"] = [max(a, b) for a, b in zip(old, pick)]


def _exact(cfg: dict, prog: Dict[str, torch.Tensor], length: int,
           out: dict) -> None:
    """Add each mixer kind's exact counts of the held state (such as
    ``kpos_mismatch``) to ``out``."""
    for i, mixer, _ in kinds.layers(cfg):
        pre = f"group0/p{i}/"
        mine = {n: t for n, t in prog.items() if n.startswith(pre)}
        for name, n in kinds.exact(mixer, mine, length).items():
            out[name] = out.get(name, 0) + n


def _gaps(params, cfg, hidden, want_tokens=None, other=None, quant=None):
    """The widest gap of the chosen tokens below the reference's best.
    ``hidden`` [R, T, D] is the reference's; the chosen tokens are
    ``want_tokens`` [R, T], or the argmax of ``other``'s (the control's
    hidden, read through the head with ``quant``)."""
    widest = 0.0
    r, t, _ = hidden.shape
    for t0 in range(0, t, HEAD_BLOCK):
        ref = lm.logits(params, cfg, hidden[:, t0:t0 + HEAD_BLOCK])
        if want_tokens is not None:
            tok = want_tokens[:, t0:t0 + HEAD_BLOCK]
        else:
            tok = lm.logits(params, cfg, other[:, t0:t0 + HEAD_BLOCK],
                            quant).argmax(-1)
        gap = ref.max(-1).values - ref.gather(-1, tok[..., None])[..., 0]
        widest = max(widest, float(gap.max()))
        del ref
    return widest


def _zero() -> Dict[str, float]:
    return {"state_err": 0.0, "state_err_p90": 0.0, "token_gap": 0.0}


def program_readings(params, cfg: dict, samples: List[dict], device
                     ) -> Dict[str, float]:
    """The numbers of the program's sampled requests."""
    no_tf32()
    out = _zero()
    least: Dict[str, float] = {}
    with torch.no_grad():
        for smp in samples:
            seq = _sequence(smp, device)
            s = smp["prompt"].shape[1]
            hidden, state, stats = lm.forward(params, cfg, seq)
            served = torch.as_tensor(smp["served"], dtype=torch.long,
                                     device=device)
            out["token_gap"] = max(out["token_gap"], _gaps(
                params, cfg, hidden[:, s - 1:], want_tokens=served))
            _merge(out, _state_err(cfg, smp["state"], state, seq.shape[1]))
            _exact(cfg, smp["state"], seq.shape[1], out)
            for name, v in stats.items():
                least[name] = min(least.get(name, v), v)
            del hidden, state
    out.update(least)
    return out


def control_readings(params, cfg: dict, samples: List[dict], device
                     ) -> Dict[str, float]:
    """The same numbers of the control (the reference with float8
    weights) on the same prompts and served tokens: its own state, and
    at the positions the program served, the gap of the token it puts
    first."""
    no_tf32()
    out = _zero()
    with torch.no_grad():
        for smp in samples:
            seq = _sequence(smp, device)
            s = smp["prompt"].shape[1]
            hidden, state, _ = lm.forward(params, cfg, seq)
            c_hidden, c_state, _ = lm.forward(params, cfg, seq, fp8_weights)
            _merge(out, _state_err(cfg, c_state, state, seq.shape[1]))
            out["token_gap"] = max(out["token_gap"], _gaps(
                params, cfg, hidden[:, s - 1:], other=c_hidden[:, s - 1:],
                quant=fp8_weights))
            del hidden, state, c_hidden, c_state
    return out


def judge(readings: Dict[str, float], limits: Dict[str, dict]
          ) -> Tuple[bool, Dict[str, dict]]:
    """Each compared number beside its limit; correct when none exceeds
    it (a number the limits file names but the readings lack fails)."""
    checks, ok = {}, True
    for name, lim in limits.items():
        value = readings.get(name)
        limit = lim["limit"]
        good = value is not None and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
