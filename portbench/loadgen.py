"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and makes its requests from the seed.

A mix's keys:
  * ``kind``: the loop that drives it, ``portbench/loops/<kind>.py``:
    ``prefill`` (a request is a prompt and its first token) or ``decode``
    (a request is a batch: its prefill, then ``gen_tokens`` decode steps
    in chunks of ``chunk``), each a closed loop of one client;
  * ``batch``: rows a request;
  * ``prompt_len``: ``{"dist": "loguniform", "min", "max", "levels",
    "strata"}`` or ``{"dist": "fixed", "value"}``;
  * ``gen_tokens``, ``chunk`` (decode);
  * ``sample``: how many finished requests the check compares
    (``requests``) and, for a batch, how many of its ``rows``;
  * ``trace``: the traced stretch, ``skip`` requests (or chunks) into the
    window, then ``count`` of them.

Every seed gets the same multiset of prompt lengths, in another order:
the ``levels`` quantiles of the log-uniform law, dealt in rounds that
each hold every level once. The sorted levels form ``strata`` equal
bands, and each block of ``strata`` consecutive requests holds one level
of every band, so any stretch of the stream carries nearly the same
work. Token ids are uniform over the vocabulary, drawn from (seed,
request index).
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

_ORDER, _IDS = 0x0DE7, 0x1D5


def _seed(seed: int) -> int:
    return int(seed) % 2 ** 64


class Traffic:
    def __init__(self, spec: dict, seed: int, vocab_size: int):
        self.seed = _seed(seed)
        self.vocab = vocab_size
        self.batch = int(spec.get("batch", 1))
        self.gen_tokens = int(spec.get("gen_tokens", 1))
        self.chunk = int(spec.get("chunk", self.gen_tokens))
        pl = spec["prompt_len"]
        if pl["dist"] == "fixed":
            self.levels = [int(pl["value"])]
            self.strata = 1
        elif pl["dist"] == "loguniform":
            m = int(pl["levels"])
            lo, hi = math.log(pl["min"]), math.log(pl["max"])
            self.levels = sorted(int(round(math.exp(lo + (i + 0.5) / m *
                                                    (hi - lo))))
                                 for i in range(m))
            self.strata = int(pl.get("strata", 1))
            if m % self.strata:
                raise ValueError(f"{m} levels do not split into "
                                 f"{self.strata} strata")
        else:
            raise ValueError(f"prompt_len dist {pl['dist']!r}")
        self._rounds = {}

    def _round(self, r: int) -> List[int]:
        if r not in self._rounds:
            rng = np.random.default_rng([self.seed, _ORDER, r])
            m, k = len(self.levels), self.strata
            bands = [self.levels[j * m // k:(j + 1) * m // k]
                     for j in range(k)]
            perms = [rng.permutation(len(b)) for b in bands]
            order = []
            for blk in range(m // k):
                members = [bands[j][perms[j][blk]] for j in range(k)]
                rng.shuffle(members)
                order += members
            self._rounds = {r: order}   # one round is held at a time
        return self._rounds[r]

    def length(self, i: int) -> int:
        m = len(self.levels)
        return int(self._round(i // m)[i % m])

    def prompt(self, i: int) -> np.ndarray:
        """Request ``i``'s prompt ids, [batch, length] int32."""
        rng = np.random.default_rng([self.seed, _IDS, i])
        return rng.integers(0, self.vocab, size=(self.batch, self.length(i)),
                            dtype=np.int32)

    def warmup_lengths(self) -> List[int]:
        """The shortest and the longest prompt of the mix."""
        return sorted({self.levels[0], self.levels[-1]})
