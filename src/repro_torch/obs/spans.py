"""Host spans of the serve path, on the profiler's clock.

Each span marks where the host is inside the program: in a serve call,
in one forward, in a layer's mixer or MLP, in the MoE's routing, sort or
unsort, or waiting for the card. A span is a ``torch.profiler``
``record_function`` range, so a profiler trace holds it as a
``user_annotation`` event on the same timeline as the kernels, copies
and fills that CUPTI records: a stretch in which the card is idle can be
put down to the innermost span the host was in at the time. The engine
serves one request at a time on its thread, so the spans of a request
are those nested inside its ``serve.*`` span.

``span(name)`` enters a range only while a profiler is recording (the
profiler's own flag); otherwise it returns one shared no-op context, so
a span costs the serve path one flag read. The names are fixed
(``NAMES``), in four namespaces (``NAMESPACES``):

  * ``serve.prefill``, ``serve.decode``: a whole ``ServeEngine`` call
    (the tokens' upload, the forward(s), the argmax, the read-back);
  * ``model.step``: one forward, a prefill or a decode step;
    ``model.embed``, ``model.mixer.<kind>``, ``model.mlp.<kind>`` (the
    ``LayerSpec`` kinds; a layer with MLP kind ``none`` has none),
    ``model.cache`` (prefill's copy of a layer's cache into the stacked
    cache; decode's in-place write of a recurrent layer's state) and
    ``model.head`` (the final norm and the output projection);
  * ``moe.route``, ``moe.sort`` (the ``top_k`` expansion of the rows and
    their sort by expert), ``moe.unsort`` (the rows back in token order
    and their gate-weighted sum);
  * ``sync.wait``: a wait for the card's queued work through the
    watchdog (reads back to the host, the checkpoint writer's device
    phase).
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, MLP_GEGLU,
                                      MLP_GELU, MLP_MOE, MLP_SWIGLU, RGLRU,
                                      SSD)

NAMESPACES = ("serve.", "model.", "moe.", "sync.")

SERVE_PREFILL = "serve.prefill"
SERVE_DECODE = "serve.decode"
STEP = "model.step"
EMBED = "model.embed"
CACHE = "model.cache"
HEAD = "model.head"
MOE_ROUTE = "moe.route"
MOE_SORT = "moe.sort"
MOE_UNSORT = "moe.unsort"
SYNC_WAIT = "sync.wait"
#: ``model.mixer.<kind>`` and ``model.mlp.<kind>`` by LayerSpec kind
MIXER = {k: f"model.mixer.{k}" for k in (ATTN_GLOBAL, ATTN_LOCAL, RGLRU,
                                          SSD)}
MLP = {k: f"model.mlp.{k}" for k in (MLP_GELU, MLP_SWIGLU, MLP_GEGLU,
                                      MLP_MOE)}

NAMES = (SERVE_PREFILL, SERVE_DECODE, STEP, EMBED, *MIXER.values(),
         *MLP.values(), CACHE, HEAD, MOE_ROUTE, MOE_SORT, MOE_UNSORT,
         SYNC_WAIT)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records (the module flag ``torch.profiler`` sets), else a shared
    no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
