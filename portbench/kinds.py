"""The model's parts, found by name.

A configuration's ``pattern`` names each layer's ``mixer`` and ``mlp``
kind (the port's names: ``attn_global``, ``ssd``, ``moe``, ``none``,
...), and the model's ends (embedding, final norm, head) are the kind
``top``. Each kind is one file, ``portbench/reference/<file>.py``, which
holds all the benchmark knows of it. The file is the kind's name, unless
the configuration's ``"kinds"`` maps the name to another file (a variant
of a kind, such as one with biases or a LayerNorm), so that a
configuration with a new kind or variant brings a new file and edits
none. A layer kind's file gives:

  * ``ROLE``: ``"mixer"`` or ``"mlp"``;
  * ``leaves(cfg)``: its parameters in one layer (``weights.Leaf``, paths
    under the layer such as ``norm1/w`` or ``mixer/wq``, in a fixed
    order: the weights drawn from a seed follow it);
  * ``forward(lp, x, cfg, quant)``: the plain float32 layer: the residual
    stream after it, the state it holds for decode
    (``{"self/<leaf>": [rows, ...]}``) and numbers of which a run keeps
    the least (``{"min_expert_rows": n}``);
  * ``prefill_flops(cfg, batch, s)``: one layer's model operations over
    prompts of ``s`` tokens;
  * ``decode_flops(cfg, batch, pos)`` and ``decode_bytes(cfg, batch,
    pos)``: one decode step's operations and the least bytes it moves
    (the layer's weights, its state or cache read and written), with
    ``pos`` positions held before the step;

and, a mixer that holds state, may give:

  * ``held(name, prog, ref, length)``: the program's and the reference's
    state leaf as vectors ``[layers, rows, positions, X]`` to compare
    (default: one vector a row);
  * ``exact(leaves, length)``: counts of the held state that must be 0.

``top`` (``ROLE = "top"``) gives ``leaves``, ``embed``, ``final``,
``logits`` and the same three counts for the head.
"""
from __future__ import annotations

import importlib
import math
from types import ModuleType
from typing import Dict, Iterator, List, Tuple

import torch


def kind(cfg: dict, name: str, role: str) -> ModuleType:
    """The file of kind ``name`` for this configuration."""
    file = cfg.get("kinds", {}).get(name, name)
    mod = importlib.import_module(f"portbench.reference.{file}")
    if getattr(mod, "ROLE", None) != role:
        raise ValueError(f"portbench/reference/{file}.py is not a {role} "
                         f"kind")
    return mod


def top(cfg: dict) -> ModuleType:
    return kind(cfg, "top", "top")


def layers(cfg: dict) -> Iterator[Tuple[int, ModuleType, ModuleType]]:
    """(pattern position, mixer kind, mlp kind) of each position."""
    for i, spec in enumerate(cfg["pattern"]):
        yield i, kind(cfg, spec["mixer"], "mixer"), \
            kind(cfg, spec["mlp"], "mlp")


def repeats(cfg: dict) -> int:
    """Repeats of the layer pattern; the benchmark takes whole periods."""
    n, p = cfg["n_layers"], len(cfg["pattern"])
    if n % p:
        raise ValueError(f"{n} layers are not whole periods of {p}")
    return n // p


def leaf_bytes(leaves: List) -> int:
    return sum(math.prod(x.shape) * x.dtype.itemsize for x in leaves)


def held(mixer: ModuleType, name: str, prog: torch.Tensor,
         ref: torch.Tensor, length: int):
    if hasattr(mixer, "held"):
        return mixer.held(name, prog, ref, length)
    return prog.flatten(2)[:, :, None], ref.flatten(2)[:, :, None]


def exact(mixer: ModuleType, leaves: Dict[str, torch.Tensor],
          length: int) -> Dict[str, int]:
    return mixer.exact(leaves, length) if hasattr(mixer, "exact") else {}
