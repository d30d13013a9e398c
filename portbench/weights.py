"""Random weights for a configuration, made on the device from the seed.

The tree is the port's parameter layout at tp 1 (``in_embed``,
``out_embed``, ``final_norm/w`` and one stacked group
``group0/p{i}/...`` with a leading layer axis), stated here leaf by leaf
so that the benchmark does not read it from the program; ``run.py``
checks the names, shapes and dtypes once against the port's
``abstract_params``. The same tensors go to the engine and to the plain
reference.

All bfloat16 leaves are views of one flat buffer filled by a few large
``normal_`` calls of a generator on the device, then scaled in place;
the other leaves (the SSD blocks' float32 decay parameters) are views of
one uniform buffer, mapped onto their laws by their kinds. Scales: a projection's weights have standard deviation
``1 / sqrt(fan_in)`` over its real input width (so activations keep
their size through the layers), the norms' and skips' weights are
``1 + 0.1 N``, the embedding ``N(0, 1)``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Tuple, Union

import torch

from portbench import kinds

#: elements a ``normal_`` call fills (2 GiB of bfloat16)
_CHUNK = 2 ** 30
#: each leaf starts on a multiple of this many elements (256 bytes), as
#: the kernels' 16-byte loads need
_ALIGN = 128


class Leaf(NamedTuple):
    path: str
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    #: ``normal`` (N(0, std)), ``norm`` (1 + 0.1 N(0, 1)), or, for a
    #: leaf not in bfloat16, a function that maps its uniform draws in
    #: [0, 1) in place onto its law
    init: Union[str, Callable[[torch.Tensor], None]] = "normal"
    std: float = 1.0


def padded_vocab(cfg: dict) -> int:
    g = cfg.get("vocab_pad_to", 256)
    return -(-cfg["vocab_size"] // g) * g


def layout(cfg: dict) -> List[Leaf]:
    """Every leaf of the tree, in a fixed order: the model's ends, then
    each pattern position's mixer and MLP leaves, as their kinds state
    them (``kinds.py``), stacked over the pattern's repeats."""
    leaves = list(kinds.top(cfg).leaves(cfg))
    reps = kinds.repeats(cfg)
    for i, mixer, mlp in kinds.layers(cfg):
        for x in mixer.leaves(cfg) + mlp.leaves(cfg):
            leaves.append(x._replace(path=f"group0/p{i}/{x.path}",
                                     shape=(reps,) + tuple(x.shape)))
    return leaves


def nbytes(cfg: dict) -> int:
    return sum(math.prod(x.shape) * x.dtype.itemsize for x in layout(cfg))


def _offsets(leaves: List[Leaf]) -> Tuple[List[int], int]:
    offs, n = [], 0
    for x in leaves:
        offs.append(n)
        n += -(-math.prod(x.shape) // _ALIGN) * _ALIGN
    return offs, n


def make(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The nested parameter tree on ``device`` from ``seed``.
    ``dtype`` replaces bfloat16 (the CPU tests build float32 trees)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    leaves = layout(cfg)
    main = [x for x in leaves if x.dtype == torch.bfloat16]
    f32 = [x for x in leaves if x.dtype != torch.bfloat16]
    offs, total = _offsets(main)
    flat = torch.empty(total, dtype=dtype, device=device)
    for lo in range(0, total, _CHUNK):
        flat[lo:lo + _CHUNK].normal_(generator=gen)
    offs32, total32 = _offsets(f32)
    uni = torch.empty(total32, dtype=torch.float32, device=device)
    uni.uniform_(generator=gen)
    tree: Dict = {}
    for group, o, buf in ((main, offs, flat), (f32, offs32, uni)):
        for x, off in zip(group, o):
            t = buf[off:off + math.prod(x.shape)].view(x.shape)
            if callable(x.init):
                x.init(t)
            elif x.init == "normal":
                t.mul_(x.std)
            elif x.init == "norm":
                t.mul_(0.1).add_(1.0)
            else:
                raise ValueError(f"{x.path}: init {x.init!r}")
            node = tree
            *dirs, name = x.path.split("/")
            for k in dirs:
                node = node.setdefault(k, {})
            node[name] = t
    return tree


def flat_leaves(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
