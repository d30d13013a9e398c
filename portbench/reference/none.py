"""``none``: no MLP (a mixer-only block, as Mamba-2's): no parameters, no
work, the residual stream unchanged."""
ROLE = "mlp"


def leaves(cfg: dict):
    return []


def forward(lp, x, cfg: dict, quant):
    return x, {}, {}


def prefill_flops(cfg: dict, batch: int, s: int) -> float:
    return 0.0


def decode_flops(cfg: dict, batch: int, pos: int) -> float:
    return 0.0


def decode_bytes(cfg: dict, batch: int, pos: int) -> float:
    return 0.0
