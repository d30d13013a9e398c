"""Operations of causal attention (the port's ``kernels/flash_attention``),
copied from ``chip_smoke.py``'s ``attention_bound_ms`` and the wrapper's
``record_kernel`` call: 4 Dh operations for each visible (query, key)
pair and query head (QK^T and PV, multiply-adds counted as 2)."""


def visible_pairs(s: int) -> int:
    """Causal self-attention over s positions, no window."""
    return s * (s + 1) // 2


def flops(b: int, s: int, heads: int, head_dim: int) -> float:
    return 4.0 * head_dim * heads * b * visible_pairs(s)
