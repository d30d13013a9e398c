"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit), copied from ``chip_smoke.py`` (``PEAK_BF16_FLOPS``,
``PEAK_F32_FLOPS``, ``PEAK_HBM_BYTES``). A card set below 700 W runs
slower; ``run.py`` prints the card's power limit beside every result."""
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float,
                  peak_flops: float = BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
