"""Operations and bytes of one SSD scan (the port's ``kernels/ssd``),
copied from ``kernels/ssd/ops.py``'s ``work`` and ``chip_smoke.py``'s
``ssd_bound_ms``: 4 P N float32 operations a token and head (the rescaled
form's update and read-out, fused multiply-adds counted as 2), against
x, y, B and C (``itemsize``), dt and a (float32) read or written once and
the float32 end state written once. The scan computes in float32 on the
CUDA cores, so its peak is the float32 one."""
from portbench.work import peaks


def work(b: int, s: int, h: int, p: int, g: int, n: int,
         itemsize: int = 2):
    flops = 4.0 * b * s * h * p * n
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * itemsize + \
        4 * (b * s * h + h + b * h * p * n)
    return flops, float(nbytes)


def least_seconds(b: int, s: int, h: int, p: int, g: int, n: int,
                  itemsize: int = 2) -> float:
    return peaks.least_seconds(*work(b, s, h, p, g, n, itemsize),
                               peak_flops=peaks.F32_FLOPS)
