"""Operations and bytes of one grouped expert matmul (the port's
``kernels/moe_gmm``), copied from ``chip_smoke.py``'s ``gmm_bound_ms``
(and ``kernels/moe_gmm/ops.py``'s ``work``, whose weight bytes count
every expert): 2 D F operations a real routed row, against the real rows
of x read and of the output written once, and the weights of the experts
that hold a row read once (an expert no row reaches is not read)."""
from portbench.work import peaks


def work(rows: int, d: int, f: int, experts_used: int, itemsize: int = 2):
    return 2.0 * rows * d * f, \
        float((rows * d + rows * f + experts_used * d * f) * itemsize)


def least_seconds(rows: int, d: int, f: int, experts_used: int,
                  itemsize: int = 2) -> float:
    return peaks.least_seconds(*work(rows, d, f, experts_used, itemsize))
