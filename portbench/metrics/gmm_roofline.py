"""gmm_roofline (%, kernels/moe_gmm): the least time of the traced
stretch's grouped expert matmuls (``work/gmm.py``: each MoE layer's three,
over ``top_k`` routed rows a token) over the device time of the kernels
named ``gmm_*_kernel`` in the trace. Every expert counts as holding a
row: a request routes at least ``top_k`` x 512 rows over the experts,
and the run prints the fewest rows any expert got in the reference's
routing of the sampled requests."""
from portbench.work import gmm

KERNELS = r"\bgmm_(wgmma|mma|f32)_kernel"


def read(ctx):
    reqs = [r for r in ctx.requests if r["stretch"]]
    if ctx.trace is None or not reqs:
        return None
    device = ctx.trace.kernel_seconds(KERNELS)
    if device <= 0:
        return None
    cfg = ctx.cfg
    moe = cfg["moe"]
    layers = sum(s["mlp"] == "moe" for s in cfg["pattern"]) * \
        cfg["n_layers"] // len(cfg["pattern"])
    least = 0.0
    for r in reqs:
        rows = moe["top_k"] * r["rows"] * r["prompt_len"]
        used = min(moe["n_experts"], rows)
        least += 3 * layers * gmm.least_seconds(rows, cfg["d_model"],
                                                cfg["d_ff"], used)
    return 100.0 * least / device
