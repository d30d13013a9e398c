"""ssd_roofline (%, kernels/ssd): the least time of the traced stretch's
SSD scans (``work/ssd.py``, one a layer and request) over the device
time of the kernels named ``ssd_scan_kernel`` in the trace."""
from portbench.reference.ssd import dims
from portbench.work import ssd

KERNELS = r"\bssd_scan_kernel"


def read(ctx):
    reqs = [r for r in ctx.requests if r["stretch"]]
    if ctx.trace is None or not reqs:
        return None
    device = ctx.trace.kernel_seconds(KERNELS)
    if device <= 0:
        return None
    cfg = ctx.cfg
    _, h, p, g, n, _ = dims(cfg)
    layers = sum(s["mixer"] == "ssd" for s in cfg["pattern"]) * \
        cfg["n_layers"] // len(cfg["pattern"])
    least = sum(layers * ssd.least_seconds(r["rows"], r["prompt_len"], h,
                                           p, g, n) for r in reqs)
    return 100.0 * least / device
