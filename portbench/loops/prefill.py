"""``prefill``: a closed loop of one client; a request is one prompt and
its first token (``ServeEngine.prefill``), and the next request goes in
when the previous one has returned. Its state goes when it is done, as a
prefill worker hands a finished request on."""
import time

import numpy as np

from portbench import trace


def warm_up(engine, gen) -> None:
    """One request at the mix's shortest prompt and one at its longest."""
    rng = np.random.default_rng(0)
    for s in gen.warmup_lengths():
        engine.prefill(rng.integers(0, gen.vocab, size=(gen.batch, s),
                                    dtype=np.int32))
    engine.cache = None


def run(engine, gen, seconds, sampler, prof, on):
    """The window: requests until the first that returns at or after
    ``seconds``. Returns (requests, decode chunks, start, end)."""
    reqs = []
    i, prompt = 0, gen.prompt(0)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        if prof is not None:
            prof.before(i)
        with trace.span("pb.request", on):
            t_issue = time.perf_counter()
            with trace.span("pb.prefill", on):
                first = engine.prefill(prompt)
            t_first = time.perf_counter()
            with trace.span("pb.hold", on):
                sampler.offer(i, prompt, first[:, None], engine.cache)
                engine.cache = None
            reqs.append({"i": i, "rows": prompt.shape[0],
                         "prompt_len": prompt.shape[1],
                         "tokens_out": prompt.shape[0], "t_issue": t_issue,
                         "t_first": t_first, "t_done": t_first,
                         "stretch": prof is not None and prof.covers(i)})
            if t_first >= deadline:
                break
            i += 1
            with trace.span("pb.prompt_gen", on):
                prompt = gen.prompt(i)
        if prof is not None:
            prof.after(i - 1)
    if prof is not None:
        prof.stop()
    return reqs, [], t0, reqs[-1]["t_done"]
