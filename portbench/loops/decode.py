"""``decode``: offline batches in a closed loop of one client; a request
is a batch of ``batch`` prompts, its prefill, then ``gen_tokens`` decode
steps (``ServeEngine.decode``) in chunks of ``chunk``. The next batch
goes in when the previous one has returned; its state goes then."""
import time

import numpy as np

from portbench import trace


def warm_up(engine, gen) -> None:
    """A batch at the mix's shortest prompt and one at its longest, each
    with one decode chunk."""
    rng = np.random.default_rng(0)
    for s in gen.warmup_lengths():
        first = engine.prefill(rng.integers(0, gen.vocab,
                                            size=(gen.batch, s),
                                            dtype=np.int32))
        engine.decode(first, gen.chunk)
    engine.cache = None


def run(engine, gen, seconds, sampler, prof, on):
    """The window: batches until the first that finishes at or after
    ``seconds``. Returns (requests, decode chunks, start, end); a chunk
    records its steps, rows and the positions held before it (``pos``)."""
    reqs, chunks = [], []
    i, prompt = 0, gen.prompt(0)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        t_issue = time.perf_counter()
        with trace.span("pb.prefill", on):
            first = engine.prefill(prompt)
        t_first = time.perf_counter()
        served, cur, left = [first[:, None]], first, gen.gen_tokens
        pos = prompt.shape[1]
        while left > 0:
            n = min(gen.chunk, left)
            c = len(chunks)
            if prof is not None:
                prof.before(c)
            c0 = time.perf_counter()
            with trace.span("pb.decode_chunk", on):
                out = engine.decode(cur, n)
            c1 = time.perf_counter()
            if prof is not None:
                prof.after(c)
            chunks.append({"t0": c0, "t1": c1, "steps": n, "pos": pos,
                           "rows": prompt.shape[0],
                           "stretch": prof is not None and prof.covers(c)})
            served.append(out[:, 1:])
            cur, left, pos = out[:, -1], left - n, pos + n
        t_done = time.perf_counter()
        served = np.concatenate(served, 1)
        sampler.offer(i, prompt, served, engine.cache)
        engine.cache = None
        reqs.append({"i": i, "rows": prompt.shape[0],
                     "prompt_len": prompt.shape[1],
                     "tokens_out": served.size, "t_issue": t_issue,
                     "t_first": t_first, "t_done": t_done, "stretch": False})
        if t_done >= deadline:
            break
        i += 1
        prompt = gen.prompt(i)
    if prof is not None:
        prof.stop()
    return reqs, chunks, t0, reqs[-1]["t_done"]
