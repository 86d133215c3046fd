"""Whether what the timed path served is correct.

A served model is judged on its greedy tokens.  Once the window has closed
and the program is freed, a sample of ``check.requests`` of the requests
it finished is drawn from the seed: the one with the longest context, the
one with the most served tokens, then others at random.  A request keeps
its slot for life, so several requests reach a fault that touches only
some slots (half the batch left stale is missed by two requests in a
quarter of runs, by eight in one of 256).  The configuration's plain
reference runs once over each prompt and its served tokens, on weights it
draws again from the seed, and at every served position reads the gap by
which the served token's logit lies below the reference's best.  The
number compared is the widest gap over the sample (``logit_gap``), against
the mix's ``check.max_logit_gap``.

With ``--control 1`` the control takes the program's place in that
comparison: the reference in float8 e4m3 (``fp8=True``) at the same
positions, whose first token each time is judged by the same gap.  So a
control run is correct only where the limit fails to separate the lower
precision; the program's own widest gap is kept beside it in ``readings``
(``program_logit_gap``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import bench, weights as W


def sample(run, served: dict) -> list:
    done = [r for r in run.requests if r.rid in served and served[r.rid]]
    if not done:
        return []
    spec, picked = run.traffic["check"], []
    for key in (lambda r: len(r.prompt) + len(served[r.rid]), lambda r: len(served[r.rid])):
        best = max(done, key=key)
        if best not in picked:
            picked.append(best)
    rng = np.random.default_rng([int(run.seed), 2])
    rest = [done[i] for i in rng.permutation(len(done)) if done[i] not in picked]
    return (picked + rest)[:int(spec["requests"])]


def gaps(ref, cfg, weights, prompt, tokens, device, control: bool):
    """(the widest gap of the served tokens, of the control's first tokens
    or None) over one request."""
    seq = torch.as_tensor(np.concatenate([prompt, tokens[:-1]]), device=device)
    pos = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(tokens), device=device)
    logits = ref.logits(cfg, weights, seq, pos)
    best = logits.max(-1).values
    served = torch.as_tensor(tokens, device=device)
    gap = float((best - logits.gather(1, served[:, None])[:, 0]).max())
    cgap = None
    if control:
        first = ref.logits(cfg, weights, seq, pos, fp8=True).argmax(-1)
        cgap = float((best - logits.gather(1, first[:, None])[:, 0]).max())
    return gap, cgap


def serve(run, served: dict, device) -> None:
    picked = sample(run, served)
    limit = float(run.traffic["check"]["max_logit_gap"])
    if not picked:
        run.checks.append(("logit_gap", float("inf"), limit, False))
        return
    ref = bench.reference(run.root, run.config)
    weights = W.generate(run.config, run.seed, device)
    widest, cwidest, n = 0.0, 0.0, 0
    for r in picked:
        toks = np.asarray(served[r.rid], dtype=np.int64)
        g, c = gaps(ref, run.config, weights, r.prompt, toks, device, run.control)
        judged = c if run.control else g
        widest, cwidest = max(widest, g), max(cwidest, c or 0.0)
        run.failed += judged > limit
        n += len(toks)
    judged = cwidest if run.control else widest
    run.checks.append(("logit_gap", judged, limit, judged <= limit))
    run.readings.update(requests_compared=len(picked), tokens_compared=n,
                        longest_context_compared=max(len(r.prompt) + len(served[r.rid])
                                                     for r in picked))
    if run.control:
        run.readings["program_logit_gap"] = widest
