"""batch_occupancy.batch: the share of the engine's slots that decode in an
average step of the window, from the engine's own counters
(``DecodeEngine.stats``: decode tokens over steps over ``max_seqs``)."""


def read(run):
    steps = run.stats1["steps"] - run.stats0["steps"]
    if not steps:
        return None
    toks = run.stats1["decode_tokens"] - run.stats0["decode_tokens"]
    return 100.0 * toks / steps / run.engine["max_seqs"]
