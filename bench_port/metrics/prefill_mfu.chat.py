"""prefill_mfu.chat: the model operations of the prompts the window's steps
prefilled (projections, MLP, the visible attention pairs, the head once a
prompt), over the wall time of the steps that admitted them times the bf16
peak.  Those steps also run one decode step each, so this is a lower bound
on the chunked prefill's own share.  None where a prompt found a cached
prefix (the split of the prefilled tokens over the prompts is then not
known to the harness)."""

from benchlib import counts
from benchlib.peaks import H100_SXM


def read(run):
    flops = wall = 0.0
    for s in run.window_steps():
        if not s.admitted:
            continue
        if s.prefill_tokens != sum(s.admitted):
            return None
        flops += sum(counts.prefill_flops(run.config, 0, n) for n in s.admitted)
        wall += s.t1 - s.t0
    return 100.0 * flops / (wall * H100_SXM.bf16_flops) if wall else None
