"""serve_mfu.batch: the model operations of every token the window's steps
prefilled or decoded (projections, MLP, visible attention pairs; the head
for each decoded token and once a prompt) over the window's seconds times
the bf16 peak.  None where a prompt found a cached prefix."""

from benchlib import counts
from benchlib.peaks import H100_SXM


def read(run):
    flops = 0.0
    for s in run.window_steps():
        if s.prefill_tokens != sum(s.admitted):
            return None
        flops += sum(counts.prefill_flops(run.config, 0, n) for n in s.admitted)
        flops += counts.decode_flops(run.config, s.keys)
    return 100.0 * flops / (run.window_s * H100_SXM.bf16_flops) if run.requests else None
