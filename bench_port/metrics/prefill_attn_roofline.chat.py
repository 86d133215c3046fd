"""prefill_attn_roofline.chat: the least time of the traced steps'
``paged_prefill`` launches (one a layer a chunk of ``prefill_chunk``
prompt tokens: the visible pairs' operations, or q, o and the keys the
chunk sees read once, whichever bounds) over the kernel's device time in
the trace.  None where a prompt found a cached prefix."""

from benchlib import counts
from benchlib.peaks import H100_SXM

KERNELS = ("prefill_tc_kernel", "paged_prefill_kernel")


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    seconds = sum(e - s for _, s, e in tl.kernels(KERNELS)) / 1e9
    if not seconds:
        return None
    bound = 0.0
    for s in run.traced_steps():
        if s.prefill_tokens != sum(s.admitted):
            return None
        for n in s.admitted:
            for start, m in counts.chunks(0, n, run.engine["prefill_chunk"]):
                bound += counts.bound_seconds(*counts.prefill_attn_work(run.config, start, m),
                                              H100_SXM)
    return 100.0 * bound * run.config["num_hidden_layers"] / seconds
