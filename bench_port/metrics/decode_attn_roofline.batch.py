"""decode_attn_roofline.batch: the least time of the traced steps'
``paged_decode`` launches (one a layer a step: each decoding slot's query
against the keys it sees, the int8 payloads and float32 scales of those
keys read once, q and o; the larger of operations over the bf16 peak and
bytes over the bandwidth, launch by launch) over the kernel's device time
in the trace."""

from benchlib import counts
from benchlib.peaks import H100_SXM

KERNELS = ("decode_tc_kernel", "paged_decode_kernel")


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    seconds = sum(e - s for _, s, e in tl.kernels(KERNELS)) / 1e9
    if not seconds:
        return None
    bound = sum(counts.bound_seconds(*counts.decode_attn_work(run.config, s.keys), H100_SXM)
                for s in run.traced_steps() if s.keys)
    return 100.0 * bound * run.config["num_hidden_layers"] / seconds
