"""attn_roofline.sample: the least time the card could take for the model's
attention calls of the traced evaluations (each call the larger of its
operations over the bf16 peak and its bytes over the memory bandwidth,
counts/), over the device time of the kernels that compute attention, found
by name: the program's own (K1-K8) and PyTorch's flash, memory-efficient and
SDPA kernels, so that attention rerouted elsewhere is still read."""

from port_bench.counts import roofline_seconds

PATTERNS = ("packed_fwd", "packed_bwd", "nomax", "flash", "fmha", "sdpa", "attention",
            "bwd_prep")


def is_attention(name: str) -> bool:
    low = name.lower()
    return any(p in low for p in PATTERNS)


def read(out, run):
    s = out.slice
    if s is None or out.unit != "eval" or not out.attn_per_unit:
        return None
    seconds = s.device_seconds(is_attention)
    if seconds <= 0:
        return None
    bound = s.units * sum(roofline_seconds(*call.fwd()) for call in out.attn_per_unit)
    return 100 * bound / seconds
