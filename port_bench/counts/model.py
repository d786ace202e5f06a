"""Model operations of one VIVID network evaluation, from a configuration's
shapes: every convolution, linear and attention call of the plan
(`reference.model.build_plan`), counted by the functions of this package.
Elementwise work is not counted as operations. The guided evaluation is the
net's and its guide's, and the encoder runs on every evaluation, since the
benchmarked nets have no `no_time_enc`.
"""

from dataclasses import dataclass
from typing import List

from port_bench.counts import attn_fwd_bytes, attn_fwd_flops, conv_flops, linear_flops
from port_bench.reference.model import NetSpec, build_plan


@dataclass(frozen=True)
class AttnCall:
    b: int
    heads: int
    sq: int
    sk: int
    d: int

    def fwd(self):
        return attn_fwd_flops(self.b, self.heads, self.sq, self.sk, self.d), \
            attn_fwd_bytes(self.b, self.heads, self.sq, self.sk, self.d)


def _unet(spec, kind, rows, uncond, attn: List[AttnCall]) -> int:
    """Operations of one U-Net of `spec` over `rows` images; appends its
    attention calls to `attn`."""
    u = spec.unet(kind)
    flops = linear_flops(rows, u.cblock[0], u.cemb) + linear_flops(rows, u.label_dim, u.cemb)
    for e in build_plan(u):
        r = e.res
        if e.conv:
            flops += conv_flops(rows, r, r, *e.conv)
            continue
        s = e.block
        c0_in = s.cout if s.flavor == "enc" else s.cin
        flops += conv_flops(rows, r, r, c0_in, s.cout) + conv_flops(rows, r, r, s.cout, s.cout)
        flops += linear_flops(rows, s.cemb, s.cout)
        if s.cin != s.cout:
            flops += conv_flops(rows, r, r, s.cin, s.cout, 1, 1)
        if s.heads:
            seq = r * r
            flops += linear_flops(rows * seq, s.cout, 3 * s.cout)
            flops += linear_flops(rows * seq, s.cout, s.cout)
            sk = seq
            if s.xattn and not uncond:
                flops += s.sources * linear_flops(rows * seq, s.cout, 2 * s.cout)
                sk = seq * (1 + s.sources)
            call = AttnCall(rows, s.heads, seq, sk, s.cout // s.heads)
            attn.append(call)
            flops += call.fwd()[0]
    if kind != "encoder":
        flops += conv_flops(rows, u.resolution, u.resolution, u.cblock[0], 3)
    return flops


def net_forward(spec: NetSpec, rows: int):
    """(operations, attention calls) of one NVPrecond forward over `rows`
    targets: the encoder over rows x num_sources views, the denoiser, the
    log-variance head."""
    attn: List[AttnCall] = []
    flops = 0
    if not spec.uncond:
        flops += _unet(spec, "encoder", rows * spec.num_sources, False, attn)
    flops += _unet(spec, spec.denoiser_kind, rows, spec.uncond, attn)
    flops += linear_flops(rows, spec.logvar_channels, 1)
    return flops, attn


def evaluation(net: NetSpec, guide, rows: int):
    """One (guided) evaluation: the net's forward and its guide's."""
    flops, attn = net_forward(net, rows)
    if guide is not None:
        g_flops, g_attn = net_forward(guide, rows)
        flops, attn = flops + g_flops, attn + g_attn
    return flops, attn

