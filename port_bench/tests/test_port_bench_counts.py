"""The model operations of counts/ against torch.utils.flop_counter over the
plain reference at tiny widths; the busy-union, idle, roofline and
per-layer arithmetic on synthetic events."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import counts, harness
from port_bench.counts.model import AttnCall, evaluation, net_forward
from port_bench.reference.model import NetSpec, Precond
from port_bench.tests.tiny import REPO, TINY_NET, TINY_SR
from port_bench.tracing import Interval, Slice, busy_us, idle_gaps, label_gaps
from port_bench.weights import seeded_state


def _spec(config, key, tiny):
    d = json.loads((REPO / "port_bench" / "configs" / config).read_text())[key]
    d.update(tiny)
    return NetSpec.from_json(d)


CASES = {"base": ("vivid-base.json", "net", TINY_NET),
         "uncond": ("vivid-base.json", "guide", TINY_NET),
         "sr": ("vivid-sr.json", "net", TINY_SR)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_match_the_flop_counter(case):
    spec = _spec(*CASES[case])
    net = Precond(spec)
    net.load_state_dict(seeded_state(net, 3, "net", "cpu"))
    b, r = 2, spec.resolution
    src = torch.rand(b, spec.num_sources, r, r, 3)
    x = torch.randn(b, r, r, 3)
    sigma = torch.full((b,), 1.5)
    geo = torch.randn(b, spec.num_sources, 20)
    cond = torch.randn(b, r, r, 3) if spec.super_res else None
    noise = torch.randn(b, r, r, 3) if spec.super_res else None
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(src, x, sigma, geo, cond, noise, return_logvar=True)
    flops, _ = net_forward(spec, b)
    assert flops == fc.get_total_flops()


def test_evaluation_arithmetic():
    spec = _spec(*CASES["base"])
    guide = _spec(*CASES["uncond"])
    f1, a1 = net_forward(spec, 3)
    g1, b1 = net_forward(guide, 3)
    assert evaluation(spec, guide, 3) == (f1 + g1, a1 + b1)
    assert evaluation(spec, None, 3) == (f1, a1)
    assert counts.attn_bwd_flops(1, 2, 3, 4, 5) == 2 * counts.attn_fwd_flops(1, 2, 3, 4, 5)


def test_roofline_bound():
    call = AttnCall(8, 4, 1024, 3072, 64)
    ops, nbytes = call.fwd()
    assert ops == 4 * 8 * 4 * 1024 * 3072 * 64
    assert nbytes == (2 * 1024 + 2 * 3072) * 8 * 4 * 64 * 2
    assert counts.roofline_seconds(ops, nbytes) == pytest.approx(ops / 989e12)
    assert counts.roofline_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_busy_union_and_gaps():
    ev = [Interval("a", 0, 10), Interval("b", 5, 15), Interval("c", 20, 30),
          Interval("d", 22, 25)]
    assert busy_us(ev) == 25
    assert busy_us([]) == 0
    assert idle_gaps(ev, 0, 40) == [(15, 20), (30, 40)]
    host = [Interval("bench:net", 0, 34), Interval("aten::conv2d", 14, 21),
            Interval("aten::add", 31, 33), Interval("bench:guide", 34, 40)]
    labels = label_gaps(idle_gaps(ev, 0, 40), host)
    assert labels == {"net / aten::conv2d": 5e-6, "guide / python": 10e-6}


def _outcome(**kw):
    base = dict(setup_s=1.0, e2e={}, attempted=1, failed=0, checks={}, unit="eval", units=10,
                window_s=2.0, flops_per_unit=989e12 * 0.1, attn_per_unit=[AttnCall(1, 1, 64, 64, 64)],
                memory_peak_bytes=2 ** 31)
    base.update(kw)
    return harness.Outcome(**base)


def test_layer_readers_on_synthetic_slices():
    bench = REPO / "port_bench"
    read = lambda name, out: harness.load_reader(bench, name)(out, None)
    dev = [Interval("packed_fwd_kernel", 0, 1000), Interval("gemm", 1000, 3000),
           Interval("multi_tensor_apply_kernel", 3000, 3500)]
    sl = Slice(dev, [], window_s=0.005, units=2)
    out = _outcome(slice=sl)
    assert read("mfu.sample", out) == pytest.approx(100 * 0.1 * 10 / 2.0)
    # busy 1.75 ms an evaluation traced, against 200 ms of wall an evaluation untraced
    assert read("idle_share.sample", out) == pytest.approx(100 * (1 - 0.00175 / 0.2))
    assert read("device_ms_per_eval.sample", out) == pytest.approx(1.75)
    bound = 2 * counts.roofline_seconds(*AttnCall(1, 1, 64, 64, 64).fwd())
    assert read("attn_roofline.sample", out) == pytest.approx(100 * bound / 0.001)
    # an untraced run reads only what needs no slice
    plain = _outcome()
    assert read("mfu.sample", plain) is not None
    assert all(read(n, plain) is None for n in
               ("idle_share.sample", "device_ms_per_eval.sample", "attn_roofline.sample"))
    # a slice in which no attention kernel ran gives no roofline, not 0
    quiet = _outcome(slice=Slice([Interval("gemm", 0, 10)], [], 1e-5, 1))
    assert read("attn_roofline.sample", quiet) is None


def test_breakdown_shape():
    dev = [Interval(f"k{i}", 10 * i, 10 * i + 5) for i in range(20)]
    host = [Interval("bench:net", 0, 200)]
    b = Slice(dev, host, 2e-4, 1).breakdown()
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) <= 10
    assert all(isinstance(v, float) for _, v in b["device_ops"])
