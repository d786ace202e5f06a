"""The port's span recorder (`core/trace.py`) on the CPU: the recorder
itself, profiler ranges only inside the program's own `trace()`, the spans
of `generate_images_nvs` at tiny widths, the trainer's timing read from its
spans, and the benchmark's three span readers on a tiny cell."""

import collections
import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from port_bench import harness, spans as bench_spans
from port_bench.tests.tiny import tiny_checkout
from vivid_tpu_torch.core import trace as trace_mod
from vivid_tpu_torch.core.easydict import EasyDict
from vivid_tpu_torch.core.trace import drain, span, spans, trace
from vivid_tpu_torch.data import scenes
from vivid_tpu_torch.diffusion.sampler import edm_sampler, make_denoiser
from vivid_tpu_torch.generate import generate_images_nvs
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.train import loop as loop_mod

torch.set_num_threads(1)

TINY = dict(img_resolution=16, model_channels=16, channel_mult=(1, 2), num_blocks=1,
            attn_resolutions=(8,), channels_per_head=8, use_bf16=False, remat=False)
PATH_RANGES = ("sampler.step", "sampler.eval:net", "sampler.eval:guide", "net.encoder",
               "net.denoiser")
BATCH_PARTS = ["loader.wait", "generate.prepare", "generate.sample", "generate.decode",
               "generate.png_wait", "generate.barrier"]     # the sampling thread's
ALL_SPANS = SimpleNamespace(t_start=0.0)     # a run that reads every span held
READERS = ("between_batches_ms.sample", "loader_wait_ms.sample", "first_batch_s.setup")


def _net(uncond=False, seed=0):
    cfg = PrecondConfig(uncond=uncond, **TINY)
    return EasyDict(net=NVPrecond(cfg, seed=seed).eval().requires_grad_(False), cfg=cfg)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return scenes.make_synthetic_dataset(str(tmp_path_factory.mktemp("spans") / "scenes"),
                                         num_scenes=4, num_views=6, imsize=16)


# -- the recorder ------------------------------------------------------------------------

def test_spans_nest_share_their_root_and_carry_counts():
    drain()
    with span("outer", rows=4) as outer:
        with span("middle") as middle:
            with span("inner") as inner:
                pass
        with span("second") as second:
            second.attrs["files"] = 3
    with span("next") as other:
        pass
    got = drain()
    assert [s.name for s in got] == ["inner", "middle", "second", "outer", "next"]
    assert outer.parent is None and outer.root == outer.id
    assert middle.parent == outer.id and second.parent == outer.id
    assert inner.parent == middle.id
    assert {s.root for s in (outer, middle, inner, second)} == {outer.id}
    assert other.parent is None and other.root == other.id != outer.id
    assert outer.attrs == {"rows": 4} and second.attrs == {"files": 3}
    assert outer.start <= middle.start <= inner.start <= inner.end <= middle.end
    assert middle.end <= second.start <= second.end <= outer.end
    assert all(s.error is None and s.seconds >= 0 for s in got)
    assert spans() == [] and drain() == []


def test_a_span_ended_by_an_exception_carries_it_and_the_stack_recovers():
    drain()
    with pytest.raises(KeyError):
        with span("outer"):
            with span("failing"):
                raise KeyError("x")
    with span("after") as after:
        pass
    failing, outer, _ = drain()
    assert failing.error == outer.error == "KeyError"
    assert failing.parent == outer.id and after.parent is None and after.error is None


def test_the_decorator_makes_a_span_a_call_and_threads_keep_their_own_stacks():
    drain()

    @span("work", kind="decorated")
    def work(depth):
        return work(depth - 1) if depth else threading.get_ident()

    with span("main"):
        work(1)
        seen = []
        t = threading.Thread(target=lambda: seen.append(work(0)))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    got = {(s.name, s.thread, s.parent is None) for s in drain()}
    main_id = threading.get_ident()
    assert ("work", seen[0], True) in got             # the thread's span is a root there
    assert ("work", main_id, False) in got and ("main", main_id, True) in got
    assert len([g for g in got if g[0] == "work"]) == 2


def test_a_span_on_another_thread_takes_the_parent_it_names():
    """`parent=` gives a span opened on an empty stack its parent and root;
    the thread's own stack wins over it, and the span may end after its
    parent."""
    drain()
    ready, release = threading.Event(), threading.Event()

    def work(root):
        with span("handed", parent=root, files=2) as handed:
            ready.set()
            release.wait(timeout=30)
            with span("inside") as inside:
                pass
        with span("after", parent=root) as after:
            with span("own", parent=root) as own:
                pass
        seen.extend([handed, inside, after, own, threading.get_ident()])

    seen = []
    with span("root") as root:
        t = threading.Thread(target=work, args=(root,))
        t.start()
        assert ready.wait(timeout=30)
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    handed, inside, after, own, thread = seen
    assert root.parent is None and root.root == root.id
    assert handed.parent == root.id and handed.root == root.id and handed.attrs == {"files": 2}
    assert handed.thread == thread != root.thread
    assert inside.parent == handed.id and inside.root == root.id
    assert after.parent == root.id and own.parent == after.id and own.root == root.id
    assert root.end < handed.end                     # it outlived its parent
    assert {s.id for s in drain()} == {s.id for s in (root, handed, inside, after, own)}
    with span("free") as free:                       # this thread's stack is empty again
        pass
    assert free.parent is None and free.root == free.id
    drain()


def test_the_recorder_is_bounded_and_drain_empties_it(monkeypatch):
    monkeypatch.setattr(trace_mod, "_finished", trace_mod.collections.deque(maxlen=5))
    for i in range(8):
        with span("s", i=i):
            pass
    assert [s.attrs["i"] for s in spans()] == [3, 4, 5, 6, 7]
    assert len(drain()) == 5 and spans() == []


# -- profiler ranges -----------------------------------------------------------------------

def _guided_evaluation():
    """One Heun step of a tiny guided sampler: one guided evaluation, in a span."""
    g = torch.Generator().manual_seed(0)
    net, gnet = _net(seed=1), _net(uncond=True, seed=2)
    src = torch.rand(2, 2, 16, 16, 3, generator=g) * 2 - 1
    geo = torch.randn(2, 2, 20, generator=g)
    noise = torch.randn(2, 16, 16, 3, generator=g)

    @span("vivid_guided_evaluation")
    def evaluation():
        return edm_sampler(make_denoiser(net.net, src, geo), noise,
                           gnet_denoise=make_denoiser(gnet.net), num_steps=1, guidance=1.5)
    return evaluation


def test_no_range_outside_trace_and_nested_ranges_inside_it(tmp_path):
    evaluation = _guided_evaluation()
    names = set(PATH_RANGES) | {"vivid_guided_evaluation"}
    drain()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        evaluation()
    assert not names & {e.name for e in prof.events()}
    # outside trace() the same blocks are spans all the same, nested alike
    recorded = {s.name: s for s in drain() if s.name != "net.denoiser"}
    assert set(recorded) == names - {"net.denoiser"}
    assert recorded["sampler.step"].parent == recorded["vivid_guided_evaluation"].id
    assert recorded["sampler.eval:net"].parent == recorded["sampler.step"].id
    assert recorded["sampler.eval:guide"].parent == recorded["sampler.step"].id
    assert recorded["net.encoder"].parent == recorded["sampler.eval:net"].id

    with trace(str(tmp_path)) as traced:
        evaluation()
    events = [e for e in json.load(open(traced.trace_file))["traceEvents"]
              if e.get("name") in names and e.get("ph") == "X"]
    by_name = {n: [e for e in events if e["name"] == n] for n in names}
    assert {n: len(v) for n, v in by_name.items()} == {
        "vivid_guided_evaluation": 1, "sampler.step": 1, "sampler.eval:net": 1,
        "sampler.eval:guide": 1, "net.encoder": 1, "net.denoiser": 2}

    def inside(e, outer):
        return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

    (whole,), (step,) = by_name["vivid_guided_evaluation"], by_name["sampler.step"]
    assert inside(step, whole)
    (net_eval,), (guide_eval,) = by_name["sampler.eval:net"], by_name["sampler.eval:guide"]
    assert inside(net_eval, step) and inside(guide_eval, step)
    # the net's evaluation holds its encoder and a denoiser, the guide's a denoiser alone
    assert inside(by_name["net.encoder"][0], net_eval)
    assert [inside(e, net_eval) for e in by_name["net.denoiser"]].count(True) == 1
    assert [inside(e, guide_eval) for e in by_name["net.denoiser"]].count(True) == 1


# -- the sampling entry --------------------------------------------------------------------

def test_each_batch_is_a_root_over_its_parts_in_order(data, tmp_path):
    net, gnet = _net(seed=1), _net(uncond=True, seed=2)
    drain()
    got = list(generate_images_nvs(net, gnet, guidance=1.5, outdir=str(tmp_path / "out"),
                                   seeds=range(3), max_batch_size=2,
                                   datakwargs={"path": data}, num_steps=2, verbose=False,
                                   device="cpu"))
    done = time.perf_counter_ns()                # the generator's iteration has returned
    recorded = drain()
    roots = sorted((s for s in recorded if s.name == "generate.batch"), key=lambda s: s.start)
    assert [len(r.seeds) for r in got] == [2, 1]
    assert [r.attrs["batch_idx"] for r in roots] == [0, 1]
    assert [r.attrs["rows"] for r in roots] == [2, 1]
    assert {r.attrs["num_steps"] for r in roots} == {2} and len({r.attrs["call"] for r in roots}) == 1
    for root, rows in zip(roots, (2, 1)):
        assert root.parent is None and root.root == root.id and root.error is None
        parts = sorted((s for s in recorded if s.parent == root.id and s.thread == root.thread),
                       key=lambda s: s.start)
        assert [s.name for s in parts] == BATCH_PARTS
        assert all(s.error is None for s in parts)
        assert all(a.end <= b.start for a, b in zip(parts, parts[1:]))
        assert root.start <= parts[0].start and parts[-1].end <= root.end
        named = {s.name: s for s in parts}
        assert named["generate.sample"].attrs == {"evaluations": 3}
        assert named["loader.wait"].attrs == {"rows": 2}
        # the PNGs: written on the writer thread under the batch's root, after its decode
        (png,) = [s for s in recorded if s.name == "generate.png" and s.root == root.id]
        assert png.parent == root.id and png.thread != root.thread and png.error is None
        assert png.attrs == {"files": 3 * rows, "batch_idx": root.attrs["batch_idx"]}
        assert named["generate.decode"].end <= png.start <= png.end <= done
        # the sampler's steps and evaluations sit under the batch's sample span
        below = [s for s in recorded if s.root == root.id and s.parent not in (None, root.id)]
        steps = [s for s in below if s.name == "sampler.step"]
        assert [s.parent for s in steps] == [named["generate.sample"].id] * 2
        assert len([s for s in below if s.name == "sampler.eval:net"]) == 3
    assert spans() == []


def test_a_batch_ended_by_an_exception_leaves_an_error_batch(data):
    net = _net(seed=1)

    class Stop(Exception):
        pass

    calls = []

    def stop_in_the_second_batch(module, args):
        calls.append(1)
        if len(calls) > 3:        # 2 steps: 3 evaluations a batch
            raise Stop
    handle = net.net.register_forward_pre_hook(stop_in_the_second_batch)
    drain()
    it = iter(generate_images_nvs(net, seeds=range(4), max_batch_size=2,
                                  datakwargs={"path": data}, num_steps=2, verbose=False,
                                  device="cpu"))
    try:
        next(it)
        with pytest.raises(Stop):
            next(it)
    finally:
        it.close()
        handle.remove()
    with span("after") as after:
        pass
    recorded = drain()
    first, second = sorted((s for s in recorded if s.name == "generate.batch"),
                           key=lambda s: s.start)
    assert first.error is None and second.error == "Stop"
    open_parts = {s.name: s.error for s in recorded if s.parent == second.id}
    assert open_parts == {"loader.wait": None, "generate.prepare": None, "generate.sample": "Stop"}
    (step,) = [s for s in recorded if s.root == second.id and s.name == "sampler.step"]
    assert step.error == "Stop"
    assert after.parent is None       # nothing left open on this thread's stack


# -- the trainer ---------------------------------------------------------------------------

def test_the_trainers_timing_is_read_from_its_spans(data, tmp_path, monkeypatch):
    drained = []

    def recording_drain():
        got = drain()
        drained.append(got)
        return got
    monkeypatch.setattr(loop_mod, "drain", recording_drain)
    nimg_step = 2 * 6
    loop_mod.training_loop(
        run_dir=str(tmp_path / "run"), dataset_kwargs={"path": data}, network_kwargs=TINY,
        loss_kwargs=dict(P_mean=-0.8, P_std=1.6),
        lr_kwargs=dict(ref_lr=1e-3, ref_batches=100, rampup_Mimg=0), seed=0, batch_size=2,
        total_nimg=4 * nimg_step, status_nimg=2 * nimg_step, samples_nimg=None,
        snapshot_nimg=None, checkpoint_nimg=None, device="cpu")
    rows = [json.loads(line) for line in open(tmp_path / "run" / "stats.jsonl")]
    ticks = drained[2:]               # the loop's start, then its first status tick at 0 kimg
    assert len(rows) == 3 and len(ticks) == 2
    for row, finished in zip(rows[1:], ticks):
        steps = {s.id: s for s in finished if s.name == "train.step"}
        waits = [s for s in finished if s.name == "loader.wait" and s.parent in steps]
        assert len(steps) == len(waits) == 2
        assert row["Timing/loader_wait_sec"] == pytest.approx(sum(s.seconds for s in waits),
                                                              rel=1e-6)
        assert row["Timing/loader_rows_per_s"] > 0
        assert row["Timing/sec_per_kimg"] == pytest.approx(
            sum(s.seconds for s in steps.values()) / (2 * nimg_step) * 1e3, rel=1e-6)
    assert rows[0]["Timing/loader_wait_sec"] == 0


# -- the benchmark's readers -----------------------------------------------------------------

@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("bench"))


def _read(checkout, tmp_path, cell, out, t_start=0.0):
    _, cell_entry, config, traffic = harness.load_cell(checkout, cell)
    run = harness.Run(root=checkout, workload=cell, cell=cell_entry, config=config,
                      traffic=traffic, seed=1, seconds=0, trace=True,
                      device=torch.device("cpu"), tmp=tmp_path, t_start=t_start)
    return {n: harness.load_reader(checkout / "port_bench", n)(out, run) for n in READERS}


@pytest.fixture(scope="module")
def two_runs(checkout):
    """Two runs of the tiny cell in one process (1-batch windows): each
    run's start, its outcome, and the spans held after both."""
    drain()
    runs = []
    for seed in (2 ** 31 + 99, 2 ** 33 + 7):
        t_start = time.perf_counter()
        _, out, _ = harness.run_cell(checkout, "tiny_base", seed, 0.0, False, device="cpu",
                                     t_start=t_start)
        runs.append((t_start, out))
    return runs, drain()


@pytest.fixture
def held(two_runs, monkeypatch):
    """The recorder holding what it held after the two runs."""
    runs, recorded = two_runs
    monkeypatch.setattr(trace_mod, "_finished", collections.deque(recorded,
                                                                  maxlen=trace_mod.MAX_SPANS))
    return runs, recorded


def test_the_span_readers_on_a_tiny_cell(checkout, held, tmp_path):
    """A window of one batch (0 s): the warm batch, and neither a second
    window batch for the loader's steady wait nor a pair of batches to read
    an interval from."""
    (_, _), (t_start, out) = held[0]
    recorded = bench_spans.recorded(SimpleNamespace(t_start=t_start))
    (batch,) = bench_spans.window(recorded, 4)
    assert batch.attrs["batch_idx"] == 0 and batch.attrs["rows"] == out.attempted == 4
    assert 0 < batch.seconds <= out.window_s         # the window holds its batch
    first = bench_spans.first_batch(recorded)
    assert first.attrs["num_steps"] == 2 and first.attrs["call"] != batch.attrs["call"]
    assert bench_spans.parts(recorded, batch)["loader.wait"][0].seconds >= 0
    got = _read(checkout, tmp_path, "tiny_base", out, t_start)
    assert got == {"between_batches_ms.sample": None, "loader_wait_ms.sample": None,
                   "first_batch_s.setup": pytest.approx(first.seconds)}
    assert first.seconds > 0

    drain()                                           # no spans: no window, no first batch
    assert _read(checkout, tmp_path, "tiny_base", out, t_start) == dict.fromkeys(READERS)


def test_a_run_reads_its_own_spans_alone(checkout, held, tmp_path):
    """Two runs in one process: each run's readers see the spans that began
    after its start, so the second run's first batch is its own warm call,
    not the process's first."""
    ((t1, out1), (t2, out2)), recorded = held
    warm = sorted((s for s in recorded if s.name == "generate.batch"
                   and s.attrs["num_steps"] == 2), key=lambda s: s.start)
    assert len(warm) == 2 and warm[0].start < t2 * 1e9 <= warm[1].start
    first = bench_spans.first_batch(bench_spans.recorded(SimpleNamespace(t_start=t1)))
    second = bench_spans.first_batch(bench_spans.recorded(SimpleNamespace(t_start=t2)))
    assert first is warm[0] and second is warm[1]
    for t_start, out, batch in ((t1, out1, warm[0]), (t2, out2, warm[1])):
        got = _read(checkout, tmp_path, "tiny_base", out, t_start)
        assert got["first_batch_s.setup"] == pytest.approx(batch.seconds)
    (window,) = bench_spans.window(bench_spans.recorded(SimpleNamespace(t_start=t2)), 4)
    assert window.start >= t2 * 1e9 and window.attrs["call"] != warm[1].attrs["call"]
    assert len(bench_spans.window(bench_spans.recorded(ALL_SPANS), 4)) == 1


def test_the_span_readers_on_a_window_of_three_batches(checkout, data, tmp_path):
    """The window is the call with the most complete batches at the cell's
    steps; the interval runs from one batch's decode to the next's sample,
    and the loader's wait is the mean of the batches after the window's
    first."""
    net = _net(seed=1)
    drain()
    for seeds, steps in ((range(2), 2), (range(6), 4), (range(4), 4)):
        list(generate_images_nvs(net, seeds=seeds, max_batch_size=2, datakwargs={"path": data},
                                 num_steps=steps, verbose=False, device="cpu"))
    recorded = bench_spans.recorded(ALL_SPANS)
    window = bench_spans.window(recorded, 4)
    assert [b.attrs["batch_idx"] for b in window] == [0, 1, 2]
    assert len({b.attrs["call"] for b in window}) == 1
    gaps = []
    for a, b in zip(window, window[1:]):
        decode = bench_spans.parts(recorded, a)["generate.decode"][0]
        sample = bench_spans.parts(recorded, b)["generate.sample"][0]
        gaps.append((sample.start - decode.end) / 1e6)
    waits = [bench_spans.parts(recorded, b)["loader.wait"][0].seconds * 1e3 for b in window]
    got = _read(checkout, tmp_path, "tiny_base", None)
    assert all(g > 0 for g in gaps)
    assert got["between_batches_ms.sample"] == pytest.approx(sum(gaps) / 2)   # median of two
    assert got["loader_wait_ms.sample"] == pytest.approx(sum(waits[1:]) / 2)
    first = min((s for s in recorded if s.name == "generate.batch"), key=lambda s: s.start)
    assert first.attrs["num_steps"] == 2
    assert got["first_batch_s.setup"] == pytest.approx(first.seconds)
