"""Sampling traffic: whole batches of novel views through the program's
sampling entry (`generate_images_nvs`, the one behind its generate CLI), PNGs
written under the run's temporary directory, as the CLI writes them.

The mix (traffic/<name>.json): `batch` rows a batch, a tree of `scenes`
scenes written from the seed, and `check_batches` (the batch whose answers
are compared is drawn from the seed among the first ones). The
configuration gives the net, its guide, the Heun steps and the guidance
weight. Every seed sends the same work: the same sizes, in another order.

Correctness. The window's answers are the Heun steps' states. After the
window, for every row of one batch drawn from the seed: the start (the
program's first state against the seeded noise x sigma_max, exactly), and
two steps, one drawn from the seed and the last. At each, the
plain reference takes the program's state at the step's start and makes the
step itself (the guided denoiser, twice, and the Heun update) in float32,
and once more with every product's inputs rounded to bf16, the
configurations' precision. `step_gap` is the largest, over the checked
steps, of the distance between the program's states after the step and the
float32 reference's, over the distance of the bf16-rounded reference's,
both over all the checked rows: a sound bf16 program reads near 1, whatever
the seeded weights' sensitivity to rounding (which varies several times
over from seed to seed). The reference follows the program step by step from
its own states; the start is checked by itself, and the steps between are
the same function at other sigmas. Its inputs are worked out from the scene
files: each row's scene and views are found by their pixels, the camera
codes, the latents and (super-resolution) the conditioning image and its
noise computed again.
"""

import time

import numpy as np
import torch

from port_bench import program
from port_bench.counts.model import evaluation
from port_bench.harness import Outcome, Run, say
from port_bench.reference import sampling as ref
from port_bench.reference.model import NetSpec, Precond, bf16_round, fp8_round, set_quant
from port_bench.scenes import write_scenes
from port_bench.tracing import Tracer, hooked_ranges
from port_bench.weights import seeded_state

MAX_BATCHES = 1000     # seeds handed to the sampling entry: more batches than any window holds
TRACED_EVALS = 4       # guided evaluations in the traced slice
TRACE_FROM_CALL = 2    # the net call at which the traced slice starts
BLOCK_PIXELS = 1 << 18  # pixels of the rows of one reference block


class _StopSlice(Exception):
    pass


class Capture:
    """Forward pre-hook on the sampled net: the states at the calls that the
    check needs, and the sources of the first call (to find each row's
    scene). Reset with `begin` before each batch."""

    def __init__(self, calls):
        self.want = set(calls)
        self.calls = 0
        self.store = {}

    def begin(self):
        self.calls, self.store = 0, {}

    def __call__(self, module, args, kwargs):
        if self.calls == 0 and args[0] is not None:
            self.store["src"] = args[0].detach().clone()
        if self.calls in self.want:
            self.store[self.calls] = args[1].detach().float().clone()
        self.calls += 1


def _plant(fault, batch):
    """A forward hook that breaks the net's answers (the harness's tests)."""
    def hook(module, args, kwargs, out):
        x = args[1].float()
        if fault == "unchanged":                   # every state returned as it came
            return x
        if fault == "half":                        # half of the rows left out
            out = out.clone()
            out[batch // 2:] = x[batch // 2:]
            return out
        if fault == "altered":                     # one answer altered where it is made
            out = out.clone()
            out[0] = out[0] + 0.5 * out[0].square().mean().sqrt()
            return out
        raise ValueError(f"unknown fault {fault!r}")
    return hook


def _steps(rng, num_steps):
    """Two checked steps: one drawn from the seed, and the last."""
    return [int(rng.integers(num_steps - 1)), num_steps - 1]


def run(r: Run) -> Outcome:
    cfg, mix = r.config, r.traffic
    net_spec = NetSpec.from_json(cfg["net"])
    guide_spec = NetSpec.from_json(cfg["guide"]) if cfg.get("guide") else None
    num_steps = int(cfg["sampling"]["num_steps"])
    guidance = float(cfg["sampling"].get("guidance", 1.0))
    batch = int(mix["batch"])
    dev = r.device
    rng = np.random.default_rng([r.seed, 0x5A3])
    check_batch = int(rng.integers(int(mix["check_batches"])))
    steps = _steps(rng, num_steps)
    rng_seed = int(rng.integers(1 << 62))
    seed_base = int(rng.integers(1 << 40)) + 4 * batch   # warm and traced batches below it

    # Set-up: the scene tree, the seeded nets, one warm call at the window's shapes.
    views = net_spec.num_sources + 1
    index = write_scenes(str(r.tmp / "scenes"), r.seed, int(mix["scenes"]), views,
                         net_spec.resolution)
    net = program.build_net(net_spec, r.seed, "net", dev)
    gnet = program.build_net(guide_spec, r.seed, "guide", dev) if guide_spec else None
    kwargs = dict(max_batch_size=batch, verbose=False, datakwargs={"path": str(r.tmp / "scenes")},
                  guidance=guidance, rng_seed=rng_seed,
                  vanilla_mode=net_spec.num_sources == 1, device=dev)
    handles = []
    if r.fault:
        handles.append(net.net.register_forward_hook(_plant(r.fault, batch), with_kwargs=True))
    for _ in program.generate(net, gnet, outdir=str(r.tmp / "warm"),
                              seeds=range(seed_base - batch, seed_base), num_steps=2, **kwargs):
        pass
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    # The window: whole batches until --seconds have passed.
    calls = {0} | {2 * i for i in steps} | {2 * (i + 1) for i in steps if i < num_steps - 1}
    cap = Capture(calls)
    handles.append(net.net.register_forward_pre_hook(cap, with_kwargs=True))
    it = iter(program.generate(net, gnet, outdir=str(r.tmp / "png"),
                               seeds=range(seed_base, seed_base + batch * MAX_BATCHES),
                               num_steps=num_steps, **kwargs))
    t0 = time.perf_counter()
    setup_s = t0 - r.t_start
    images = batches = 0
    paces = []    # per batch: wall s, this thread's CPU s, the process's CPU s
    marks = (t0, time.thread_time(), time.process_time())
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
    kept = None
    try:
        while True:
            cap.begin()
            res = next(it)
            images += len(res.seeds)
            nonfinite += (~torch.isfinite(res.latents).flatten(1).all(1)).sum()
            if batches <= check_batch:   # the drawn batch, or the last if the window ends first
                kept = dict(cap.store, final=res.latents.float().clone(), seeds=list(res.seeds),
                            batch_idx=res.batch_idx, batch_rows=len(res.seeds))
            batches += 1
            now = (time.perf_counter(), time.thread_time(), time.process_time())
            paces.append(tuple(round(b - a, 3) for a, b in zip(marks, now)))
            marks = now
            window_s = now[0] - t0
            if window_s >= r.seconds:
                break
    finally:
        it.close()
    evals = batches * (2 * num_steps - 1)
    failed = int(nonfinite)
    say(f"window: {batches} batches, {images} images, {evals} evaluations in {window_s:.3f} s")
    say("window: each batch's (wall, main thread's CPU, process's CPU) s: " + repr(paces))

    flops, attn = evaluation(net_spec, guide_spec if guidance != 1 else None, batch)
    out = Outcome(setup_s=setup_s, e2e={"sample_img_s": images / window_s}, attempted=images,
                  failed=failed, checks={}, unit="eval", units=evals, window_s=window_s,
                  flops_per_unit=flops, attn_per_unit=attn, memory_peak_bytes=0)

    if r.trace:
        out.slice, out.launches_per_unit = _traced_slice(net, gnet, kwargs, seed_base, batch,
                                                         num_steps, guidance, r)
    for h in handles:
        h.remove()
    if dev.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    del net, gnet, it
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    block = max(1, BLOCK_PIXELS // net_spec.resolution ** 2)
    checks, control = _check(r, kept, index, net_spec, guide_spec, guidance, num_steps, steps,
                             rng_seed, block)
    out.checks, out.control = checks, control
    return out


def _traced_slice(net, gnet, kwargs, seed_base, batch, num_steps, guidance, r):
    """Profile TRACED_EVALS guided evaluations of one more batch, with host
    ranges around each net, its encoder and its denoiser; the program's
    kernel launches per evaluation."""
    tracer = Tracer()
    before = {}

    def gate(module, args, kwargs_):
        gate.calls += 1
        if gate.calls == TRACE_FROM_CALL + 1:
            before.update(program.launches())
            tracer.start()
        elif gate.calls == TRACE_FROM_CALL + TRACED_EVALS + 1:
            tracer.stop()
            raise _StopSlice
    gate.calls = 0
    modules = {"net": net.net, "net.denoiser": net.net.unet}
    if net.net.encoder is not None:
        modules["net.encoder"] = net.net.encoder
    if gnet is not None and guidance != 1:
        modules["guide"] = gnet.net
    handle = net.net.register_forward_pre_hook(gate, with_kwargs=True)
    it = iter(program.generate(net, gnet, outdir=str(r.tmp / "traced"),
                               seeds=range(seed_base - 2 * batch, seed_base - batch),
                               num_steps=num_steps, **kwargs))
    try:
        with hooked_ranges(tracer, modules):
            next(it)
    except _StopSlice:
        pass
    finally:
        handle.remove()
        it.close()
    after = program.launches()
    launches = {k: (after[k] - before.get(k, 0)) / TRACED_EVALS for k in after
                if after[k] != before.get(k, 0)}
    return tracer.slice(TRACED_EVALS), launches


def _rows_inputs(kept, index, spec: NetSpec, dev):
    """The sources, camera codes and (super-resolution) target latents of the
    kept batch's rows, worked out from the scene files; each row's scene and
    views found by its source pixels."""
    src_pix = torch.round((kept["src"].float() + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
    n_src = spec.num_sources
    views = n_src + 1
    srcs, codes, tgts = [], [], []
    for row in src_pix:
        found = [index.find(row[j]) for j in range(n_src)]
        scene = found[0][0]
        if any(s != scene for s, _ in found):
            raise KeyError("a row's sources come from different scenes")
        src_views = [v for _, v in found]
        tgt = next(v for v in range(views) if v not in src_views)
        srcs.append(index.images[scene, src_views])
        codes.append(np.stack([ref.camera_code(index.c2w[scene], index.fxfycxcy[scene], v, tgt,
                                               spec.resolution) for v in src_views]))
        tgts.append(index.images[scene, tgt])
    return (ref.encode_pixels(np.stack(srcs), dev), torch.as_tensor(np.stack(codes), device=dev),
            ref.encode_pixels(np.stack(tgts), dev))


def _check(r, kept, index, net_spec, guide_spec, guidance, num_steps, steps, rng_seed, block):
    """The compared numbers ({start_gap, step_gap}) and, with r.control, the
    fp8 control's, the control put in the program's place."""
    dev = r.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sigmas = ref.sigma_steps(num_steps)
    checks = {"start_gap": float("inf"), "step_gap": float("inf")}
    if kept is None:
        return checks, {}
    res = net_spec.resolution
    x0 = ref.seed_noise(kept["seeds"], (res, res, net_spec.img_channels), dev) * float(sigmas[0])
    checks["start_gap"] = float((kept[0] - x0).abs().max())
    try:
        src, codes, tgt = _rows_inputs(kept, index, net_spec, dev)
    except KeyError as e:
        say(f"check: a row of the program's batch matches no scene view ({e})")
        return checks, {}
    cond = noise = None
    if net_spec.super_res:
        cond = ref.low_res(tgt)
        gen = torch.Generator(device=dev).manual_seed(ref.fold_in(rng_seed, kept["batch_idx"]))
        noise = torch.randn((kept["batch_rows"],) + cond.shape[1:], generator=gen, device=dev)

    with torch.device(dev):
        net = Precond(net_spec)
        guide = Precond(guide_spec) if guide_spec is not None and guidance != 1 else None
    net.load_state_dict(seeded_state(net, r.seed, "net", dev))
    if guide is not None:
        guide.load_state_dict(seeded_state(guide, r.seed, "guide", dev))

    def states(quant):
        """[(program's states, reference's states, network parts)] for each
        checked step, all rows, the reference's products rounded by `quant`.
        A row's network part is the distance between the reference's state
        and the one the same step gives with the networks' outputs left out
        (D = c_skip x)."""
        set_quant(net, quant)
        if guide is not None:
            set_quant(guide, quant)
        out = []
        for i in steps:
            last = i == num_steps - 1
            t_cur, t_next = float(sigmas[i]), float(sigmas[i + 1])
            nexts, parts = [], []
            for a in range(0, src.shape[0], block):
                cut = slice(a, a + block)
                b = src[cut].shape[0]

                def denoise(x, t, cut=cut, b=b):
                    tt = torch.full((b,), t, device=dev)
                    d = net(src[cut], x, tt, codes[cut],
                            None if cond is None else cond[cut],
                            None if noise is None else noise[cut])
                    g = guide(None, x, tt, None) if guide is not None else None
                    return ref.guided(d, g, guidance)

                x_next, _ = ref.heun_step(denoise, kept[2 * i][cut], t_cur, t_next, last)
                x_skip, _ = ref.heun_step(skip, kept[2 * i][cut], t_cur, t_next, last)
                nexts.append(x_next)
                parts.append((x_next - x_skip).flatten(1).norm(dim=1))
            out.append((kept["final"] if last else kept[2 * (i + 1)], torch.cat(nexts),
                        torch.cat(parts)))
        return out

    def skip(x, t):
        return net_spec.sigma_data ** 2 / (t ** 2 + net_spec.sigma_data ** 2) * x

    def gaps(answers, exact, rounded):
        """step_gap: the largest over the checked steps of the distance of
        `answers` to the reference's states, over the same distance of the
        reference rounded to bf16 (every product's inputs), each over all
        the checked rows. A sound bf16 program reads near 1 whatever the
        seeded weights' sensitivity to rounding, which varies from seed to
        seed several times over; the absolute gaps, over the steps'
        network parts, go to the log."""
        ratio, absolute = [], []
        for (a, _, _), (_, x, part), (_, xr, _) in zip(answers, exact, rounded):
            dist = float((a - x).norm())
            ratio.append(dist / float((xr - x).norm()))
            absolute.append(dist / float(part.norm()))
        say(f"check: steps {steps} over bf16 rounding {ratio} over the network part {absolute}")
        return max(ratio)

    control = {}
    with torch.no_grad():
        exact = states(None)
        rounded = states(bf16_round)
        checks["step_gap"] = gaps(exact, exact, rounded)
        if r.control == "fp8":
            # the control's states in the program's place, judged as the program's are
            lowp = states(fp8_round)
            # the reference starts from the seeded noise itself
            control["start_gap"] = 0.0
            control["step_gap"] = gaps([(c, None, None) for _, c, _ in lowp], exact, rounded)
    return checks, control
