"""Ranks of the port's multi-process CPU tests (gloo), and the launcher that
starts them. Imports the port only, never JAX: each rank is a fresh spawned
process, and the tests compare what the ranks return with the JAX package in
the test process.

`run_ranks(job, world, tmp_path, **kwargs)` starts `world` processes, each of
which joins a gloo group through a FileStore under `tmp_path` (no port, so
tests running side by side cannot collide) by `dist.init(**init_kwargs)`
(device "cpu" unless `init_kwargs` say otherwise), calls `job(rank, world,
**kwargs)` and saves what it returns. A rank that raises sends its traceback
back; a job that outlives `timeout` seconds has its processes killed, and
the test fails.
"""

import contextlib
import multiprocessing
import os
import pickle
import traceback
from unittest import mock

import numpy as np
import torch

TIMEOUT = 120


def run_ranks(job, world, tmp_path, timeout=TIMEOUT, init_kwargs=None, **kwargs):
    """[what rank r's `job` returned for r in range(world)]."""
    init_kwargs = init_kwargs or dict(device="cpu")
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(str(tmp_path), f"store_{job.__name__}")
    if os.path.exists(store):
        os.remove(store)
    outs = [os.path.join(str(tmp_path), f"{job.__name__}_rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(job, r, world, store, outs[r], init_kwargs, kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise AssertionError(f"{job.__name__}: ranks {hung} still running after "
                                 f"{timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results, errors = [], []
    for r, (p, out) in enumerate(zip(procs, outs)):
        if not os.path.exists(out):
            errors.append(f"rank {r} exited with {p.exitcode} and no result")
            continue
        with open(out, "rb") as f:
            status, value = pickle.load(f)
        if status == "error":
            errors.append(f"rank {r} raised:\n{value}")
        results.append(value)
    if errors:
        raise AssertionError(f"{job.__name__}: " + "\n".join(errors))
    return results


def _rank_main(job, rank, world, store, out, init_kwargs, kwargs):
    os.environ.update(VIVID_COORDINATOR=f"file://{store}", VIVID_NUM_PROCESSES=str(world),
                      VIVID_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    from vivid_tpu_torch.core import dist
    try:
        dist.init(**init_kwargs)
        result = ("ok", job(rank, world, **kwargs))
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy().copy()
    return tree


# --- the training step ----------------------------------------------------

def _net(cfg_fields, params):
    from vivid_tpu_torch.compat.from_jax import from_jax
    from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
    net = NVPrecond(PrecondConfig(**cfg_fields))
    net.load_state_dict(from_jax(params), strict=True)
    return net


def step_job(rank, world, cfg, train_cfg, params, batches, draws, fsdp=False,
             per_rank_clamp=False, start_ckpt=None, save_ckpt=None, consistency=False):
    """Two steps of the port's data-parallel (or `fsdp`) step on this rank's
    half of each global batch and of its sigma / eps draws. Returns (rank 0)
    the state in the JAX layout, the step-1 gradients after the all-reduce
    (data parallel only), the stats, and what the consistency checks said.
    `per_rank_clamp` plants the fault of clamping with this rank's own
    statistics; `start_ckpt` starts from a checkpoint file instead of
    `params`; `save_ckpt` writes the end state there."""
    from vivid_tpu_torch.compat.from_jax import train_state_to_jax
    from vivid_tpu_torch.core import checkpoint, consistency as cons, dist, sharding
    from vivid_tpu_torch.diffusion import loss as loss_mod
    from vivid_tpu_torch.train import step as step_mod
    net = _net(cfg, params).train()
    if fsdp:
        sharding.fsdp_shard(net)
    tcfg = step_mod.TrainConfig(**train_cfg)
    state = step_mod.init_train_state(net, tcfg)
    if start_ckpt:
        checkpoint.CheckpointIO(state=state).load(start_ckpt)
    grads = []

    def spy(gs, group=None):
        sharding.all_reduce_gradients(gs, group)
        if not grads:
            grads.append([g.clone() for g in gs])

    step = step_mod.make_train_step(loss_mod.NVLoss(P_mean=-0.8, P_std=1.6), tcfg,
                                    group=dist.group())
    b = batches[0]["tgt"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    stats = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(step_mod, "all_reduce_gradients", spy))
        if per_rank_clamp:
            own = loss_mod.clamp_loss
            stack.enter_context(mock.patch.object(step_mod, "clamp_loss",
                                                  lambda loss, group=None: own(loss)))
        for batch, (sigma, eps) in zip(batches, draws):
            mine = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
            st = step(state, mine, sigma=torch.from_numpy(sigma[rows]),
                      eps=torch.from_numpy(eps[rows]))
            stats.append({k: float(v) for k, v in st.items()})
    if save_ckpt:
        checkpoint.CheckpointIO(state=state).save(save_ckpt)
    out = dict(state=train_state_to_jax(state), stats=stats,
               grads=dict(zip(state.names, numpy_tree(grads[0]))) if grads else None)
    if consistency:
        named = dict(zip(state.names, state.params))
        out["equal_passes"] = cons.check_param_consistency(named, "net params")
        if rank == 1:
            with torch.no_grad():
                w = sharding.local(state.params[0]).view(-1)
                w[0] = torch.nextafter(w[0], torch.tensor(float("inf")))
        try:
            cons.check_param_consistency(named, "net params")
            out["nudged"] = None
        except RuntimeError as err:
            out["nudged"] = str(err)
        out["fingerprint"] = cons.tree_fingerprint(named)
    return out if rank == 0 or consistency else None


# --- the trainer ------------------------------------------------------------

def trainer_job(rank, world, run_dir, data, net_kwargs, steps, fsdp=False):
    """The trainer on every rank: `steps` steps as a slice that ends with a
    checkpoint, then the same call again, which resumes and takes `steps`
    more. Returns the rows this rank's loader handed out, the files each
    rank wrote, the stats counts at the ticks and the final state's
    counters."""
    from vivid_tpu_torch.core import checkpoint, stats as stats_mod
    from vivid_tpu_torch.train import loop, snapshots
    rows, writes, counts = [], [], []

    class Recording(loop.BatchLoader):
        def __next__(self):
            batch = super().__next__()
            if self.batch_size == 1:   # the main loader's (one row a rank here)
                rows.append({k: np.asarray(v).copy() for k, v in batch.items()})
            return batch

    real_save, real_snap = checkpoint.torch.save, loop.save_snapshot
    real_as_dict = stats_mod.default_collector.as_dict

    def as_dict():
        snap = real_as_dict()
        if "Loss/loss" in snap:
            counts.append(snap["Loss/loss"].num)
        return snap

    nimg = 2 * 6   # global batch 2, dual source
    args = dict(run_dir=run_dir, dataset_kwargs={"path": data}, network_kwargs=net_kwargs,
                loss_kwargs=dict(P_mean=-0.8, P_std=1.6),
                lr_kwargs=dict(ref_lr=0.01, rampup_Mimg=0.0), seed=3, batch_size=2,
                status_nimg=nimg, snapshot_nimg=steps * nimg, checkpoint_nimg=nimg,
                slice_nimg=steps * nimg, device="cpu", fsdp=fsdp, deterministic=True)
    with mock.patch.object(loop, "BatchLoader", Recording), \
            mock.patch.object(checkpoint.torch, "save",
                              lambda obj, f: (writes.append(os.path.basename(f)),
                                              real_save(obj, f))), \
            mock.patch.object(loop, "save_snapshot",
                              lambda f, *a, **k: (writes.append(os.path.basename(f)),
                                                  real_snap(f, *a, **k))), \
            mock.patch.object(stats_mod.default_collector, "as_dict", as_dict):
        first = loop.training_loop(**args)
        second = loop.training_loop(**args)
    return dict(rows=rows, writes=writes, counts=counts,
                nimg=(first.state.cur_nimg, second.state.cur_nimg),
                steps=(first.state.adam_step, second.state.adam_step),
                snapshot_class=snapshots.SNAPSHOT_FORMAT)


def single_rows_job(rank, world, run_dir, data, singles, net_kwargs, steps):
    """`steps` steps of the trainer at a global batch of 4 with one row of
    each rank's two from single images (`single_image_mix`): the
    single-image rows this rank drew."""
    from vivid_tpu_torch.data.single_images import SingleImages
    from vivid_tpu_torch.train import loop
    rows = []

    class Recording(loop.BatchLoader):
        def __next__(self):
            batch = super().__next__()
            if isinstance(self.collate, SingleImages):
                rows.append({k: np.asarray(v).copy() for k, v in batch.items()})
            return batch

    with mock.patch.object(loop, "BatchLoader", Recording):
        loop.training_loop(run_dir=run_dir, dataset_kwargs={"path": data},
                           network_kwargs=net_kwargs, loss_kwargs=dict(P_mean=-0.8, P_std=1.6),
                           lr_kwargs=dict(ref_lr=0.01, rampup_Mimg=0.0), seed=3, batch_size=4,
                           max_steps=steps, status_nimg=None, snapshot_nimg=None,
                           checkpoint_nimg=None, samples_nimg=None, device="cpu",
                           single_image_mix=0.5, single_image_mix_path=singles,
                           deterministic=True)
    return rows


# --- tensor parallelism -------------------------------------------------------

def tp_job(rank, world, cases):
    """For each (config fields, JAX params, inputs, plant): D_x of one
    NVPrecond call under tensor parallelism over every rank; with `plant`
    also the same with each row-parallel weight slice normalised by itself
    (`MPConv.normalized_weight` taking the input-channel slice first).
    Returns the outputs, the blocks split, the attention blocks left whole
    and the head counts the plain attention versions were called with."""
    from vivid_tpu_torch.core import sharding
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.nn import mp
    from vivid_tpu_torch.nn.blocks import Block
    group, _, _, _ = sharding.tp_groups(world)
    real_norm = mp.MPConv.normalized_weight
    real_self, real_x = flash.flash_fused_packed_ref, flash.flash_fused_packed_xattn_ref
    heads = []

    def self_normalised(conv, dtype, gain=1.0, rows=None, cols=None):
        if cols is None:
            return real_norm(conv, dtype, gain, rows)
        part = mp.MPConv(1, 1, ())
        part.weight = torch.nn.Parameter(conv.weight[:, cols], requires_grad=False)
        return real_norm(part, dtype, gain, rows)

    results = []
    for cfg, params, inputs, plant in cases:
        net = sharding.tensor_parallel(_net(cfg, params), group)
        blocks = [(name, m) for name, m in net.named_modules() if isinstance(m, Block)]
        args = [torch.from_numpy(a) for a in inputs]
        heads.clear()
        with torch.no_grad(), \
                mock.patch.object(flash, "flash_fused_packed_ref",
                                  lambda qkv, h, *a: (heads.append(h), real_self(qkv, h, *a))[1]), \
                mock.patch.object(flash, "flash_fused_packed_xattn_ref",
                                  lambda qkv, f, h, *a: (heads.append(h),
                                                         real_x(qkv, f, h, *a))[1]):
            out = net(*args).numpy()
        try:   # tensor parallelism is for evaluation: a training forward is refused
            net.train()(*args)
            refused = None
        except RuntimeError as err:
            refused = str(err)
        net.eval()
        faulty = None
        if plant:
            with torch.no_grad(), mock.patch.object(mp.MPConv, "normalized_weight",
                                                    self_normalised):
                faulty = net(*args).numpy()
        results.append(dict(
            out=out, faulty=faulty, heads=sorted(set(heads)), train_refused=refused,
            split=sorted(n for n, m in blocks if m.tp is not None),
            whole_attention=sorted(n for n, m in blocks if m.tp is None and m.cfg.num_heads)))
    return results


def tp_generate_job(rank, world, net, gnet, data, outdir, seeds, num_steps):
    """Guided sampling through `generate_images_nvs` with tp = world: the
    latents every rank sampled (taken from the sampler), what each rank
    yielded, and the PNGs written."""
    from vivid_tpu_torch import generate
    from vivid_tpu_torch.core.easydict import EasyDict
    from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
    from vivid_tpu_torch.compat.from_jax import from_jax

    def load(snap):
        cfg = PrecondConfig(**snap["cfg"])
        m = NVPrecond(cfg)
        m.load_state_dict(from_jax(snap["params"]), strict=True)
        return EasyDict(net=m.eval().requires_grad_(False), cfg=cfg)

    sampled = []
    real = generate.edm_sampler

    def spy(*a, **kw):
        out = real(*a, **kw)
        sampled.append(out.numpy().copy())
        return out

    with mock.patch.object(generate, "edm_sampler", spy):
        rows = [dict(seeds=list(r.seeds), images=None if r.images is None else r.images.copy())
                for r in generate.generate_images_nvs(
                    net=load(net), gnet=load(gnet), guidance=1.5, seeds=seeds,
                    max_batch_size=len(seeds), num_steps=num_steps, outdir=outdir,
                    datakwargs={"path": data}, device="cpu", verbose=False, tp=world)]
    return dict(sampled=sampled, rows=rows)


# --- metrics ----------------------------------------------------------------

def metrics_job(rank, world, snapshot, data, seeds, num_steps):
    """`calculate_metrics gen`'s statistics over every rank, the two host
    reductions (`all_reduce_sum`, the stats collector) and `broadcast_object`
    under gloo, a suspend requested on rank 1 alone as every rank sees it,
    and the group's backend."""
    from vivid_tpu_torch.core import dist, stats as stats_mod
    from vivid_tpu_torch.generate import generate_images_nvs
    from vivid_tpu_torch.metrics.stats import calculate_stats_for_iterable_nvs
    summed = dist.all_reduce_sum(np.array([rank + 1.0, 10.0]))
    stats = stats_mod.Stats()
    collector = stats_mod.Collector(stats)
    stats.report("x", [float(rank)])
    collector.update()
    moments = dict(collector.as_dict()["x"])
    shared = dist.broadcast_object({"from": rank})
    if rank == 1:   # a SIGTERM on one rank suspends every rank at the tick
        dist.request_suspend()
    suspend = dist.sync_suspend()
    images = generate_images_nvs(net=snapshot, seeds=seeds, max_batch_size=2,
                                 num_steps=num_steps, datakwargs={"path": data},
                                 device="cpu", verbose=False)
    r = ref = None
    for r, ref in calculate_stats_for_iterable_nvs(images, metrics=["stub_fid", "psnr"],
                                                   verbose=False, device="cpu"):
        pass
    return dict(summed=summed, moments=moments, shared=shared, suspend=suspend, stats=r.stats,
                ref=ref.stats, backend=torch.distributed.get_backend())
