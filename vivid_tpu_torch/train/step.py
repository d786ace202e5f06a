"""The training step: loss, backward, Adam and the EMA updates.

Counterpart of vivid_tpu/train/step.py `make_train_step`, in the same order:
per microbatch the elementwise loss is clamped to mean +- 3 std (fp64
moments) and summed as
`sum * loss_scaling / b`; gradients accumulate over `num_accum` microbatches
and are divided by it; NaN and inf gradients are set to 0 (`force_finite`);
the global norm over all gradients (fp32) clips them by
min(1, clip / (norm + 1e-12)); the learning rate is the schedule at
`cur_nimg` before the increment; Adam has bias correction and eps outside
the root (hand-rolled on `torch._foreach_*`, the arithmetic of
torch.optim.Adam); optional forced weight normalisation; then
`cur_nimg += batch_size * nimg_mult` and every power-function EMA moves with
t_delta = batch_size (not batch_size * nimg_mult, as in the JAX package).

Unlike the JAX step this one updates its state in place. The Fourier
features are buffers of the net: they get no gradient, no Adam moments and
no EMA of their own.

Over several processes (`group`) each rank holds its share of the global
batch, equal shares or the step raises. The clamp's mean and std and the
reported loss and its std are the global batch's (one all-reduce of their
moments, `diffusion/loss.py` `global_moments`). Each rank scales its sum by
its own rows and the gradients are averaged over the ranks, so the step
takes sum / global batch, as the JAX step does. Under FSDP
(`core/sharding.py` `fsdp_shard`) parameters, gradients, moments and EMA
copies are DTensors sharded on dim 0: the optimizer and the EMAs work on
each rank's shards, FSDP has already averaged their gradients (the
replicated 0-dim gains are averaged here), and the global norm is taken
over every rank's shards.
"""

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch

from vivid_tpu_torch.core.sharding import (all_reduce_gradients, full_state_dict,
                                           is_sharded, load_full, local)
from vivid_tpu_torch.diffusion.loss import clamp_loss, global_moments
from vivid_tpu_torch.diffusion.lr import learning_rate_schedule
from vivid_tpu_torch.diffusion.phema import ema_update
from vivid_tpu_torch.nn.mp import force_weight_normalize


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int                       # global batch (pairs per step)
    loss_scaling: float = 1.0
    force_finite: bool = True
    clip_grad_norm: float = 1.0
    adam_betas: Tuple[float, float] = (0.9, 0.99)
    adam_eps: float = 1e-8
    ref_lr: float = 100e-4
    ref_batches: float = 70e3
    rampup_Mimg: float = 10.0
    ema_stds: Tuple[float, ...] = (0.050, 0.100)
    nimg_mult: int = 1                    # 6 in dual-source mode (the collate's)
    loss_clamp_3sigma: bool = True
    force_wn: bool = False                # forced weight normalisation per step
    num_accum: int = 1                    # gradient accumulation rounds


@dataclass
class TrainState:
    """The net holds the live parameters; `names`/`params` list them in
    `named_parameters()` order and the moments and EMA copies align with it."""
    net: torch.nn.Module
    names: List[str]
    params: List[torch.Tensor]
    adam_m: List[torch.Tensor]
    adam_v: List[torch.Tensor]
    emas: List[List[torch.Tensor]]        # one list per EMA std
    adam_step: int = 0
    cur_nimg: int = 0

    def ema_state_dict(self, index: int) -> Dict[str, torch.Tensor]:
        """The net's state_dict with the parameters of EMA copy `index`,
        every tensor whole (under FSDP a collective: call it on every rank)."""
        state = dict(self.net.state_dict())
        state.update(zip(self.names, self.emas[index]))
        return full_state_dict(state)

    def state_dict(self) -> dict:
        """What a training-state checkpoint holds, by reference name: the
        live tensors (not copies; whole tensors gathered from the shards
        under FSDP, a collective) and the two counters. The layout is the
        same with and without FSDP."""
        named = lambda ts: dict(zip(self.names, ts))
        return full_state_dict(dict(
            params=named(self.params), adam_m=named(self.adam_m),
            adam_v=named(self.adam_v), emas=[named(e) for e in self.emas],
            adam_step=int(self.adam_step), cur_nimg=int(self.cur_nimg)))

    def load_state_dict(self, data: dict):
        """Copy a `state_dict()` into this state's tensors, in place (into
        each rank's shards under FSDP)."""
        if len(data["emas"]) != len(self.emas):
            raise ValueError(f"checkpoint has {len(data['emas'])} EMA copies, "
                             f"the trainer tracks {len(self.emas)}")
        groups = [(k, getattr(self, k), data[k]) for k in ("params", "adam_m", "adam_v")]
        groups += [(f"emas[{i}]", e, s) for i, (e, s) in enumerate(zip(self.emas, data["emas"]))]
        with torch.no_grad():
            for key, tensors, saved in groups:
                if sorted(saved) != sorted(self.names):
                    raise ValueError(f"checkpoint {key}: names differ from the model's")
                for name, t in zip(self.names, tensors):
                    load_full(t, saved[name])
        self.adam_step = int(data["adam_step"])
        self.cur_nimg = int(data["cur_nimg"])


def init_train_state(net, cfg: TrainConfig) -> TrainState:
    names, params = map(list, zip(*net.named_parameters()))
    return TrainState(
        net=net, names=names, params=params,
        adam_m=[torch.zeros_like(p) for p in params],
        adam_v=[torch.zeros_like(p) for p in params],
        emas=[[p.detach().clone() for p in params] for _ in cfg.ema_stds])


def make_train_step(loss_fn: Callable, train_cfg: TrainConfig, group=None):
    """loss_fn(net, src, tgt, geometry, generator=...) -> elementwise loss.
    Returns step(state, batch, generator, **loss_kwargs) -> stats; batch
    holds "src", "tgt" and "geometry" with this process's rows (all
    `batch_size` of them without `group`), cut into `num_accum`
    microbatches of consecutive rows. `group`: the process group the global
    batch is split over (see the module docstring). The stats' loss and
    norm are 0-dim tensors on the net's device (reading them waits for it)."""
    cfg = train_cfg
    world = 1 if group is None else torch.distributed.get_world_size(group)

    def microbatch_loss(net, batch, generator, **loss_kwargs):
        loss = loss_fn(net, batch["src"], batch["tgt"], batch["geometry"],
                       generator=generator, **loss_kwargs)
        if loss.ndim > 0 and cfg.loss_clamp_3sigma:
            loss = clamp_loss(loss, group)
        b = batch["tgt"].shape[0]
        scalar = loss.sum() * (cfg.loss_scaling / b)
        _, mean, std = global_moments(loss, group)
        return scalar, mean, std

    def step(state: TrainState, batch, generator=None, **loss_kwargs):
        params = state.params
        for p in params:
            p.grad = None
        rows = batch["tgt"].shape[0]
        if group is not None and rows * world != cfg.batch_size:
            raise ValueError(f"this rank holds {rows} rows of the global batch of "
                             f"{cfg.batch_size} over {world} ranks: the ranks' shares "
                             f"must be equal")
        if rows % cfg.num_accum:
            raise ValueError(f"{rows} rows do not split into {cfg.num_accum} microbatches")
        micro = rows // cfg.num_accum
        loss_mean = loss_std = 0.0
        for i in range(cfg.num_accum):
            cut = slice(i * micro, (i + 1) * micro)
            mb = {k: batch[k][cut] for k in ("src", "tgt", "geometry")}
            kw = {k: v[cut] for k, v in loss_kwargs.items()}
            scalar, mean, std = microbatch_loss(state.net, mb, generator, **kw)
            scalar.backward()
            loss_mean = loss_mean + mean / cfg.num_accum
            loss_std = loss_std + std / cfg.num_accum

        with torch.no_grad():
            # A parameter the loss did not reach has a zero gradient.
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            sharded = [is_sharded(g) for g in grads]
            if group is not None and not all(sharded):
                # FSDP averaged its own shards' gradients in the backward pass.
                all_reduce_gradients([g for g, sh in zip(grads, sharded) if not sh], group)
            grads = [local(g) for g in grads]
            params = [local(p) for p in params]
            if cfg.num_accum > 1:
                torch._foreach_div_(grads, float(cfg.num_accum))
            if cfg.force_finite:
                for g in grads:
                    torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)
            # The global norm from each gradient's norm, squared and summed in
            # fp64: under FSDP the shards' squares over every rank, plus the
            # replicated gains' once. In fp64 the split does not show in the
            # fp32 result, so a sharded run clips as the plain one does.
            sq = torch.stack(torch._foreach_norm([g.float() for g in grads])).double().square()
            if any(sharded):
                shard_sq = sq[[i for i, sh in enumerate(sharded) if sh]].sum()
                torch.distributed.all_reduce(shard_sq, group=group)
                gnorm = torch.sqrt(shard_sq + sq[[i for i, sh in enumerate(sharded)
                                                  if not sh]].sum()).float()
            else:
                gnorm = torch.sqrt(sq.sum()).float()
            if cfg.clip_grad_norm is not None:
                torch._foreach_mul_(grads, torch.clamp(cfg.clip_grad_norm / (gnorm + 1e-12),
                                                       max=1.0))

            lr = learning_rate_schedule(state.cur_nimg, cfg.batch_size, ref_lr=cfg.ref_lr,
                                        ref_batches=cfg.ref_batches,
                                        rampup_Mimg=cfg.rampup_Mimg)
            b1, b2 = cfg.adam_betas
            adam_m, adam_v = [local(t) for t in state.adam_m], [local(t) for t in state.adam_v]
            state.adam_step += 1
            torch._foreach_mul_(adam_m, b1)
            torch._foreach_add_(adam_m, grads, alpha=1 - b1)
            torch._foreach_mul_(adam_v, b2)
            torch._foreach_addcmul_(adam_v, grads, grads, value=1 - b2)
            bc1 = 1 - b1 ** state.adam_step
            bc2 = 1 - b2 ** state.adam_step
            denom = torch._foreach_sqrt(torch._foreach_div(adam_v, bc2))
            torch._foreach_add_(denom, cfg.adam_eps)
            torch._foreach_addcdiv_(params, adam_m, denom, value=-lr / bc1)

            if cfg.force_wn:
                force_weight_normalize(state.net)

            state.cur_nimg += cfg.batch_size * cfg.nimg_mult
            ema_update([[local(t) for t in e] for e in state.emas], params, state.cur_nimg,
                       cfg.batch_size, cfg.ema_stds)
        for p in state.params:
            p.grad = None
        return {"Loss/loss": loss_mean, "Loss/loss_std": loss_std,
                "Loss/learning_rate": lr, "Grad/global_norm": gnorm}

    return step
