"""Power-function EMA (EDM2): the profile algebra, the online update and
the post-hoc reconstruction.

Counterpart of vivid_tpu/diffusion/phema.py. An EMA with
exponent g realised at training time T weights the parameter trajectory by
p(t) = (g + 1) t^g / T^(g + 1); its width is given as the profile's relative
standard deviation `std`, and one step of the online tracker is

    beta = (1 - dt / t) ** (std_to_exp(std) + 1)
    ema <- ema + (1 - beta) * (p - ema)

The update runs in place on lists of tensors. The profile algebra, the
solver and the reconstruction's sums are fp64 on the host, as in the JAX
package: the coefficients mix large values of both signs.
"""

import os
import re

import numpy as np
import torch

from vivid_tpu_torch.core.easydict import EasyDict


def exp_to_std(exp):
    """Relative width of the profile: var / T^2 = (g+1) / ((g+2)^2 (g+3))."""
    g = np.asarray(exp, np.float64)
    m1 = (g + 1) / (g + 2)
    m2 = (g + 1) / (g + 3)
    return np.sqrt(m2 - m1 * m1)


def std_to_exp(std):
    """Inverse of `exp_to_std`: the largest real root of
    g^3 + 7 g^2 + (16 - std^-2) g + (12 - std^-2) = 0."""
    std = np.asarray(std, np.float64)
    out = np.empty(std.shape, np.float64)
    flat = out.reshape(-1)
    for i, sigma in enumerate(std.reshape(-1)):
        c = 1.0 / (sigma * sigma)
        flat[i] = np.roots([1.0, 7.0, 16.0 - c, 12.0 - c]).real.max()
    return out


def power_function_response(ofs, std, length, axis=0):
    """The profile sampled on the grid t = 0..length-1 for an EMA realised
    at `ofs` with width `std`, renormalised over the grid."""
    ofs, std = np.broadcast_arrays(np.asarray(ofs, np.float64),
                                   np.asarray(std, np.float64))
    t_end = np.expand_dims(ofs, axis)
    g = np.expand_dims(std_to_exp(std), axis)
    shape = [1] * g.ndim
    shape[axis] = -1
    t = np.arange(length, dtype=np.float64).reshape(shape)
    resp = np.where(t <= t_end, (t / t_end) ** g, 0.0) * (g + 1) / t_end
    return resp / np.sum(resp, axis=axis, keepdims=True)


def power_function_correlation(a_ofs, a_std, b_ofs, b_std):
    """Inner product of two profiles over [0, min(Ta, Tb)]:
    (ga+1)(gb+1)/(ga+gb+1) * (Tm/Ta)^(ga+1) * (Tm/Tb)^(gb+1) / Tm, with the
    ratios <= 1 so that large offsets cannot overflow."""
    ga = std_to_exp(a_std)
    gb = std_to_exp(b_std)
    ta = np.asarray(a_ofs, np.float64)
    tb = np.asarray(b_ofs, np.float64)
    tm = np.minimum(ta, tb)
    amp = (ga + 1) * (gb + 1) / (ga + gb + 1)
    return amp * (tm / ta) ** (ga + 1) * (tm / tb) ** (gb + 1) / tm


def power_function_beta(std, t_next, t_delta):
    """Per-step decay that realises the profile online:
    (1 - t_delta / t_next) ** (std_to_exp(std) + 1)."""
    exponent = float(std_to_exp(np.float64(std)) + 1)
    return (1 - t_delta / t_next) ** exponent


def solve_posthoc_coefficients(in_ofs, in_std, out_ofs, out_std):
    """Least-squares weights of tracked profiles that reproduce target
    profiles: x = G^-1 b (G the tracked profiles' Gram matrix, b their
    inner products with each target), each column rescaled to sum to 1.
    Returns [num_in, num_out]."""
    in_ofs, in_std = np.broadcast_arrays(in_ofs, in_std)
    out_ofs, out_std = np.broadcast_arrays(out_ofs, out_std)
    col = lambda x: np.asarray(x, np.float64).reshape(-1, 1)
    row = lambda x: np.asarray(x, np.float64).reshape(1, -1)
    gram = power_function_correlation(col(in_ofs), col(in_std), row(in_ofs), row(in_std))
    cross = power_function_correlation(col(in_ofs), col(in_std), row(out_ofs), row(out_std))
    coef = np.linalg.solve(gram, cross)
    return coef / np.sum(coef, axis=0)


_SNAPSHOT_RE = re.compile(r"network-snapshot-(\d+)-(\d+\.\d+)\.pkl$")


def list_phema_snapshots(run_dir):
    """The trainer's per-std snapshot series in `run_dir`
    (`network-snapshot-{nimg//1000:07d}-{std:.3f}.pkl`) -> sorted
    [(nimg, std, path)]."""
    out = []
    for name in os.listdir(run_dir):
        m = _SNAPSHOT_RE.search(name)
        if m:
            out.append((int(m.group(1)) * 1000, float(m.group(2)), os.path.join(run_dir, name)))
    return sorted(out)


def reconstruct_phema(inputs, out_std, out_nimg=None, out_dir=None, verbose=True):
    """Post-hoc EMA (EDM2 Algorithm 3): a model at any EMA std from the
    tracked snapshot series, weighted by `solve_posthoc_coefficients`.

    inputs   : a run directory, a list of snapshot paths, or a list of
               (nimg, std, state_dict) triples.
    out_std  : target EMA std (float or list of floats).
    out_nimg : reconstruction point in images; defaults to the latest
               input's. Only inputs with 0 < nimg <= out_nimg contribute.
    out_dir  : if set, each result is written there as the snapshot
               `phema-{nimg//1000:07d}-{std:.3f}.pkl` (needs path inputs,
               whose snapshots carry the model config).

    Returns [EasyDict(params, std, nimg, path)] aligned with out_std;
    `params` is a state_dict of fp32 CPU tensors, summed in fp64."""
    if isinstance(inputs, str):
        inputs = list_phema_snapshots(inputs)
        if not inputs:
            raise ValueError("no network-snapshot-*-*.pkl series found")
    entries = []
    for item in inputs:
        if isinstance(item, str):
            m = _SNAPSHOT_RE.search(os.path.basename(item))
            if m is None:
                raise ValueError(f"cannot parse (nimg, std) from {item!r}")
            entries.append((int(m.group(1)) * 1000, float(m.group(2)), item))
        else:
            entries.append(tuple(item))
    entries.sort(key=lambda e: (e[0], e[1]))

    out_stds = [float(s) for s in np.atleast_1d(out_std)]
    if out_nimg is None:
        out_nimg = max(e[0] for e in entries)
    entries = [e for e in entries if 0 < e[0] <= out_nimg]
    if not entries:
        raise ValueError(f"no snapshots at nimg <= {out_nimg}")
    coef = solve_posthoc_coefficients(
        np.asarray([e[0] for e in entries], np.float64),
        np.asarray([e[1] for e in entries], np.float64),
        np.full(len(out_stds), float(out_nimg)), np.asarray(out_stds))   # [in, out]

    from vivid_tpu_torch.train.snapshots import load_snapshot
    acc = [None] * len(out_stds)
    model_cfg = None
    for i, (nimg, std, src) in enumerate(entries):
        if isinstance(src, str):
            snap = load_snapshot(src)
            state, model_cfg = snap.net.state_dict(), snap.cfg
            if verbose:
                print(f"  {os.path.basename(src)}: " + " ".join(f"{c:+.4f}" for c in coef[i]))
        else:
            state = src
        for j in range(len(out_stds)):
            c = float(coef[i, j])
            if acc[j] is None:
                acc[j] = {k: c * v.detach().cpu().double() for k, v in state.items()}
            else:
                for k, v in state.items():
                    acc[j][k].add_(v.detach().cpu().double(), alpha=c)

    results = []
    for j, std in enumerate(out_stds):
        params = {k: v.float() for k, v in acc[j].items()}
        path = None
        if out_dir is not None:
            if model_cfg is None:
                raise ValueError("out_dir needs snapshot-path inputs "
                                 "(in-memory state dicts carry no model config)")
            from vivid_tpu_torch.nn.precond import NVPrecond
            from vivid_tpu_torch.train.snapshots import save_snapshot
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"phema-{int(out_nimg) // 1000:07d}-{std:.3f}.pkl")
            save_snapshot(path, NVPrecond(model_cfg, device="meta"), state=params)
            if verbose:
                print(f"saved {path}")
        results.append(EasyDict(params=params, std=std, nimg=int(out_nimg), path=path))
    return results


def ema_update(emas, params, cur_nimg, batch_size, stds):
    """In place: emas[i] (a list of tensors aligned with `params`) moves
    towards `params` by 1 - beta(stds[i]) at t = max(cur_nimg, batch_size)."""
    with torch.no_grad():
        for std, ema in zip(stds, emas):
            beta = power_function_beta(std, max(float(cur_nimg), float(batch_size)),
                                       float(batch_size))
            torch._foreach_add_(ema, torch._foreach_sub(params, ema), alpha=1.0 - beta)


class PowerFunctionEMA:
    """One tracked copy of `params` (a list of tensors) per std."""

    def __init__(self, params, stds=(0.050, 0.100)):
        self.stds = list(stds)
        self.reset(params)

    def reset(self, params):
        self.emas = [[p.detach().clone() for p in params] for _ in self.stds]

    def update(self, params, cur_nimg, batch_size):
        ema_update(self.emas, list(params), cur_nimg, batch_size, self.stds)

    def get(self):
        """[(tensors, '-0.050'-style suffix)] for snapshot names."""
        return [(ema, f"-{std:.3f}") for std, ema in zip(self.stds, self.emas)]

    def state_dict(self):
        return dict(stds=self.stds, emas=self.emas)

    def load_state_dict(self, state):
        self.stds = list(state["stds"])
        self.emas = [list(e) for e in state["emas"]]


class TraditionalEMA:
    """Half-life EMA with ramp-up: beta = 0.5 ** (batch / halflife), the
    half-life in images min(halflife_Mimg, cur_nimg / 1e6 * rampup_ratio)
    millions."""

    def __init__(self, params, halflife_Mimg=float("inf"), rampup_ratio=0.09):
        self.halflife_Mimg = halflife_Mimg
        self.rampup_ratio = rampup_ratio
        self.reset(params)

    def reset(self, params):
        self.ema = [p.detach().clone() for p in params]

    def update(self, params, cur_nimg, batch_size):
        halflife = self.halflife_Mimg
        if self.rampup_ratio is not None:
            halflife = min(halflife, cur_nimg / 1e6 * self.rampup_ratio)
        beta = 0.5 ** (batch_size / max(halflife * 1e6, 1e-8))
        with torch.no_grad():
            torch._foreach_add_(self.ema, torch._foreach_sub(list(params), self.ema),
                                alpha=1.0 - beta)

    def get(self):
        return [(self.ema, "")]

    def state_dict(self):
        return dict(ema=self.ema, halflife_Mimg=self.halflife_Mimg,
                    rampup_ratio=self.rampup_ratio)

    def load_state_dict(self, state):
        self.ema = list(state["ema"])
        self.halflife_Mimg = state.get("halflife_Mimg", self.halflife_Mimg)
        self.rampup_ratio = state.get("rampup_ratio", self.rampup_ratio)
