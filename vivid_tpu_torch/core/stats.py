"""Training statistics: per-name moment counters, drained per interval.

Counterpart of vivid_tpu/core/stats.py. `report()` adds values to
[count, sum, sum of squares] counters in fp64 (non-finite values count as
missing); `Collector.update()` drains them into the interval (one sum over
the process group, on its device, when there is one) and `as_dict()` gives each name's
mean, std and count.
"""

import re
from typing import Dict

import numpy as np
import torch

from vivid_tpu_torch.core import dist
from vivid_tpu_torch.core.easydict import EasyDict


class _Moments:
    __slots__ = ("num", "sum", "sumsq")

    def __init__(self):
        self.num = 0.0
        self.sum = 0.0
        self.sumsq = 0.0

    def add(self, values):
        v = np.asarray(values, np.float64).reshape(-1)
        finite = v[np.isfinite(v)]  # non-finite values are treated as missing
        self.num += finite.size
        self.sum += finite.sum()
        self.sumsq += np.square(finite).sum()

    def row(self):
        return np.array([self.num, self.sum, self.sumsq])


class Stats:
    """Per-process accumulator (module-level default below)."""

    def __init__(self):
        self._pending: Dict[str, _Moments] = {}

    def report(self, name: str, value):
        if torch.is_tensor(value):
            value = value.detach().double().cpu().numpy()
        self._pending.setdefault(name, _Moments()).add(value)
        return value

    def report0(self, name: str, value):
        """Report on rank 0 only."""
        if dist.get_rank() == 0:
            self.report(name, value)
        return value

    def report_dict(self, values: Dict[str, object]):
        for k, v in values.items():
            self.report(k, v)


class Collector:
    """update() drains the pending moments of the names that match `regex`;
    as_dict() returns and clears the interval's mean/std/num per name."""

    def __init__(self, stats: Stats, regex: str = ".*"):
        self.stats = stats
        self.regex = re.compile(regex)
        self._interval: Dict[str, np.ndarray] = {}

    def update(self):
        """Over several processes a collective: every rank calls it at the
        same point, and the names any rank reported are summed on all."""
        pending = self.stats._pending
        names = sorted(n for n in pending if self.regex.fullmatch(n))
        names = dist.all_names(names)
        if not names:
            return
        mat = np.stack([pending.pop(n).row() if n in pending else np.zeros(3)
                        for n in names])   # report() recreates on demand
        mat = dist.all_reduce_sum(mat)
        for n, row in zip(names, mat):
            self._interval[n] = self._interval.get(n, np.zeros(3)) + row

    def as_dict(self):
        out = EasyDict()
        for name in sorted(self._interval):
            num, s, ss = self._interval[name]
            if num > 0:
                mean = s / num
                var = max(ss / num - mean * mean, 0.0)
            else:
                mean = var = float("nan")
            out[name] = EasyDict(num=int(num), mean=float(mean), std=float(np.sqrt(var)))
        self._interval = {}
        return out


default_stats = Stats()
default_collector = Collector(default_stats)


def report(name, value):
    return default_stats.report(name, value)


def report0(name, value):
    return default_stats.report0(name, value)


def report_dict(values):
    default_stats.report_dict(values)
