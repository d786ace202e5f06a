"""Training-state checkpoints: save, load, resume from the latest.

Counterpart of vivid_tpu/core/checkpoint.py, with the same file names
(`training-state-{kimg:07d}.pt`) and the same rule for the latest one. A
holder gathers named state objects (a `state_dict()` provider, or a plain
tree of dicts and lists) into one file written by `torch.save` from CPU
tensors, atomically: a `.tmp` file, then `os.replace`. Torn `.pt.tmp`
files of a run killed while writing are removed when the latest
checkpoint is looked up.

`save(path, async_=True)` copies every tensor to host tensors the holder
owns (pinned, and kept for the next save), in one pass on the current
stream, and returns; over several processes every rank gathers the state
(the trainer's `state_dict()` gathers FSDP shards whole) and rank 0 alone
copies and writes; a background thread waits for the copies and writes
the file while training goes on. The trainer updates its state in place on
the same stream, after the copies, so the file holds the state as it was
at the call. One write is in flight at a time: `save` and `wait` join the
previous one.
"""

import os
import re
import threading
import time
from typing import Optional

import torch

from vivid_tpu_torch.core import dist

_STATE_RE = re.compile(r"training-state-(\d+)\.pt")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class CheckpointIO:
    """Holds named state providers: objects with `state_dict()` /
    `load_state_dict()`, or trees of dicts and lists of tensors."""

    def __init__(self, **objects):
        self.objects = objects
        self._host = None          # host copies, reused while the layout holds
        self._writer = None
        self.copy_seconds = self.write_seconds = None   # of the last save

    def _trees(self):
        return {name: obj.state_dict() if hasattr(obj, "state_dict") else obj
                for name, obj in self.objects.items()}

    def _copy_to_host(self, trees):
        """Issue the device-to-host copies; returns the host tree and an
        event (None on the CPU) that completes with them."""
        tensors = [t for t in _leaves(trees) if torch.is_tensor(t)]
        layout = [(t.shape, t.dtype) for t in tensors]
        cuda = any(t.is_cuda for t in tensors)
        if self._host is None or self._host[0] != layout:
            pin = cuda and torch.cuda.is_available()
            self._host = (layout, [torch.empty(s, dtype=d, pin_memory=pin) for s, d in layout])
        buffers = iter(self._host[1])

        def copy(x):
            if not torch.is_tensor(x):
                return x
            host = next(buffers)
            host.copy_(x.detach(), non_blocking=x.is_cuda)
            return host
        host_tree = _map(trees, copy)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        return host_tree, event

    def save(self, path: str, async_: bool = False):
        """Write the checkpoint: every rank gathers the state (whole tensors
        from sharded ones: a collective), rank 0 writes it; with `async_` the
        file is written by a background thread."""
        self.wait()
        t0 = time.perf_counter()
        trees = self._trees()
        if dist.get_rank() != 0:
            return
        host_tree, event = self._copy_to_host(trees)

        def write():
            if event is not None:
                event.synchronize()
            t1 = time.perf_counter()
            self.copy_seconds = t1 - t0
            tmp = path + ".tmp"
            torch.save(host_tree, tmp)
            os.replace(tmp, path)
            self.write_seconds = time.perf_counter() - t1

        if async_:
            self._writer = threading.Thread(target=write, daemon=True)
            self._writer.start()
        else:
            write()

    def wait(self):
        """Join the write in flight, if any."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def load(self, path: str) -> dict:
        data = load_checkpoint(path)
        for name, obj in self.objects.items():
            if name not in data:
                continue
            if hasattr(obj, "load_state_dict"):
                obj.load_state_dict(data[name])
            elif isinstance(obj, dict):
                obj.clear()
                obj.update(data[name])
            else:
                raise ValueError(f"Cannot restore checkpoint entry {name!r}")
        return data


def load_checkpoint(path: str) -> dict:
    """The file's tree of CPU tensors and plain values."""
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_checkpoint(run_dir: str) -> Optional[str]:
    """The highest-numbered training-state-*.pt in `run_dir` (None if there
    is none); removes torn *.pt.tmp files on the way."""
    if run_dir is None or not os.path.isdir(run_dir):
        return None
    best, best_idx = None, -1
    for fname in os.listdir(run_dir):
        if fname.endswith(".pt.tmp"):
            try:
                os.remove(os.path.join(run_dir, fname))
            except OSError:
                pass
            continue
        m = _STATE_RE.fullmatch(fname)
        if m and int(m.group(1)) > best_idx:
            best, best_idx = os.path.join(run_dir, fname), int(m.group(1))
    return best
