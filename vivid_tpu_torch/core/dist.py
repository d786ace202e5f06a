"""Process-group helpers and the suspend contract, for one process.

Counterpart of vivid_tpu/core/dist.py. Rank and world size come from
`torch.distributed` when a process group is initialised (0 and 1
otherwise); initialising one over NCCL is not ported yet. `all_reduce_sum`
sums host arrays over the group (the metrics' moments). `init()` installs
a SIGTERM handler that asks the trainer to suspend: at its next status tick
the trainer writes a training-state checkpoint and returns. A handler that
was installed before it is called too.
"""

import signal

import numpy as np
import torch

_should_suspend = False
_should_stop = False
_chained_handler = None   # the Python SIGTERM handler that was there before init()


def init():
    """Install the SIGTERM handler (from the main thread) and clear any
    suspend left over from an earlier run in this process. A Python handler
    that was installed before is still called after it, so that the process's
    other users of SIGTERM keep their signal."""
    global _should_suspend, _should_stop, _chained_handler
    _should_suspend = _should_stop = False
    try:
        previous = signal.getsignal(signal.SIGTERM)
        if previous is not _handle_preemption:
            _chained_handler = previous if callable(previous) else None
        signal.signal(signal.SIGTERM, _handle_preemption)
    except (ValueError, OSError):
        pass  # not in the main thread


def _handle_preemption(signum, frame):
    request_suspend()
    if _chained_handler is not None:
        _chained_handler(signum, frame)


def _group():
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def get_rank() -> int:
    return torch.distributed.get_rank() if _group() else 0


def get_world_size() -> int:
    return torch.distributed.get_world_size() if _group() else 1


def print0(*args, **kwargs):
    if get_rank() == 0:
        print(*args, **kwargs)


def all_reduce_sum(x):
    """The sum of numpy `x` over the process group, as float64 (`x` itself
    with one process)."""
    if get_world_size() == 1:
        return x
    t = torch.as_tensor(np.asarray(x, np.float64))
    torch.distributed.all_reduce(t)
    return t.numpy()


def barrier():
    if get_world_size() > 1:
        torch.distributed.barrier()


def should_stop() -> bool:
    return _should_stop


def should_suspend() -> bool:
    return _should_suspend


def request_suspend():
    global _should_suspend
    _should_suspend = True


def update_progress(cur, total):
    pass  # a hook for external schedulers; a no-op, as in the reference
