"""Process groups, the devices that go with them, and the suspend contract.

Counterpart of vivid_tpu/core/dist.py over `torch.distributed`. `init()`
builds the process group from the launcher's environment: `torchrun`'s
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT) or the JAX
package's (VIVID_COORDINATOR as host:port or an init-method URL such as
file:///shared/store, VIVID_NUM_PROCESSES, VIVID_PROCESS_ID; LOCAL_RANK if
set, else 0: one process a host). With one process it creates no group, and
rank and world size are 0 and 1. The backend is NCCL for a CUDA device;
gloo only for the CPU or when the caller names it. A start-up that fails
raises: there is no fallback to another backend.

Each process drives one card, `default_device()`: cuda:LOCAL_RANK.
`all_reduce_sum` and the training statistics reduce on the group's device
(`group_device()`: the card under NCCL, the host under gloo). `init()`
also installs a SIGTERM handler that asks the trainer to suspend: at its
next status tick `sync_suspend()` takes the request of any rank to every
rank (one all-reduce of the flag), and all of them write the checkpoint
together and return. A Python handler that was installed before is called
too.
"""

import os
import signal

import numpy as np
import torch

_should_suspend = False
_should_stop = False
_chained_handler = None   # the Python SIGTERM handler that was there before init()


def init(backend=None, device=None):
    """Install the SIGTERM handler (from the main thread), clear any suspend
    left over from an earlier run in this process, and, when the launcher's
    environment names more than one process and no group exists yet, create
    the process group. `device` is the one this process computes on (None:
    `default_device()`); it picks the backend unless `backend` names one."""
    global _should_suspend, _should_stop, _chained_handler
    _should_suspend = _should_stop = False
    try:
        previous = signal.getsignal(signal.SIGTERM)
        if previous is not _handle_preemption:
            _chained_handler = previous if callable(previous) else None
        signal.signal(signal.SIGTERM, _handle_preemption)
    except (ValueError, OSError):
        pass  # not in the main thread
    launch = _launch_env()
    if _group() or launch is None or launch[2] == 1:
        return
    init_method, rank, world = launch
    device = torch.device(device) if device is not None else default_device()
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
        if device.index is None:
            device = default_device()
        torch.cuda.set_device(device)
        kwargs["device_id"] = device   # start NCCL now: a failure shows here
    torch.distributed.init_process_group(backend, init_method=init_method, rank=rank,
                                         world_size=world, **kwargs)


def _launch_env():
    """(init_method, rank, world size) from the launcher's environment, or
    None when it names no group."""
    env = os.environ
    if "WORLD_SIZE" in env and "RANK" in env:
        return "env://", int(env["RANK"]), int(env["WORLD_SIZE"])
    coord = env.get("VIVID_COORDINATOR")
    if coord:
        url = coord if "://" in coord else f"tcp://{coord}"
        return (url, int(env.get("VIVID_PROCESS_ID", "0")),
                int(env.get("VIVID_NUM_PROCESSES", "1")))
    return None


def _handle_preemption(signum, frame):
    request_suspend()
    if _chained_handler is not None:
        _chained_handler(signum, frame)


def _group():
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def group():
    """The default process group when there is one (None otherwise): what
    the training step reduces its gradients and loss statistics over."""
    return torch.distributed.group.WORLD if _group() else None


def get_rank() -> int:
    return torch.distributed.get_rank() if _group() else 0


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def get_world_size() -> int:
    return torch.distributed.get_world_size() if _group() else 1


def num_devices() -> int:
    """CUDA cards this process sees (0 on a host without any)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_device() -> torch.device:
    """cuda:LOCAL_RANK; RuntimeError without a card, or with fewer cards
    than the local rank needs."""
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA card found; pass device="cpu" (--device cpu) '
                           "to run on the CPU")
    index = get_local_rank()
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {index} needs card {index}, but this host shows "
                           f"{torch.cuda.device_count()}")
    return torch.device("cuda", index)


def group_device(group=None) -> torch.device:
    """Where a collective of `group`'s backend takes its tensors: this
    process's card under NCCL, the host otherwise."""
    if torch.distributed.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def print0(*args, **kwargs):
    if get_rank() == 0:
        print(*args, **kwargs)


def all_reduce_sum(x):
    """The sum of numpy `x` over the process group, as float64, reduced on
    the group's device (`x` itself without a group)."""
    if not _group():
        return x
    t = torch.as_tensor(np.asarray(x, np.float64), device=group_device())
    torch.distributed.all_reduce(t)
    return t.cpu().numpy()


def all_names(names):
    """The sorted union of every rank's `names` (a list of strings)."""
    if get_world_size() == 1:
        return sorted(names)
    every = [None] * get_world_size()
    torch.distributed.all_gather_object(every, sorted(names))
    return sorted(set().union(*every))


def barrier(name: str = "barrier"):
    """Wait for every rank (`name` says which wait, in a traceback)."""
    if get_world_size() > 1:
        torch.distributed.barrier()


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s `obj` (picklable) on every rank."""
    if get_world_size() == 1:
        return obj
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=src, device=group_device())
    return box[0]


def should_stop() -> bool:
    return _should_stop


def should_suspend() -> bool:
    return _should_suspend


def request_suspend():
    global _should_suspend
    _should_suspend = True


def sync_suspend() -> bool:
    """Whether a suspend was requested on any rank (`should_suspend()` of
    each; one all-reduce of the flag); it then stands on every rank."""
    requested = should_suspend()
    if get_world_size() > 1:
        flag = torch.tensor([float(requested)], device=group_device())
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
        requested = bool(flag.item())
    if requested:
        request_suspend()
    return requested


def update_progress(cur, total):
    pass  # a hook for external schedulers; a no-op, as in the reference
