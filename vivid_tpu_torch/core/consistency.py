"""Cross-process consistency and numeric hygiene checks.

Counterpart of vivid_tpu/core/consistency.py:
  * `check_param_consistency`: every process hashes its parameters (a
    sha256 over names and bytes, sharded tensors gathered whole first); the
    digests are all-gathered and compared. The trainer runs it after each
    checkpoint over several processes, as the reference checks DDP replicas.
  * `assert_finite`: raise on NaN or inf, by name.
  * `debug_nans`: the trainer's `--debug-nans` (the JAX package's
    `jax_debug_nans`): autograd's anomaly mode, and a forward hook on every
    submodule that raises FloatingPointError naming the first module whose
    output holds a NaN.
"""

import contextlib
import hashlib

import numpy as np
import torch

from vivid_tpu_torch.core import dist
from vivid_tpu_torch.core.sharding import full_tensor


def tree_fingerprint(state_dict) -> str:
    """sha256 over the names (in order) and bytes of a dict of tensors; a
    DTensor is gathered whole first (a collective: call on every rank)."""
    h = hashlib.sha256()
    for name, t in state_dict.items():
        h.update(name.encode())
        whole = full_tensor(t.detach()).cpu().contiguous().reshape(-1)
        h.update(whole.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def check_param_consistency(state_dict, name: str = "params") -> bool:
    """True when every process holds the same bytes in `state_dict`; raises
    RuntimeError naming the tree, with each rank's digest prefix, when they
    differ."""
    fp = tree_fingerprint(state_dict)
    if dist.get_world_size() == 1:
        return True
    digest = torch.tensor(np.frombuffer(bytes.fromhex(fp), np.uint8).copy(),
                          device=dist.group_device())
    gathered = [torch.empty_like(digest) for _ in range(dist.get_world_size())]
    torch.distributed.all_gather(gathered, digest)
    rows = [bytes(g.cpu().numpy()) for g in gathered]
    if any(r != rows[0] for r in rows):
        raise RuntimeError(f"Cross-process divergence detected in {name!r}: "
                           f"{[r.hex()[:12] for r in rows]}")
    return True


def assert_finite(state_dict, name: str = "tree"):
    """Raise FloatingPointError naming the entries of `state_dict` that hold
    a NaN or an inf."""
    bad = [k for k, t in state_dict.items()
           if not bool(torch.isfinite(full_tensor(t.detach())).all())]
    if bad:
        raise FloatingPointError(f"Non-finite values in {name}: {bad[:10]}")
    return True


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


@contextlib.contextmanager
def debug_nans(**modules):
    """Within the block, autograd's anomaly mode (a backward function that
    returns a NaN raises) and a forward hook on every submodule of each
    named module: the first module whose output holds a NaN raises
    FloatingPointError naming it (`<name>.<path>`), as `jax_debug_nans`
    raises at the first operation. Each hook reads its output on the host,
    so a step runs far slower."""
    def hook_for(name):
        def hook(module, inputs, output):
            for t in _tensors(output):
                if t.is_floating_point() and bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"NaN in the output of module {name!r} ({type(module).__name__})")
        return hook

    handles = [sub.register_forward_hook(hook_for(f"{root}.{path}" if path else root))
               for root, module in modules.items() for path, sub in module.named_modules()]
    try:
        with torch.autograd.set_detect_anomaly(True):
            yield
    finally:
        for h in handles:
            h.remove()
