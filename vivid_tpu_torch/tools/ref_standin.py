"""A stand-in for a reference checkout, for exporting reference-format
pickles where the reference's own tree is not at hand (tests, the card's
smoke run).

    from vivid_tpu_torch.tools.ref_standin import write_reference_standin
    root = write_reference_standin(tmp_dir)
    export_reference_pickle(path, net.state_dict(), net.cfg, reference_root=root)

`write_reference_standin(root)` writes, under `root`:

  * torch_utils/persistence.py: the documented persistence protocol and
    nothing else. `persistent_class` records the init arguments
    (`_init_kwargs`, and the `init_kwargs` property) and keeps the defining
    module's source; `__reduce__` gives
    `(torch_utils.persistence._reconstruct_persistent_obj, (meta,))` with
    meta's `module_src`, `class_name` and `state`.
  * training/models.py: `NVPrecond(**init_kwargs)`, a persistent subclass of
    the port's NVPrecond, so its state dict has the port's (the reference's)
    names and shapes. Its source imports a sibling module relatively and is
    decorated by `@persistence.persistent_class`, as the reference's is, so
    a reader must stub both.
  * training/encoders.py (`StandardRGBEncoder`) and training/training_loop.py
    (`NVLoss`, `SRNVLoss`), persistent too.

A pickle written through it holds the port's own submodules by reference, so
it loads where `vivid_tpu_torch` is importable. It is a fixture, not the
reference: it has no training code.
"""

import os

FILES = {
    "torch_utils/__init__.py": "",
    "torch_utils/persistence.py": '''\
"""The reference's persistence protocol: a persistent class pickles as its
defining module's source, its name and its state."""

import copy
import inspect
import sys
import types
import uuid

_version = 6
_src_to_module_dict = {}
_module_to_src_dict = {}


def persistent_class(orig_class):
    orig_module = sys.modules[orig_class.__module__]
    orig_module_src = _module_to_src(orig_module)

    class Decorator(orig_class):
        _orig_module_src = orig_module_src
        _orig_class_name = orig_class.__name__

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._init_args = copy.deepcopy(args)
            self._init_kwargs = copy.deepcopy(kwargs)

        @property
        def init_kwargs(self):
            return copy.deepcopy(self._init_kwargs)

        def __reduce__(self):
            meta = dict(type="class", version=_version, module_src=self._orig_module_src,
                        class_name=self._orig_class_name, state=dict(self.__dict__))
            return (_reconstruct_persistent_obj, (meta,))

    Decorator.__name__ = orig_class.__name__
    Decorator.__qualname__ = orig_class.__qualname__
    return Decorator


def _module_to_src(module):
    src = _module_to_src_dict.get(module)
    if src is None:
        src = inspect.getsource(module)
        _module_to_src_dict[module] = src
        _src_to_module_dict[src] = module
    return src


def _src_to_module(src):
    module = _src_to_module_dict.get(src)
    if module is None:
        name = "_imported_module_" + uuid.uuid4().hex
        module = types.ModuleType(name)
        sys.modules[name] = module
        _module_to_src_dict[module] = src
        _src_to_module_dict[src] = module
        exec(src, module.__dict__)
    return module


def _reconstruct_persistent_obj(meta):
    module = _src_to_module(meta["module_src"])
    cls = module.__dict__[meta["class_name"]]
    obj = cls.__new__(cls)
    setstate = getattr(obj, "__setstate__", None)
    if callable(setstate):
        setstate(meta["state"])
    else:
        obj.__dict__.update(meta["state"])
    return obj
''',
    "training/__init__.py": "",
    "training/custom_litdata_loader.py": "VANILLA_MODE = False\n",
    "training/models.py": '''\
"""NVPrecond with the reference's init arguments, on the port's modules."""

from torch_utils import persistence
from .custom_litdata_loader import VANILLA_MODE  # noqa: F401

from vivid_tpu_torch.nn.precond import NVPrecond as _PortNVPrecond, PrecondConfig


@persistence.persistent_class
class NVPrecond(_PortNVPrecond):
    def __init__(self, use_fp16=True, **kwargs):
        for key in ("channel_mult", "attn_resolutions"):
            if key in kwargs:
                kwargs[key] = tuple(kwargs[key])
        sources = 2 if kwargs.get("target_label_dim", 40) == 40 else 1
        super().__init__(PrecondConfig(use_bf16=use_fp16, num_sources=sources, **kwargs))
''',
    "training/encoders.py": '''\
"""The reference's pixel codec: [0, 255] <-> [-1, 1]."""

from torch_utils import persistence


@persistence.persistent_class
class StandardRGBEncoder:
    def encode_latents(self, x):
        return x / 127.5 - 1

    def decode(self, x):
        return ((x + 1) * 127.5).clip(0, 255)
''',
    "training/training_loop.py": '''\
"""The reference's losses, as persistent objects holding their settings."""

from torch_utils import persistence


@persistence.persistent_class
class NVLoss:
    def __init__(self, P_mean=-0.4, P_std=1.0, sigma_data=0.5):
        self.P_mean = P_mean
        self.P_std = P_std
        self.sigma_data = sigma_data


@persistence.persistent_class
class SRNVLoss(NVLoss):
    pass
''',
}


def write_reference_standin(root: str) -> str:
    """Write the stand-in checkout under `root`; returns `root`."""
    for rel, text in FILES.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return root
