"""Reader for the reference's torch persistence pickles.

The reference persists models as pickles whose reduce hook calls
`torch_utils.persistence._reconstruct_persistent_obj(meta)`, where `meta`
carries the defining module's full source, the class name and the object
state. Loading therefore normally needs the reference's package tree. This
module implements that documented protocol standalone, as
vivid_tpu/compat/torch_pickle.py does: an Unpickler maps the persistence
entry point to a local reconstructor that executes the pickle-embedded
source in a synthetic module, with the reference's own packages stubbed.

The reference's parameter names are the port's, in the same layouts (conv
OIHW, linear [out, in]), so the reconstructed net's `named_parameters()` and
`named_buffers()`, cast to fp32, load into `NVPrecond` with
`load_state_dict(strict=True)`: no name map and no transpose.

Like the reference loader, this executes code embedded in the pickle: load
only checkpoints you trust (the shipped vivid-*.pkl files).
"""

import linecache
import pickle
import sys
import types
import uuid
from typing import Dict

from vivid_tpu_torch.core.easydict import EasyDict
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig

ENCODER = "vivid_tpu.data.encoders.StandardRGBEncoder"   # the codec's registry name


class _StubSymbol:
    """Placeholder for a symbol the embedded source imports from a package
    that is not there (torch_utils, training, ...). Module-level code only
    needs such symbols to survive import and decorator application
    (`@persistence.persistent_class`); reconstruction never calls __init__ or
    forward, so anything else fails loudly when used."""

    def __init__(self, name):
        self._name = name

    def __call__(self, *args, **kwargs):
        if len(args) == 1 and isinstance(args[0], type) and not kwargs:
            return args[0]  # class decorator: pass the class through
        raise RuntimeError(
            f"stubbed reference symbol {self._name!r} called at runtime: "
            "the original package is required for this operation")

    def __getattr__(self, key):
        return _StubSymbol(self._name + "." + key)

    def __bool__(self):
        # Flag-like globals (the reference's VANILLA_MODE) default to off, as
        # the reference's module defaults do.
        return False


def _stub_module(name: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__path__ = []  # a package, so that submodule imports come here too
    # A real string __file__: inspect.getmodule walks all of sys.modules and
    # calls getfile on anything with a __file__; a synthesised value there
    # breaks unrelated imports.
    mod.__file__ = f"<{name} (vivid_tpu_torch compat stub)>"
    mod.__getattr__ = lambda key, _n=name: _StubSymbol(_n + "." + key)
    return mod


# Reference packages hidden while embedded source runs: with them visible,
# the source's own @persistence.persistent_class would run for real and
# register the synthetic module in the reference's source cache.
_ISOLATE_PKGS = ("torch_utils", "dnnlib", "training")

_SRC_MODULE_CACHE: Dict[str, types.ModuleType] = {}


def _src_to_module(src: str) -> types.ModuleType:
    """Execute pickle-embedded module source in a synthetic package, stubbing
    the reference's packages and any import that is missing (the reference's
    models.py imports a sibling module relatively and its own packages
    absolutely). Cached by source text: the persistent objects of one
    snapshot share one execution."""
    cached = _SRC_MODULE_CACHE.get(src)
    if cached is not None:
        return cached
    pkg_name = "_vivid_torch_compat_" + uuid.uuid4().hex
    sys.modules[pkg_name] = _stub_module(pkg_name)
    module_name = pkg_name + ".embedded"
    module = types.ModuleType(module_name)
    module.__package__ = pkg_name
    module.__file__ = module_name.replace(".", "/") + ".py"
    sys.modules[module_name] = module
    # So that inspect finds the synthetic module's source if asked later.
    linecache.cache[module.__file__] = (
        len(src), None, src.splitlines(keepends=True), module.__file__)

    hidden = {name: sys.modules.pop(name) for name in list(sys.modules)
              if name.split(".")[0] in _ISOLATE_PKGS}
    stubbed = []
    for name in _ISOLATE_PKGS:
        sys.modules[name] = _stub_module(name)
        stubbed.append(name)
    try:
        for _ in range(64):  # one missing import stubbed per try
            try:
                exec(src, module.__dict__)  # noqa: S102 - the documented persistence protocol
                _SRC_MODULE_CACHE[src] = module
                return module
            except ModuleNotFoundError as e:
                if e.name is None or e.name in sys.modules:
                    raise
                parts = e.name.split(".")
                for i in range(len(parts)):
                    name = ".".join(parts[: i + 1])
                    if name not in sys.modules:
                        sys.modules[name] = _stub_module(name)
                        stubbed.append(name)
        raise RuntimeError("embedded module source failed to import after stubbing")
    finally:
        # The module keeps its own references; the stubs leave sys.modules so
        # that they cannot shadow real packages, and what was hidden returns.
        for name in stubbed:
            sys.modules.pop(name, None)
        sys.modules.update(hidden)


def _reconstruct_persistent_obj(meta):
    meta = EasyDict(meta)
    module = _src_to_module(meta.module_src)
    cls = getattr(module, meta.class_name)
    obj = cls.__new__(cls)
    setstate = getattr(obj, "__setstate__", None)
    if callable(setstate):
        setstate(meta.state)
    else:
        obj.__dict__.update(meta.state)
    return obj


class _ReferenceUnpickler(pickle.Unpickler):
    """Sends the persistence entry point and dnnlib's EasyDict to local
    stand-ins, so that the reference package need not be importable."""

    def find_class(self, module, name):
        if name == "_reconstruct_persistent_obj":
            return _reconstruct_persistent_obj
        if module.startswith("dnnlib") and name == "EasyDict":
            return EasyDict
        return super().find_class(module, name)


def load_reference_module(path: str):
    """Unpickle a reference snapshot -> its dict: the torch net under 'ema'
    (or 'net'), and 'encoder', 'dataset_kwargs', 'loss_fn'."""
    with open(path, "rb") as f:
        return _ReferenceUnpickler(f).load()


def extract_config(net) -> dict:
    """PrecondConfig keyword arguments from a reconstructed reference
    NVPrecond: its init arguments, which the persistence wrapper records (the
    `init_kwargs` property, or the `_init_kwargs` field of the state, which
    is what a net reconstructed from the embedded source carries). The
    source count follows the target label: 40 is two sources of 20."""
    kwargs = dict(getattr(net, "init_kwargs", None)
                  or getattr(net, "_init_kwargs", None) or {})
    mapped = dict(
        img_resolution=kwargs.get("img_resolution", getattr(net, "img_resolution", 64)),
        img_channels=kwargs.get("img_channels", getattr(net, "img_channels", 3)),
        source_label_dim=kwargs.get("source_label_dim", 20),
        target_label_dim=kwargs.get("target_label_dim", 40),
        sigma_data=kwargs.get("sigma_data", 0.5),
        logvar_channels=kwargs.get("logvar_channels", 128),
        super_res=bool(kwargs.get("super_res", False)),
        no_time_enc=bool(kwargs.get("no_time_enc") or False),
        depth_input=bool(kwargs.get("depth_input", False)),
        warp_depth_coor=bool(kwargs.get("warp_depth_coor", False)),
        uncond=bool(kwargs.get("uncond") or False),
        noisy_sr=kwargs.get("noisy_sr", 0.25),
        model_channels=kwargs.get("model_channels", 192),
        channel_mult=tuple(kwargs.get("channel_mult", (1, 2, 3, 4))),
        channel_mult_noise=kwargs.get("channel_mult_noise"),
        channel_mult_emb=kwargs.get("channel_mult_emb"),
        num_blocks=kwargs.get("num_blocks", 3),
        attn_resolutions=tuple(kwargs.get("attn_resolutions", (16, 8))),
        extra_attn=kwargs.get("extra_attn"),
        epipolar_attention_bias=bool(kwargs.get("epipolar_attention_bias", False)),
        channels_per_head=kwargs.get("channels_per_head", 64),
        dropout=kwargs.get("dropout", 0.0),
    )
    mapped["num_sources"] = 2 if mapped["target_label_dim"] == 40 else 1
    return mapped


def verify_state_against_config(state, cfg: PrecondConfig, origin: str = "<pickle>"):
    """Hold a state dict's names and shapes to those of NVPrecond(cfg).
    extract_config defaults any init argument it does not find, so a renamed
    or missing one would build a net of other shapes and fail far from the
    cause; this names every missing, unexpected and mis-shaped entry."""
    want = {k: tuple(v.shape) for k, v in NVPrecond(cfg, device="meta").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    problems = [f"missing entry {k} (want {want[k]})" for k in sorted(set(want) - set(got))]
    problems += [f"unexpected entry {k} {got[k]}" for k in sorted(set(got) - set(want))]
    problems += [f"shape mismatch {k}: got {got[k]}, want {want[k]}"
                 for k in sorted(set(got) & set(want)) if got[k] != want[k]]
    if problems:
        head = "\n  ".join(problems[:12])
        more = f"\n  ... and {len(problems) - 12} more" if len(problems) > 12 else ""
        raise ValueError(
            f"{origin}: the weights do not match the derived config ({len(problems)} "
            f"problems); the pickle's init_kwargs are probably missing or renamed "
            f"fields:\n  {head}{more}")


def snapshot_from_reference(data, origin: str = "<pickle>", device="cpu") -> EasyDict:
    """An unpickled reference snapshot (`load_reference_module`'s dict) ->
    what `train.snapshots.load_snapshot` returns: EasyDict(net=NVPrecond on
    `device` in eval mode, cfg, encoder, dataset_kwargs, loss_kwargs). Takes
    the 'ema' net, else 'net'; fp16 weights load as fp32."""
    ref = data.get("ema", data.get("net")) if isinstance(data, dict) else None
    if ref is None:
        raise ValueError(f"no 'ema' or 'net' entry in {origin!r}")
    cfg = PrecondConfig(**extract_config(ref))
    state = {k: v.detach().float() for k, v in ref.named_parameters()}
    state.update({k: v.detach().float() for k, v in ref.named_buffers()})
    verify_state_against_config(state, cfg, origin=origin)
    net = NVPrecond(cfg, device="meta").to_empty(device=device)
    net.load_state_dict(state, strict=True)
    return EasyDict(net=net.eval().requires_grad_(False), cfg=cfg, encoder=ENCODER,
                    dataset_kwargs=dict(data.get("dataset_kwargs", {}) or {}),
                    loss_kwargs={})


def load_reference_pickle(path: str, device="cpu") -> EasyDict:
    """A reference pickle at `path` -> `snapshot_from_reference`'s EasyDict."""
    return snapshot_from_reference(load_reference_module(path), path, device=device)
