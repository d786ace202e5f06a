"""Objects by configuration name.

Counterpart of vivid_tpu/core/registry.py: `construct_class_by_name`
resolves a class path from a config (`encoder_kwargs` of the trainer),
`call_func_by_name` a function's; `register` names an object explicitly,
and a registered name resolves before any import.
The reference's names and the JAX package's (`vivid_tpu.*`) resolve to the
port's own modules, so a config written for either loads here and the port
never imports the JAX package.
"""

import importlib
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}

_ALIASES = {
    "training.models.NVPrecond": "vivid_tpu_torch.nn.precond.NVPrecond",
    "training.encoders.StandardRGBEncoder": "vivid_tpu_torch.data.encoders.StandardRGBEncoder",
    "training.training_loop.NVLoss": "vivid_tpu_torch.diffusion.loss.NVLoss",
    "training.training_loop.SRNVLoss": "vivid_tpu_torch.diffusion.loss.SRNVLoss",
    "training.training_loop.learning_rate_schedule":
        "vivid_tpu_torch.diffusion.lr.learning_rate_schedule",
    "training.phema.PowerFunctionEMA": "vivid_tpu_torch.diffusion.phema.PowerFunctionEMA",
    "training.phema.TraditionalEMA": "vivid_tpu_torch.diffusion.phema.TraditionalEMA",
    "datautils.RealEstate10K": "vivid_tpu_torch.data.re10k.RealEstate10K",
}


def register(name: str = None):
    """Decorator: register a class or function under a config name (by
    default its module path and qualified name)."""

    def deco(obj):
        _REGISTRY[name or f"{obj.__module__}.{obj.__qualname__}"] = obj
        return obj

    return deco


def get_obj_by_name(name: str) -> Any:
    if not isinstance(name, str):
        return name  # already an object
    name = _ALIASES.get(name, name)
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.startswith("vivid_tpu."):
        name = "vivid_tpu_torch." + name[len("vivid_tpu."):]
    parts = name.split(".")
    for split in range(len(parts) - 1, 0, -1):
        try:
            obj: Any = importlib.import_module(".".join(parts[:split]))
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        return obj
    raise ImportError(f"Cannot resolve object by name: {name!r}")


def construct_class_by_name(*args, class_name: str = None, **kwargs) -> Any:
    return get_obj_by_name(class_name)(*args, **kwargs)


def call_func_by_name(*args, func_name: str = None, **kwargs) -> Any:
    fn = get_obj_by_name(func_name)
    if not callable(fn):
        raise TypeError(f"{func_name!r} is not callable")
    return fn(*args, **kwargs)
