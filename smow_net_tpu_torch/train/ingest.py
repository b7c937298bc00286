"""Reference (PyTorch) checkpoint ingestion for evaluation and warm-start
(port of smow_net_tpu/train/ingest.py).

The reference loads `best.pth` with an optional DataParallel `module.`
strip (reference test.py:97-102). The port's modules keep the reference's
parameter names and layouts, so for every ported model ingestion is that
strip and `load_state_dict`: the JAX package's converters are not needed.
Exposed as `cli.test --torch_ckpt best.pth` (evaluate a reference-trained
model) and `cli.train --torch_ckpt` (warm-start).
"""

from __future__ import annotations

import re
from typing import Dict

import torch

from ..models import _LATER, list_models
from .convert import DEAD_KEYS

__all__ = ["strip_module_prefix", "load_torch_state_dict", "supported_models",
           "ingest_torch_checkpoint"]


def strip_module_prefix(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop a DataParallel 'module.' prefix when every key carries it
    (reference test.py: ``{k[7:]: v for k, v in state_dict_multi.items()}``)."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .pth on the CPU -> name -> tensor dict, `module.` stripped. Accepts a
    raw state_dict, a {'state_dict': ...} wrapper or a pickled nn.Module.
    The file is unpickled in full (a pickled module needs it), which runs
    the code it names: load only checkpoints you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, torch.nn.Module):
        obj = obj.state_dict()
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict) and all(
            not isinstance(v, torch.Tensor) for k, v in obj.items() if k != "state_dict"):
        obj = obj["state_dict"]
    return strip_module_prefix({k: torch.as_tensor(v) for k, v in obj.items()})


def supported_models():
    return tuple(list_models())


def ingest_torch_checkpoint(model_name: str, path_or_sd, model: torch.nn.Module,
                            strict: bool = True) -> torch.nn.Module:
    """Load a reference-trained checkpoint (a path, or a name -> tensor dict)
    into the port's `model` of registry name `model_name`, in place, and
    return it. The keys of the reference's dead modules, which the port
    leaves out (convert.DEAD_KEYS), are dropped first; then strict=True
    requires every key of both sides to match."""
    if model_name in _LATER:
        raise NotImplementedError(f"{model_name!r} is not ported yet: {_LATER[model_name]}")
    if model_name not in supported_models():
        raise ValueError(f"no torch-checkpoint route for model {model_name!r}; "
                         f"supported: {', '.join(supported_models())}")
    if isinstance(path_or_sd, str):
        sd = load_torch_state_dict(path_or_sd)
    else:
        sd = strip_module_prefix({k: torch.as_tensor(v) for k, v in path_or_sd.items()})
    dead = DEAD_KEYS.get(model_name, ())
    sd = {k: v for k, v in sd.items() if not any(re.match(p, k) for p in dead)}
    model.load_state_dict(sd, strict=strict)
    return model
