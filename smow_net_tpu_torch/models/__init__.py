"""Model registry of the port (mirrors smow_net_tpu.models.get_model).

Only SMOW_Net is ported so far; the other names of the JAX registry raise
NotImplementedError naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import torch

__all__ = ["get_model", "list_models"]

_MAMBA = ("rs_mamba", "change_mamba", "cd_mamba")
_ZOO = ("fc_ef", "snunet", "dtcdscn", "ifn", "bit", "pa_former", "afcf3d",
        "seifnet", "tfi_gr", "a2net", "elgcnet", "changeformer", "scratchformer")
_LATER = {"smow_net_lw": "ROADMAP.md section 1 step 8 (SMOW_Net_LW)",
          **{n: "ROADMAP.md section 1 step 11 (non-Mamba zoo)" for n in _ZOO},
          **{n: "ROADMAP.md section 1 step 12 (Mamba family)" for n in _MAMBA}}


def list_models():
    return ["smow_net"]


def get_model(name: str, device="cuda") -> torch.nn.Module:
    """Build a model by registry name on `device`: the CUDA card unless the
    caller asks for the CPU (device="cpu"). Raises when CUDA is asked for
    and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"get_model({name!r}): no CUDA device; pass device='cpu' "
                           "to build on the CPU")
    if name == "smow_net":
        from .smow_net import SMOWNet

        return SMOWNet().to(device)
    if name in _LATER:
        raise NotImplementedError(f"{name!r} is not ported yet: {_LATER[name]}")
    raise KeyError(f"unknown model {name!r}; available: {list_models()}")
