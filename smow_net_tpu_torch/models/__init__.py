"""Model registry of the port (mirrors smow_net_tpu.models.get_model).

SMOW_Net, SMOW_Net_LW, ChangeMamba and CD-Mamba are ported so far; the other names
of the JAX registry raise NotImplementedError naming the ROADMAP.md item
that ports them.
"""

from __future__ import annotations

import torch

__all__ = ["get_model", "list_models"]

_MAMBA = {"rs_mamba": "ROADMAP.md queue 1 item 3 (rs_mamba, cross_scan8)"}
_ZOO = ("fc_ef", "snunet", "dtcdscn", "ifn", "bit", "pa_former", "afcf3d",
        "seifnet", "tfi_gr", "a2net", "elgcnet", "changeformer", "scratchformer")
_LATER = {**{n: "ROADMAP.md queue 1 item 4 (non-Mamba zoo)" for n in _ZOO}, **_MAMBA}


def list_models():
    return ["smow_net", "smow_net_lw", "change_mamba", "cd_mamba"]


def get_model(name: str, device="cuda", **kwargs) -> torch.nn.Module:
    """Build a model by registry name on `device`: the CUDA card unless the
    caller asks for the CPU (device="cpu"). Raises when CUDA is asked for
    and absent. Keyword arguments go to the model's constructor, e.g.
    get_model("smow_net", token_train_chain="fused")."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"get_model({name!r}): no CUDA device; pass device='cpu' "
                           "to build on the CPU")
    if name == "smow_net":
        from .smow_net import SMOWNet

        return SMOWNet(**kwargs).to(device)
    if name == "smow_net_lw":
        from .smow_net_lw import SMOWNetLW

        return SMOWNetLW(**kwargs).to(device)
    if name == "change_mamba":
        from .change_mamba import ChangeMamba

        return ChangeMamba(**kwargs).to(device)
    if name == "cd_mamba":
        from .cd_mamba import CDMamba

        return CDMamba(**kwargs).to(device)
    if name in _LATER:
        raise NotImplementedError(f"{name!r} is not ported yet: {_LATER[name]}")
    raise KeyError(f"unknown model {name!r}; available: {list_models()}")
