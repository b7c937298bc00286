"""Model registry of the port (mirrors smow_net_tpu.models.get_model).

SMOW_Net, SMOW_Net_LW, the Mamba models and the first row of the non-Mamba
zoo are ported, each with the JAX registry's recipe as its default keyword
arguments; the other names of the JAX registry raise NotImplementedError
naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import importlib

import torch

__all__ = ["get_model", "list_models"]

# name -> (module, class, default kwargs from the JAX registry's recipes,
# smow_net_tpu/models/__init__.py:18-29)
_REGISTRY = {
    "smow_net": ("smow_net", "SMOWNet", {}),
    "smow_net_lw": ("smow_net_lw", "SMOWNetLW", {}),
    "change_mamba": ("change_mamba", "ChangeMamba", {}),
    "cd_mamba": ("cd_mamba", "CDMamba", {}),
    "rs_mamba": ("rs_mamba", "RSMCD", {}),
    "fc_ef": ("fc_ef", "FCEF", {"label_nbr": 2}),
    "snunet": ("snunet", "SNUNet", {"out_ch": 2}),
    "dtcdscn": ("dtcdscn", "DTCDSCN", {}),
    "ifn": ("ifn", "DSIFN", {}),
    "bit": ("bit", "BIT", {"output_nc": 2, "token_len": 4, "resnet_stages_num": 4,
                           "with_pos": "learned", "enc_depth": 1, "dec_depth": 8,
                           "decoder_dim_head": 8}),
    "pa_former": ("pa_former", "PAFormer", {"n_class": 2}),
    "afcf3d": ("afcf3d", "AFCF3D", {"features": 32}),
}
_LATER = {n: "ROADMAP.md queue 1 item 4 (non-Mamba zoo, second row)"
          for n in ("seifnet", "tfi_gr", "a2net", "elgcnet", "changeformer", "scratchformer")}


def list_models():
    return list(_REGISTRY)


def get_model(name: str, device="cuda", **kwargs) -> torch.nn.Module:
    """Build a model by registry name on `device`: the CUDA card unless the
    caller asks for the CPU (device="cpu"). Raises when CUDA is asked for
    and absent. Keyword arguments override the recipe's and go to the
    model's constructor, e.g. get_model("smow_net", token_train_chain="fused")."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"get_model({name!r}): no CUDA device; pass device='cpu' "
                           "to build on the CPU")
    if name in _LATER:
        raise NotImplementedError(f"{name!r} is not ported yet: {_LATER[name]}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {list_models()}")
    module, cls, defaults = _REGISTRY[name]
    model = getattr(importlib.import_module(f"{__name__}.{module}"), cls)
    return model(**{**defaults, **kwargs}).to(device)
