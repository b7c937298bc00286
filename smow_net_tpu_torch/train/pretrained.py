"""Pretrained-backbone ingestion for training (port of
smow_net_tpu/train/pretrained.py).

The reference starts SMOW_Net from an ImageNet torchvision resnet18
(reference train.py:84-85), inflated into its 3D encoder, and SMOW_Net_LW
from torch-hub mobilenet_v2 (models/SMOW_Net_LW.py:581-589). Nothing is
downloaded here: `cli.train --pretrained <file>` reads a state_dict the
user supplies (.pth or .npz) and copies it into the model's backbone in
place, as the JAX package's `convert.load_resnet18_into_resnet3d` and
`load_mobilenet_v2` do: convolution weights and BatchNorm scale, bias and
running statistics; the temporal mixers and everything else keep their
values.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["load_state_dict_file", "load_pretrained_backbone"]

_BN = ("weight", "bias", "running_mean", "running_var")
# the JAX package's recipes for zoo models (resnet18, mobilenet_v2, vgg16)
_ZOO_RECIPES = ("afcf3d", "a2net", "tfi_gr", "seifnet", "bit", "ifn")


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A state_dict from a .npz or a .pth (`torch.load(weights_only=True)`;
    a {'state_dict': ...} wrapper is unwrapped)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def _resnet18_into_resnet3d(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision resnet18 keys -> the port's `resnet.*` keys: every 2D
    kernel becomes the (1, kh, kw) spatial kernel of its decomposed conv."""
    out = {"resnet.conv1.conv3d_spatial.weight": sd["conv1.weight"].unsqueeze(2)}
    out.update({f"resnet.bn1.{n}": sd[f"bn1.{n}"] for n in _BN})
    for li in range(1, 5):
        for bi in range(2):
            t = f"layer{li}.{bi}"
            for ci in (1, 2):
                out[f"resnet.{t}.conv{ci}.conv3d_spatial.weight"] = \
                    sd[f"{t}.conv{ci}.weight"].unsqueeze(2)
                out.update({f"resnet.{t}.bn{ci}.{n}": sd[f"{t}.bn{ci}.{n}"] for n in _BN})
            if f"{t}.downsample.0.weight" in sd:
                out[f"resnet.{t}.downsample.0.weight"] = \
                    sd[f"{t}.downsample.0.weight"].unsqueeze(2)
                out.update({f"resnet.{t}.downsample.1.{n}": sd[f"{t}.downsample.1.{n}"]
                            for n in _BN})
    return out


def _mobilenet_v2_into_backbone(sd: Dict[str, torch.Tensor], own) -> Dict[str, torch.Tensor]:
    """torch-hub mobilenet_v2 `features.*` -> the port's `backbone.features.*`
    (the same module layout): convolution weights and BatchNorm tensors."""
    return {key: sd[key[len("backbone."):]] for key in own
            if key.startswith("backbone.features.") and key.rsplit(".", 1)[-1] in _BN}


def load_pretrained_backbone(model_name: str, path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Copy the pretrained state_dict at `path` into the backbone of the
    port's `model` (registry name `model_name`) in place; returns `model`."""
    sd = load_state_dict_file(path)
    own = model.state_dict()
    name = model_name.lower()
    if name == "smow_net":
        new = _resnet18_into_resnet3d(sd)
    elif name == "smow_net_lw":
        new = _mobilenet_v2_into_backbone(sd, own)
    elif name in _ZOO_RECIPES:
        raise NotImplementedError(
            f"no pretrained-backbone recipe for {model_name!r} in the port yet: the zoo's "
            "recipes (load_resnet18_2d, vgg16) wait for ROADMAP.md queue 1 item 4")
    else:
        raise ValueError(f"no pretrained-backbone recipe for model '{model_name}'; the "
                         "reference initializes this model from scratch or via its own URL")
    for key, value in new.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: pretrained shape {tuple(value.shape)}, "
                             f"model {tuple(own[key].shape)}")
    with torch.no_grad():
        for key, value in new.items():
            own[key].copy_(value)
    return model
