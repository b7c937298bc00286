"""Pretrained-backbone ingestion for training (port of
smow_net_tpu/train/pretrained.py).

The reference starts SMOW_Net and AFCF3D from an ImageNet torchvision
resnet18 (reference train.py:84-85, compare/AFCF3D_NET.py:524-605),
inflated into their 3D encoder, SMOW_Net_LW from torch-hub mobilenet_v2
(models/SMOW_Net_LW.py:581-589), BIT from a torchvision resnet18 (its
first three stages) and IFN's two VGG-16 bases from torchvision vgg16.
Nothing is downloaded here: `cli.train --pretrained <file>` reads a
state_dict the user supplies (.pth or .npz) and copies it into the model's
backbone in place, as the JAX package's `convert.load_resnet18_into_resnet3d`,
`load_mobilenet_v2`, `load_resnet18_2d` and `_load_vgg16_features` do:
convolution weights (and VGG's biases) and BatchNorm scale, bias and
running statistics; the temporal mixers and everything else keep their
values.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["load_state_dict_file", "load_pretrained_backbone"]

_BN = ("weight", "bias", "running_mean", "running_var")
# the JAX package's recipes for zoo models not ported yet (resnet18, mobilenet_v2)
_ZOO_RECIPES = ("a2net", "tfi_gr", "seifnet")


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


def _resnet18_2d(sd: Dict[str, torch.Tensor], own, prefix: str) -> Dict[str, torch.Tensor]:
    """torchvision resnet18 keys -> the port's `<prefix>.*` ResNet keys (the
    same layout), for the stages the model builds (BIT builds three); a
    downsample only where both sides have one."""
    out = {f"{prefix}.conv1.weight": sd["conv1.weight"]}
    out.update({f"{prefix}.bn1.{n}": sd[f"bn1.{n}"] for n in _BN})
    for li in range(1, 5):
        for bi in range(2):
            t = f"layer{li}.{bi}"
            if f"{prefix}.{t}.conv1.weight" not in own:
                continue
            for ci in (1, 2):
                out[f"{prefix}.{t}.conv{ci}.weight"] = sd[f"{t}.conv{ci}.weight"]
                out.update({f"{prefix}.{t}.bn{ci}.{n}": sd[f"{t}.bn{ci}.{n}"] for n in _BN})
            if f"{prefix}.{t}.downsample.0.weight" in own and f"{t}.downsample.0.weight" in sd:
                out[f"{prefix}.{t}.downsample.0.weight"] = sd[f"{t}.downsample.0.weight"]
                out.update({f"{prefix}.{t}.downsample.1.{n}": sd[f"{t}.downsample.1.{n}"]
                            for n in _BN})
    return out


def _vgg16_into_bases(sd: Dict[str, torch.Tensor], own) -> Dict[str, torch.Tensor]:
    """torchvision vgg16 `features.N` convs -> IFN's `t1_base.features.N`
    and `t2_base.features.N` (both bases start from the same weights)."""
    return {key: sd[key.split(".", 1)[1]] for key in own
            if key.startswith(("t1_base.features.", "t2_base.features."))}


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
    if name in ("smow_net", "afcf3d"):
        new = _resnet18_into_resnet3d(sd)
    elif name == "smow_net_lw":
        new = _mobilenet_v2_into_backbone(sd, own)
    elif name == "bit":
        new = _resnet18_2d(sd, own, "resnet")
    elif name == "ifn":
        new = _vgg16_into_bases(sd, own)
    elif name in _ZOO_RECIPES:
        raise NotImplementedError(
            f"no pretrained-backbone recipe for {model_name!r} in the port yet: the zoo's "
            "second row and its recipes wait for ROADMAP.md queue 1 item 4")
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
