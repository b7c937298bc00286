"""JAX variables -> the port's state_dict (the inverse of
smow_net_tpu/train/convert.py `load_smownet_state_dict` and
`load_smownet_lw_state_dict`, and of smow_net_tpu/train/convert_zoo.py
`convert_generic` with zoo_specs' "change_mamba" and "rs_mamba" renames and
its "cd_mamba" renames and hook).

`variables` is the JAX `{"params", "batch_stats"}` tree as nested dicts of
numpy arrays. Layout rules, JAX (channels-last) -> torch:
  Conv          (*k, I/g, O)              -> (O, I/g, *k)
  ConvTranspose forward-conv (*k, I, O)   -> flip(*k), (I, O, *k)
  Dense         (I, O)                    -> Linear (O, I)
  BatchNorm     scale/bias + mean/var     -> weight/bias + running stats
  tmix          time_5 (1,1,1,C,C), time_mix (4,C,C) -> conv3d_time_{5,1..4}
                as ConvTranspose3d (I, O, 1, 1, 1); SMOW_Net_LW's conv blocks
                -> conv3d_t{5,1..4} as Conv3d (O, I, 1, 1, 1)
"""

from __future__ import annotations

import functools
import re
from typing import Dict

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "j2t_conv", "j2t_conv_transpose", "j2t_linear"]


def j2t_conv(w: np.ndarray) -> np.ndarray:
    """(*k, I/g, O) -> (O, I/g, *k); inverse of t2j_conv."""
    nk = w.ndim - 2
    return np.ascontiguousarray(np.transpose(w, (nk + 1, nk) + tuple(range(nk))))


def j2t_conv_transpose(w: np.ndarray) -> np.ndarray:
    """Forward-conv layout (*k, I, O) -> torch ConvTranspose (I, O, *k)
    with the spatial flip; inverse of t2j_conv_transpose (groups=1)."""
    nk = w.ndim - 2
    w = np.transpose(w, (nk, nk + 1) + tuple(range(nk)))
    return np.ascontiguousarray(np.flip(w, axis=tuple(range(2, 2 + nk))))


def j2t_linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


class _Writer:
    """Writes torch keys from the JAX `params` / `batch_stats` trees."""

    def __init__(self, variables):
        self.params, self.stats = variables["params"], variables.get("batch_stats", {})
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key, value):
        self.sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def bn(self, dst, *path):
        p, s = self.params, self.stats
        for k in path:
            p, s = p[k], s[k]
        self.put(dst + ".weight", p["scale"])
        self.put(dst + ".bias", p["bias"])
        self.put(dst + ".running_mean", s["mean"])
        self.put(dst + ".running_var", s["var"])
        self.sd[dst + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def conv(self, dst, p, bias=True):
        self.put(dst + ".weight", j2t_conv(p["kernel"]))
        if bias:
            self.put(dst + ".bias", p["bias"])

    def linear(self, dst, p, bias=True):
        self.put(dst + ".weight", j2t_linear(p["kernel"]))
        if bias:
            self.put(dst + ".bias", p["bias"])

    def ofw_tokens(self):
        """OFW and the token transformer encoder (both models)."""
        params = self.params
        for i, idx in enumerate((0, 3, 6)):
            self.conv(f"OFW.down.{idx}", params["OFW"][f"down{i}_conv"])
            self.bn(f"OFW.down.{idx + 1}", "OFW", f"down{i}_bn")
        self.conv("OFW.flow_make", params["OFW"]["flow_make"], bias=False)
        te = params["Transformer_Encoder"]
        tl = "Transformer_Encoder.transformer.layers.0"
        self.put("Transformer_Encoder.pos_embedding", te["pos_embedding"])
        self.conv("Transformer_Encoder.conv_a", te["conv_a"])
        tr = te["transformer"]
        self.put(tl + ".0.norm.weight", tr["norm1"]["scale"])
        self.put(tl + ".0.norm.bias", tr["norm1"]["bias"])
        self.linear(tl + ".0.fn.to_qkv", tr["attn"]["to_qkv"], bias=False)
        self.linear(tl + ".0.fn.to_out.0", tr["attn"]["to_out"])
        self.put(tl + ".1.norm.weight", tr["norm2"]["scale"])
        self.put(tl + ".1.norm.bias", tr["norm2"]["bias"])
        self.linear(tl + ".1.fn.net.0", tr["ff"]["fc1"])
        self.linear(tl + ".1.fn.net.3", tr["ff"]["fc2"])

    def mix(self, dst, mix, prefix, conv_layout, bias):
        """The cyclic temporal mixers `dst.{prefix}{1..5}`: (I, O) weights
        for ConvTranspose3d, (O, I) with `conv_layout` (Conv3d)."""
        kernels = [mix["time_mix_kernel"][i] for i in range(4)] + [mix["time_5_kernel"][0, 0, 0]]
        biases = ([mix["time_mix_bias"][i] for i in range(4)] + [mix["time_5_bias"]]
                  if bias else [None] * 5)
        for i, (w, b) in enumerate(zip(kernels, biases), 1):
            w = w.T if conv_layout else w
            self.put(f"{dst}.{prefix}{i}.weight", w[..., None, None, None])
            if b is not None:
                self.put(f"{dst}.{prefix}{i}.bias", b)

    def pixel_decoder_head(self):
        """The pixel transformer decoder and the classifier (both models)."""
        d = self.params["Transformer_Decoder"]["layer0"]
        td = "Transformer_Decoder.transformer_decoder.layers.0"
        self.put(td + ".0.fn.norm.weight", d["norm1"]["scale"])
        self.put(td + ".0.fn.norm.bias", d["norm1"]["bias"])
        for nm in ("q", "k", "v"):
            self.linear(f"{td}.0.fn.fn.to_{nm}", d["attn"][f"to_{nm}"], bias=False)
        self.linear(td + ".0.fn.fn.to_out.0", d["attn"]["to_out"])
        self.put(td + ".1.fn.norm.weight", d["norm2"]["scale"])
        self.put(td + ".1.fn.norm.bias", d["norm2"]["bias"])
        self.linear(td + ".1.fn.fn.net.0", d["ff"]["fc1"])
        self.linear(td + ".1.fn.fn.net.3", d["ff"]["fc2"])
        self.conv("decoder.conv1", self.params["classifier_conv"], bias=False)


def _smownet(w: _Writer) -> None:
    params = w.params
    # ---- encoder ----
    r = params["resnet"]

    def dconv(dst, p):
        w.conv(dst + ".conv3d_spatial", p["spatial"], bias=False)
        for i in (1, 2, 3):
            w.conv(f"{dst}.conv3d_time_{i}", p[f"time_{i}"], bias=False)

    dconv("resnet.conv1", r["conv1"])
    w.bn("resnet.bn1", "resnet", "bn1")
    for li in range(1, 5):
        for bi in range(2):
            src, dst = f"layer{li}_{bi}", f"resnet.layer{li}.{bi}"
            for ci in (1, 2):
                dconv(f"{dst}.conv{ci}", r[src][f"conv{ci}"])
                w.bn(f"{dst}.bn{ci}", "resnet", src, f"bn{ci}")
            if "downsample_conv" in r[src]:
                w.conv(dst + ".downsample.0", r[src]["downsample_conv"], bias=False)
                w.bn(dst + ".downsample.1", "resnet", src, "downsample_bn")

    # ---- BasicConv3d reductions ----
    for name in ("Conv3d", "Conv3d1", "Conv3d2", "Conv3d3", "Conv3d4"):
        w.conv(name + ".conv_bn.0", params[name]["conv"])
        w.bn(name + ".conv_bn.1", name, "bn")

    w.ofw_tokens()

    # ---- decoder 3D blocks ----
    for name in ("C3DT1", "C3DT2", "C3DT3", "C3DT4", "C3DT5"):
        p = params[name]
        w.put(name + ".conv3d_spatial.weight", j2t_conv_transpose(p["spatial"]["kernel"]))
        w.put(name + ".conv3d_spatial.bias", p["spatial"]["bias"])
        w.mix(name, p["tmix"], "conv3d_time_", conv_layout=False, bias=True)
        w.bn(name + ".batch", name, "bn")
    for name in ("C3D1", "C3D2", "C3D3", "C3D4", "C3D5"):
        base = name + ".conv_block_2_3d"
        w.conv(base + ".0", params[name]["conv1"])
        w.bn(base + ".1", name, "bn1")
        w.conv(base + ".3", params[name]["conv2"])
        w.bn(base + ".4", name, "bn2")

    w.pixel_decoder_head()


def _smownet_lw(w: _Writer) -> None:
    params = w.params
    # ---- MobileNetV2 backbone (torchvision keys, features_18 included) ----
    bb = params["backbone"]

    def cbr(dst, *path):            # conv / BN / ReLU6 triple
        p = bb
        for k in path:
            p = p[k]
        w.conv(dst + ".0", p["conv"], bias=False)
        w.bn(dst + ".1", "backbone", *path, "bn")

    cbr("backbone.features.0", "features_0")
    cbr("backbone.features.18", "features_18")
    for idx in range(1, 18):
        src, dst = f"features_{idx}", f"backbone.features.{idx}.conv"
        sub = 0
        if "pw" in bb[src]:          # expand ratio != 1
            cbr(f"{dst}.0", src, "pw")
            sub = 1
        cbr(f"{dst}.{sub}", src, "dw")
        w.conv(f"{dst}.{sub + 1}", bb[src]["pw_linear"], bias=False)
        w.bn(f"{dst}.{sub + 2}", "backbone", src, "pw_linear_bn")

    w.ofw_tokens()

    # ---- decoder 3D blocks: bias-free mixers in two layouts ----
    for name in ("C3DT1", "C3DT2", "C3DT3", "C3DT4", "C3DT5"):
        p = params[name]
        w.put(name + ".conv3d_spatial.weight", j2t_conv_transpose(p["spatial"]["kernel"]))
        w.put(name + ".conv3d_spatial.bias", p["spatial"]["bias"])
        w.mix(name, p["tmix"], "conv3d_time_", conv_layout=False, bias=False)
        w.bn(name + ".batch", name, "bn")
    for name in ("C3D1", "C3D2", "C3D3", "C3D4", "C3D5"):
        w.conv(name + ".conv3d_s", params[name]["spatial"])
        w.mix(name, params[name]["tmix"], "conv3d_t", conv_layout=True, bias=False)
        w.bn(name + ".b", name, "bn")

    w.pixel_decoder_head()


# module path (flax names joined by ".") -> torch prefix, applied in order
# (smow_net_tpu/train/zoo_specs.py "change_mamba")
_CHANGE_MAMBA_RENAMES = (
    (r"^encoder\.layer(\d)_block(\d+)", r"encoder.layers.\1.blocks.\2"),
    (r"^encoder\.downsample(\d)_conv$", r"encoder.layers.\1.downsample.1"),
    (r"^encoder\.downsample(\d)_norm$", r"encoder.layers.\1.downsample.3"),
    (r"^encoder\.patch_embed_conv1$", "encoder.patch_embed.0"),
    (r"^encoder\.patch_embed_norm1$", "encoder.patch_embed.2"),
    (r"^encoder\.patch_embed_conv2$", "encoder.patch_embed.5"),
    (r"^encoder\.patch_embed_norm2$", "encoder.patch_embed.7"),
    (r"^st_block_(\d+)\.proj$", r"decoder.st_block_\1.0"),
    (r"^st_block_(\d+)\.vss\.", r"decoder.st_block_\1.2."),
    (r"^fuse_layer_(\d)$", r"decoder.fuse_layer_\1.0"),
    (r"^fuse_bn_(\d)$", r"decoder.fuse_layer_\1.1"),
    (r"^smooth_layer_(\d)\.", r"decoder.smooth_layer_\1."),
    # VSSM's patch embed v1 (no model of the registry uses it)
    (r"^encoder\.patch_embed_conv$", "encoder.patch_embed.0"),
    (r"^encoder\.patch_embed_norm$", "encoder.patch_embed.2"),
)

# (smow_net_tpu/train/zoo_specs.py "rs_mamba"; the reference spells its
# decoder blocks `deocder_block`)
_RS_MAMBA_RENAMES = (
    (r"^enc(\d)_block(\d+)\.",
     lambda mo: f"encoder_block{int(mo.group(1)) + 1}.blocks.{mo.group(2)}."),
    (r"^down(\d)_conv$", lambda mo: f"encoder_block{int(mo.group(1)) + 1}.downsample.1"),
    (r"^down(\d)_norm$", lambda mo: f"encoder_block{int(mo.group(1)) + 1}.downsample.3"),
    (r"^patch_embed_conv1$", "patch_embed.0"),
    (r"^patch_embed_norm1$", "patch_embed.2"),
    (r"^patch_embed_conv2$", "patch_embed.5"),
    (r"^patch_embed_norm2$", "patch_embed.7"),
    (r"^fuse_block(\d)$", r"fuse_block\1.fuse.0"),
    (r"^fuse_bn(\d)$", r"fuse_block\1.fuse.1"),
    (r"^decoder_block(\d)$", r"deocder_block\1.fuse.0"),
    (r"^decoder_bn(\d)$", r"deocder_block\1.fuse.1"),
    (r"^up_conv1$", "upsample_x4.0"),
    (r"^up_bn1$", "upsample_x4.1"),
    (r"^up_conv2$", "upsample_x4.4"),
    (r"^up_bn2$", "upsample_x4.5"),
)


def _renamed_walk(w: _Writer, renames) -> None:
    """Walk the flax tree: each module's path, renamed, is the torch prefix;
    conv kernels (4-D) and Dense kernels (2-D) change layout, LayerNorm and
    BatchNorm scales become weights, BN statistics come from batch_stats,
    and the SS2D leaves (x_proj_weight, A_logs, ...) keep their shapes."""

    def walk(node, stats, path):
        module = ".".join(path)
        prefix = module
        for pat, rep in renames:
            prefix = re.sub(pat, rep, prefix)
        for leaf, value in node.items():
            if isinstance(value, dict):
                walk(value, (stats or {}).get(leaf), path + (leaf,))
            elif leaf == "kernel":
                w.put(prefix + ".weight", j2t_conv(value) if value.ndim == 4 else j2t_linear(value))
            elif leaf == "scale":
                w.put(prefix + ".weight", value)
            else:
                w.put(f"{prefix}.{leaf}" if prefix else leaf, value)
        if stats and "mean" in stats:
            w.put(prefix + ".running_mean", stats["mean"])
            w.put(prefix + ".running_var", stats["var"])
            w.sd[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    walk(w.params, w.stats, ())


# flax module path -> torch prefix, applied in order (a copy of
# smow_net_tpu/train/zoo_specs.py `CDM_STRUCT`)
_CDM_STRUCT = (
    (r"^enc0_block0\.", "srcm_encoder_layers.0.1."),
    (r"^enc(\d)_down\.", r"srcm_encoder_layers.\1.0.0."),
    (r"^enc(\d)_block(\d)\.",
     lambda mo: f"srcm_encoder_layers.{mo.group(1)}.{int(mo.group(2)) + 1}."),
    (r"^dec(\d)_block0\.", r"srcm_decoder_layers.\1.0."),
    (r"^up(\d)_conv$", r"up_samples.\1.0"),
    (r"^final_norm$", "conv_final.0"),
    (r"^conv_final$", "conv_final.2"),
    (r"\.local_relation\.conv1$", ".local_relation.0"),
    (r"\.local_relation\.conv2$", ".local_relation.2"),
    (r"\.local_relation\.dw1$", ".local_relation.0.depthwise_conv"),
    (r"\.local_relation\.pw1$", ".local_relation.0.pointwise_conv"),
    (r"\.local_relation\.dw2$", ".local_relation.2.depthwise_conv"),
    (r"\.local_relation\.pw2$", ".local_relation.2.pointwise_conv"),
    # the reference misspells the L_GF fusionencoder's local_relation
    (r"^(l_gf\d\.fusionencoder)\.local_relation\.", r"\1.lcoal_relation."),
)
# a Mamba direction's flax module -> the suffix of its leaves on the parent
_CDM_SUFFIX = {"fwd": "", "bwd": "_b", "g": "_g"}
_CDM_MAMBA_LEAVES = ("conv1d_kernel", "conv1d_bias", "x_proj_kernel", "dt_proj_kernel",
                     "dt_proj_bias", "A_log", "D")


def _cd_mamba(w: _Writer) -> None:
    """Walk the flax tree (the inverse of convert_generic with zoo_specs'
    "cd_mamba" renames and `cdm_hook`): conv and Dense kernels change
    layout under the renamed module path, norm scales become weights, a
    Mamba direction's seven leaves land on its parent with the direction's
    suffix, `ag{i}_kernel` is the gate Linear's weight."""

    def rename(dotted):
        for pat, rep in _CDM_STRUCT:
            dotted = re.sub(pat, rep, dotted)
        return dotted

    def join(prefix, name):
        return f"{prefix}.{name}" if prefix else name

    def mamba(node, prefix, sfx):
        w.put(join(prefix, f"conv1d{sfx}.weight"), j2t_conv(node["conv1d_kernel"]))
        w.put(join(prefix, f"conv1d{sfx}.bias"), node["conv1d_bias"])
        w.put(join(prefix, f"x_proj{sfx}.weight"), j2t_linear(node["x_proj_kernel"]))
        w.put(join(prefix, f"dt_proj{sfx}.weight"), j2t_linear(node["dt_proj_kernel"]))
        w.put(join(prefix, f"dt_proj{sfx}.bias"), node["dt_proj_bias"])
        w.put(join(prefix, f"A{sfx}_log"), node["A_log"])
        w.put(join(prefix, f"D{sfx}"), node["D"])

    def walk(node, path):
        dotted = ".".join(path)
        bare = "A_log" in node          # a bare Mamba1DCore's own leaves
        if bare:
            mamba(node, rename(dotted), "")
        for leaf, value in node.items():
            if isinstance(value, dict):
                if leaf in _CDM_SUFFIX:
                    mamba(value, rename(dotted), _CDM_SUFFIX[leaf])
                else:
                    walk(value, path + (leaf,))
            elif bare and leaf in _CDM_MAMBA_LEAVES:
                continue
            elif leaf == "kernel":
                w.put(rename(dotted) + ".weight",
                      j2t_conv(value) if value.ndim == 4 else j2t_linear(value))
            elif leaf in ("scale", "bias"):
                w.put(rename(dotted) + (".weight" if leaf == "scale" else ".bias"), value)
            elif re.fullmatch(r"ag\d_kernel", leaf):
                w.put(f"{leaf[:3]}.gate.weight", j2t_linear(value))
            else:
                w.put(rename(join(dotted, leaf)), value)

    walk(w.params, ())


_MODELS = {"smow_net": _smownet, "smow_net_lw": _smownet_lw,
           "change_mamba": functools.partial(_renamed_walk, renames=_CHANGE_MAMBA_RENAMES),
           "cd_mamba": _cd_mamba,
           "rs_mamba": functools.partial(_renamed_walk, renames=_RS_MAMBA_RENAMES)}


def state_dict_from_jax(variables, model: str = "smow_net") -> Dict[str, torch.Tensor]:
    """The port's state_dict of `model` ("smow_net", "smow_net_lw",
    "change_mamba", "cd_mamba" or "rs_mamba") from the JAX variables; BN
    running statistics come from `batch_stats`."""
    w = _Writer(variables)
    _MODELS[model](w)
    return w.sd
