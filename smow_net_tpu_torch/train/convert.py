"""JAX variables -> the port's state_dict (the inverse of
smow_net_tpu/train/convert.py `load_smownet_state_dict` and
`load_smownet_lw_state_dict`, of smow_net_tpu/train/convert_zoo.py
`convert_generic` with zoo_specs' renames of the Mamba models and the
ported zoo (PA-Former, BIT, AFCF3D, IFN, SNUNet, DTCDSCN) and its "cd_mamba"
hook, and of zoo_specs' `convert_fc_ef`).

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


def _renamed_walk(w: _Writer, renames, transposed=()) -> None:
    """Walk the flax tree as convert_generic does (the inverse of it): each
    module's path, renamed, is the torch prefix of its kernel, bias and
    scale; conv kernels (the modules matching `transposed`: transposed
    convs) and Dense kernels (2-D) change layout, LayerNorm and BatchNorm
    scales become weights, BN statistics come from batch_stats; any other
    leaf (the SS2D's x_proj_weight, A_logs, ..., position embeddings, PReLU
    slopes) keeps its shape under its whole path, renamed."""

    def rename(dotted):
        for pat, rep in renames:
            dotted = re.sub(pat, rep, dotted)
        return dotted

    def walk(node, stats, path):
        module = ".".join(path)
        prefix = rename(module)
        for leaf, value in node.items():
            if isinstance(value, dict):
                walk(value, (stats or {}).get(leaf), path + (leaf,))
            elif leaf == "kernel":
                if value.ndim == 2:
                    value = j2t_linear(value)
                elif any(re.search(p, module) for p in transposed):
                    value = j2t_conv_transpose(value)
                else:
                    value = j2t_conv(value)
                w.put(prefix + ".weight", value)
            elif leaf == "scale":
                w.put(prefix + ".weight", value)
            elif leaf == "bias":
                w.put(f"{prefix}.bias" if prefix else leaf, value)
            else:
                w.put(rename(f"{module}.{leaf}" if module else leaf), value)
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


# The non-Mamba zoo (copies of smow_net_tpu/train/zoo_specs.py's renames
# and transpose_conv patterns; FC-EF's are what its bespoke `convert_fc_ef`
# reads): model -> (renames, the transposed convs' module paths)
_RESNET_RENAMES = (
    (r"\.layer(\d)_(\d)", r".layer\1.\2"),
    (r"\.downsample_conv$", ".downsample.0"),
    (r"\.downsample_bn$", ".downsample.1"),
)
_ZOO = {
    "fc_ef": (((r"^conv(\w+)_bn$", r"bn\1"),), (r"^upconv\d$", r"^conv\d\dd$")),
    "dtcdscn": ((
        (r"^encoder(\d)_(\d)", r"encoder\1.\2"),
        (r"\.se\.fc1$", ".se.fc.0"),
        (r"\.se\.fc2$", ".se.fc.2"),
        (r"\.downsample_conv$", ".downsample.0"),
        (r"\.downsample_bn$", ".downsample.1"),
        (r"\.scse\.ce1$", ".scse.channel_excitation.0"),
        (r"\.scse\.ce2$", ".scse.channel_excitation.2"),
        (r"\.scse\.se$", ".scse.spatial_se.0"),
    ), (r"\.deconv2$", r"^finaldeconv1_master$")),
    "ifn": ((
        (r"^(t[12]_base)\.conv_(\d+)$", r"\1.features.\2"),
        (r"\.conv$", ".0"),
        (r"\.prelu_alpha$", ".1.weight"),
        (r"\.bn$", ".2"),
    ), (r"^trans_conv",)),
    "bit": (_RESNET_RENAMES + (
        (r"^enc0_attn\.to_out$", "transformer.layers.0.0.fn.fn.to_out.0"),
        (r"^enc0_attn\.(\w+)$", r"transformer.layers.0.0.fn.fn.\1"),
        (r"^enc0_norm1$", "transformer.layers.0.0.fn.norm"),
        (r"^enc0_norm2$", "transformer.layers.0.1.fn.norm"),
        (r"^enc0_ff\.fc1$", "transformer.layers.0.1.fn.fn.net.0"),
        (r"^enc0_ff\.fc2$", "transformer.layers.0.1.fn.fn.net.3"),
        (r"^dec(\d)_attn\.to_out$", r"transformer_decoder.layers.\1.0.fn.fn.to_out.0"),
        (r"^dec(\d)_attn\.(\w+)$", r"transformer_decoder.layers.\1.0.fn.fn.\2"),
        (r"^dec(\d)_norm1$", r"transformer_decoder.layers.\1.0.fn.norm"),
        (r"^dec(\d)_norm2$", r"transformer_decoder.layers.\1.1.fn.norm"),
        (r"^dec(\d)_ff\.fc1$", r"transformer_decoder.layers.\1.1.fn.fn.net.0"),
        (r"^dec(\d)_ff\.fc2$", r"transformer_decoder.layers.\1.1.fn.fn.net.3"),
        (r"^classifier_conv1$", "classifier.0"),
        (r"^classifier_bn$", "classifier.1"),
        (r"^classifier_conv2$", "classifier.3"),
    ), ()),
    "pa_former": (_RESNET_RENAMES + (
        (r"\.PI\.down0_conv$", ".PI.down.0"),
        (r"\.PI\.down0_bn$", ".PI.down.1"),
        (r"\.PI\.down1_conv$", ".PI.down.3"),
        (r"\.PI\.down1_bn$", ".PI.down.4"),
        (r"\.PI\.down2_conv$", ".PI.down.6"),
        (r"\.PI\.down2_bn$", ".PI.down.7"),
        (r"\.(last_conv\d?)$", r".\1.0"),
        (r"^decoder_conv$", "decoder.conv1"),
        (r"^token_encoder\.attn\.to_qkv$", "token_encoder.transformer.layers.0.0.fn.to_qkv"),
        (r"^token_encoder\.attn\.to_out$", "token_encoder.transformer.layers.0.0.fn.to_out.0"),
        (r"^token_encoder\.norm1$", "token_encoder.transformer.layers.0.0.norm"),
        (r"^token_encoder\.norm2$", "token_encoder.transformer.layers.0.1.norm"),
        (r"^token_encoder\.ff\.fc1$", "token_encoder.transformer.layers.0.1.fn.net.0"),
        (r"^token_encoder\.ff\.fc2$", "token_encoder.transformer.layers.0.1.fn.net.3"),
        (r"^token_decoder\.attn\.to_out$",
         "token_decoder.transformer_decoder.layers.0.0.fn.fn.to_out.0"),
        (r"^token_decoder\.attn\.(to_\w)$",
         r"token_decoder.transformer_decoder.layers.0.0.fn.fn.\1"),
        (r"^token_decoder\.norm1$", "token_decoder.transformer_decoder.layers.0.0.fn.norm"),
        (r"^token_decoder\.norm2$", "token_decoder.transformer_decoder.layers.0.1.fn.norm"),
        (r"^token_decoder\.ff\.fc1$",
         "token_decoder.transformer_decoder.layers.0.1.fn.fn.net.0"),
        (r"^token_decoder\.ff\.fc2$",
         "token_decoder.transformer_decoder.layers.0.1.fn.fn.net.3"),
    ), ()),
    "afcf3d": (_RESNET_RENAMES + (
        (r"\.spatial$", ".conv3d_spatial"),
        (r"\.time_(\d)$", r".conv3d_time_\1"),
        (r"^AFCF(\d)_cat(\d)\.conv$", r"decoder.AFCF_fuse.AFCF\1.conv_cat.\2.conv_bn.0"),
        (r"^AFCF(\d)_cat(\d)\.bn$", r"decoder.AFCF_fuse.AFCF\1.conv_cat.\2.conv_bn.1"),
        (r"^AFCF(\d)_(conv_up|conv_down)\.conv$", r"decoder.AFCF_fuse.AFCF\1.\2.conv_bn.0"),
        (r"^AFCF(\d)_(conv_up|conv_down)\.bn$", r"decoder.AFCF_fuse.AFCF\1.\2.conv_bn.1"),
        (r"^AFCF(\d)_se\.", r"decoder.AFCF_fuse.AFCF\1.SE."),
        (r"^SE_(\d)_cat(\d)\.conv$", r"decoder.output.conv_cat_\1.\2.conv_bn.0"),
        (r"^SE_(\d)_cat(\d)\.bn$", r"decoder.output.conv_cat_\1.\2.conv_bn.1"),
        (r"^SE_(\d)_se\.", r"decoder.output.SE_\1."),
        (r"^dec_(conv_downsample|conv_upsample)\.conv$", r"decoder.output.\1.conv_bn.0"),
        (r"^dec_(conv_downsample|conv_upsample)\.bn$", r"decoder.output.\1.conv_bn.1"),
        (r"^(downT\d|downfinal)_(\d)\.conv$", r"decoder.output.\1.\2.conv_bn.0"),
        (r"^(downT\d|downfinal)_(\d)\.bn$", r"decoder.output.\1.\2.conv_bn.1"),
        (r"^out_conv1$", "decoder.output.out.0.conv_bn.0"),
        (r"^out_bn1$", "decoder.output.out.0.conv_bn.1"),
        (r"^out_conv2$", "decoder.output.out.1.conv_bn.0"),
        (r"^out_bn2$", "decoder.output.out.1.conv_bn.1"),
        (r"^out_conv3$", "decoder.output.out.2"),
        (r"^reduction(\d)\.r(\d)\.conv$", r"decoder.reduction\1.reduce.\2.conv_bn.0"),
        (r"^reduction(\d)\.r(\d)\.bn$", r"decoder.reduction\1.reduce.\2.conv_bn.1"),
    ), ()),
    "snunet": (((r"^(Up\d_\d)$", r"\1.up"),), (r"^Up",)),
}
# the reference's dead modules, which its checkpoints hold and the port
# leaves out (zoo_specs' allow_unconsumed): ingestion drops their keys
DEAD_KEYS = {
    "dtcdscn": (r"^decoder[1-4]\.", r"^dblock\.", r"^finaldeconv1\.", r"^finalconv[23]\."),
    "ifn": (r"^ca1\.", r"^bn_ca[12]\.", r"^o1_conv3\.", r"^o[234]_conv4\."),
    "bit": (r"^resnet\.layer4\.", r"^resnet\.fc\."),
    "afcf3d": (r"^decoder\.output\.superD[1-4]\.", r"^decoder\.output\.superout[1-4]\.",
               r"^decoder\.AFCF_fuse\.AFCF1\.conv_down\.", r"^decoder\.output\.downT0\."),
}

_MODELS = {"smow_net": _smownet, "smow_net_lw": _smownet_lw,
           "change_mamba": functools.partial(_renamed_walk, renames=_CHANGE_MAMBA_RENAMES),
           "cd_mamba": _cd_mamba,
           "rs_mamba": functools.partial(_renamed_walk, renames=_RS_MAMBA_RENAMES)}
_MODELS.update({name: functools.partial(_renamed_walk, renames=renames, transposed=transposed)
                for name, (renames, transposed) in _ZOO.items()})


def state_dict_from_jax(variables, model: str = "smow_net") -> Dict[str, torch.Tensor]:
    """The port's state_dict of `model` (a name of `_MODELS`: "smow_net",
    "smow_net_lw", the Mamba models and the ported zoo) from the JAX
    variables; BN running statistics come from `batch_stats`."""
    w = _Writer(variables)
    _MODELS[model](w)
    return w.sd
