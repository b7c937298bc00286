"""JAX variables -> the port's state_dict (the inverse of
smow_net_tpu/train/convert.py `load_smownet_state_dict`).

`variables` is the JAX `{"params", "batch_stats"}` tree as nested dicts of
numpy arrays. Layout rules, JAX (channels-last) -> torch:
  Conv          (*k, I/g, O)              -> (O, I/g, *k)
  ConvTranspose forward-conv (*k, I, O)   -> flip(*k), (I, O, *k)
  Dense         (I, O)                    -> Linear (O, I)
  BatchNorm     scale/bias + mean/var     -> weight/bias + running stats
  tmix          time_5 (1,1,1,C,C), time_mix (4,C,C) -> conv3d_time_{5,1..4}
                as ConvTranspose3d (I, O, 1, 1, 1)
"""

from __future__ import annotations

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


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def node(tree, path):
        for p in path:
            tree = tree[p]
        return tree

    def bn(dst, *path):
        p, s = node(params, path), node(stats, path)
        put(dst + ".weight", p["scale"])
        put(dst + ".bias", p["bias"])
        put(dst + ".running_mean", s["mean"])
        put(dst + ".running_var", s["var"])
        sd[dst + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def conv(dst, p, bias=True):
        put(dst + ".weight", j2t_conv(p["kernel"]))
        if bias:
            put(dst + ".bias", p["bias"])

    def linear(dst, p, bias=True):
        put(dst + ".weight", j2t_linear(p["kernel"]))
        if bias:
            put(dst + ".bias", p["bias"])

    def dconv(dst, p):
        conv(dst + ".conv3d_spatial", p["spatial"], bias=False)
        for i in (1, 2, 3):
            conv(f"{dst}.conv3d_time_{i}", p[f"time_{i}"], bias=False)

    # ---- encoder ----
    r = params["resnet"]
    dconv("resnet.conv1", r["conv1"])
    bn("resnet.bn1", "resnet", "bn1")
    for li in range(1, 5):
        for bi in range(2):
            src, dst = f"layer{li}_{bi}", f"resnet.layer{li}.{bi}"
            for ci in (1, 2):
                dconv(f"{dst}.conv{ci}", r[src][f"conv{ci}"])
                bn(f"{dst}.bn{ci}", "resnet", src, f"bn{ci}")
            if "downsample_conv" in r[src]:
                conv(dst + ".downsample.0", r[src]["downsample_conv"], bias=False)
                bn(dst + ".downsample.1", "resnet", src, "downsample_bn")

    # ---- BasicConv3d reductions ----
    for name in ("Conv3d", "Conv3d1", "Conv3d2", "Conv3d3", "Conv3d4"):
        conv(name + ".conv_bn.0", params[name]["conv"])
        bn(name + ".conv_bn.1", name, "bn")

    # ---- OFW ----
    for i, idx in enumerate((0, 3, 6)):
        conv(f"OFW.down.{idx}", params["OFW"][f"down{i}_conv"])
        bn(f"OFW.down.{idx + 1}", "OFW", f"down{i}_bn")
    conv("OFW.flow_make", params["OFW"]["flow_make"], bias=False)

    # ---- token transformer encoder ----
    te = params["Transformer_Encoder"]
    tl = "Transformer_Encoder.transformer.layers.0"
    put("Transformer_Encoder.pos_embedding", te["pos_embedding"])
    conv("Transformer_Encoder.conv_a", te["conv_a"])
    tr = te["transformer"]
    put(tl + ".0.norm.weight", tr["norm1"]["scale"])
    put(tl + ".0.norm.bias", tr["norm1"]["bias"])
    linear(tl + ".0.fn.to_qkv", tr["attn"]["to_qkv"], bias=False)
    linear(tl + ".0.fn.to_out.0", tr["attn"]["to_out"])
    put(tl + ".1.norm.weight", tr["norm2"]["scale"])
    put(tl + ".1.norm.bias", tr["norm2"]["bias"])
    linear(tl + ".1.fn.net.0", tr["ff"]["fc1"])
    linear(tl + ".1.fn.net.3", tr["ff"]["fc2"])

    # ---- decoder 3D blocks ----
    for name in ("C3DT1", "C3DT2", "C3DT3", "C3DT4", "C3DT5"):
        p = params[name]
        put(name + ".conv3d_spatial.weight", j2t_conv_transpose(p["spatial"]["kernel"]))
        put(name + ".conv3d_spatial.bias", p["spatial"]["bias"])
        mix = p["tmix"]
        put(name + ".conv3d_time_5.weight", mix["time_5_kernel"][0, 0, 0][..., None, None, None])
        put(name + ".conv3d_time_5.bias", mix["time_5_bias"])
        for i in (1, 2, 3, 4):
            put(f"{name}.conv3d_time_{i}.weight",
                mix["time_mix_kernel"][i - 1][..., None, None, None])
            put(f"{name}.conv3d_time_{i}.bias", mix["time_mix_bias"][i - 1])
        bn(name + ".batch", name, "bn")
    for name in ("C3D1", "C3D2", "C3D3", "C3D4", "C3D5"):
        base = name + ".conv_block_2_3d"
        conv(base + ".0", params[name]["conv1"])
        bn(base + ".1", name, "bn1")
        conv(base + ".3", params[name]["conv2"])
        bn(base + ".4", name, "bn2")

    # ---- pixel transformer decoder ----
    d = params["Transformer_Decoder"]["layer0"]
    td = "Transformer_Decoder.transformer_decoder.layers.0"
    put(td + ".0.fn.norm.weight", d["norm1"]["scale"])
    put(td + ".0.fn.norm.bias", d["norm1"]["bias"])
    for nm in ("q", "k", "v"):
        linear(f"{td}.0.fn.fn.to_{nm}", d["attn"][f"to_{nm}"], bias=False)
    linear(td + ".0.fn.fn.to_out.0", d["attn"]["to_out"])
    put(td + ".1.fn.norm.weight", d["norm2"]["scale"])
    put(td + ".1.fn.norm.bias", d["norm2"]["bias"])
    linear(td + ".1.fn.fn.net.0", d["ff"]["fc1"])
    linear(td + ".1.fn.fn.net.3", d["ff"]["fc2"])

    # ---- classifier head ----
    conv("decoder.conv1", params["classifier_conv"], bias=False)
    return sd
