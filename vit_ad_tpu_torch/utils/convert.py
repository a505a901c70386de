"""Carry JAX-trained weights into the port.

`vit_state_dict_from_jax`, `swin_state_dict_from_jax`,
`resnet_state_dict_from_jax`, `nf_state_dict_from_jax` and
`mdn_state_dict_from_jax` take the JAX package's params as nested dicts of
numpy arrays (the caller does jax → numpy) and return the port's state dicts,
in the timm, EsViT, reference-ResNetEncoder, FrEIA and reference-MDN layouts
that `vit_ad_tpu/utils/torch_convert.export_vit` (:607), `export_swin` (:803),
`export_resnet_encoder` (:977), `export_nf_head` (:518) and `export_mdn_head`
(:497) emit.
`interpolate_rel_pos_table` is the port's copy of the bias-table resize of
`torch_convert.py` (:1099). numpy and scipy only: no jax, no `vit_ad_tpu`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from vit_ad_tpu_torch.models.flow import default_perms

_VIT_BLOCK_KEYS = {  # timm key → (JAX stacked leaf, transpose)
    "norm1.weight": ("norm1_scale", False),
    "norm1.bias": ("norm1_bias", False),
    "attn.qkv.weight": ("qkv_kernel", True),
    "attn.qkv.bias": ("qkv_bias", False),
    "attn.proj.weight": ("proj_kernel", True),
    "attn.proj.bias": ("proj_bias", False),
    "norm2.weight": ("norm2_scale", False),
    "norm2.bias": ("norm2_bias", False),
    "mlp.fc1.weight": ("fc1_kernel", True),
    "mlp.fc1.bias": ("fc1_bias", False),
    "mlp.fc2.weight": ("fc2_kernel", True),
    "mlp.fc2.bias": ("fc2_bias", False),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # a writable copy


def _hwio_to_oihw(kernel) -> np.ndarray:
    return np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))


def _unwrap(params: Mapping[str, Any]) -> Mapping[str, Any]:
    return params["params"] if "params" in params else params


def vit_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Scan-stacked JAX `ViTEncoder` params (or `{'params': ...}`) → the
    port's `ViTEncoder` state dict (timm keys; `dist_token` when the model
    has two prefix tokens)."""
    p = _unwrap(params)
    pe = p["patch_embed"]["proj"]
    prefix = np.asarray(p["prefix_tokens"], np.float32)  # [1, n, D]
    sd = {"patch_embed.proj.weight": _t(_hwio_to_oihw(pe["kernel"])),
          "patch_embed.proj.bias": _t(pe["bias"]),
          "cls_token": _t(prefix[:, :1])}
    if prefix.shape[1] == 2:
        sd["dist_token"] = _t(prefix[:, 1:2])
    sd["pos_embed"] = _t(p["pos_embed"])
    for i in range(int(np.asarray(p["norm1_scale"]).shape[0])):
        for key, (leaf, transpose) in _VIT_BLOCK_KEYS.items():
            a = np.asarray(p[leaf][i], np.float32)
            sd[f"blocks.{i}.{key}"] = _t(a.T if transpose else a)
    sd["norm.weight"] = _t(p["norm_scale"])
    sd["norm.bias"] = _t(p["norm_bias"])
    return sd


_SWIN_BLOCK_KEYS = {  # EsViT key → (JAX stacked leaf, transpose)
    **_VIT_BLOCK_KEYS,
    "attn.relative_position_bias_table": ("bias_table", False),
}


def swin_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Scan-stacked JAX `SwinTransformer` params → the port's `SwinTransformer`
    state dict (vendored EsViT keys), the inverse stacking of `export_swin`:
    `a_*` leaves are a stage's even (unshifted) blocks, `b_*` its odd
    (shifted) ones, kernels transposed. Accepts the tree with or without the
    `params` and `esvit` wrappers. `relative_position_index` is recomputed
    from each table's window."""
    from vit_ad_tpu_torch.ops.window_attention import relative_position_index

    p = _unwrap(params)
    p = p["esvit"] if "esvit" in p else p
    ln = lambda tree: tree["LayerNorm_0"] if "LayerNorm_0" in tree else tree
    sd = {"patch_embed.proj.weight": _t(_hwio_to_oihw(p["patch_embed"]["kernel"])),
          "patch_embed.proj.bias": _t(p["patch_embed"]["bias"])}
    for key, tree in (("patch_embed.norm", p["patch_norm"]), ("norm", p["norm"])):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _t(ln(tree)["scale"]), _t(ln(tree)["bias"])
    si = 0
    while f"layer{si}" in p:
        stage = p[f"layer{si}"]
        for tag, parity in (("a", 0), ("b", 1)):
            for j in range(int(np.asarray(stage["a_norm1_scale"]).shape[0])):
                pre = f"layers.{si}.blocks.{2 * j + parity}"
                for key, (leaf, transpose) in _SWIN_BLOCK_KEYS.items():
                    a = np.asarray(stage[f"{tag}_{leaf}"][j], np.float32)
                    sd[f"{pre}.{key}"] = _t(a.T if transpose else a)
                table = sd[f"{pre}.attn.relative_position_bias_table"]
                window = int(round((table.shape[0] ** 0.5 + 1) / 2))
                sd[f"{pre}.attn.relative_position_index"] = torch.from_numpy(
                    relative_position_index(window, window).copy())
        if f"layer{si}_downsample" in p:
            dp = p[f"layer{si}_downsample"]
            pre = f"layers.{si}.downsample"
            sd[f"{pre}.norm.weight"] = _t(ln(dp["norm"])["scale"])
            sd[f"{pre}.norm.bias"] = _t(ln(dp["norm"])["bias"])
            sd[f"{pre}.reduction.weight"] = _t(np.asarray(dp["reduction"]["kernel"], np.float32).T)
        si += 1
    return sd


def resnet_state_dict_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """JAX `ResNetEncoder` params (`trunk` + `norm{i}_scale/bias` [H, W, C])
    and batch_stats (`trunk`) → the port's `ResNetEncoder` state dict: the
    torchvision ResNet-50 layout under `res_net.` (HWIO kernels → OIHW, the
    five BatchNorm entries with `num_batches_tracked` 0, the classifier `fc`
    zeroed: nothing reads it) and the stage LayerNorms under `norms.{i}` as
    [C, H, W]. The port's copy of `export_resnet50` (:946) and
    `export_resnet_encoder`; every tensor is a copy."""
    p = _unwrap(params)
    stats = batch_stats["batch_stats"] if "batch_stats" in batch_stats else batch_stats
    tp, ts = p["trunk"], stats["trunk"]
    sd: Dict[str, torch.Tensor] = {}

    def bn(bp, bs, name: str) -> None:
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _t(bp["scale"]), _t(bp["bias"])
        sd[f"{name}.running_mean"], sd[f"{name}.running_var"] = _t(bs["mean"]), _t(bs["var"])
        sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    sd["res_net.conv1.weight"] = _t(_hwio_to_oihw(tp["conv1"]["kernel"]))
    bn(tp["bn1"], ts["bn1"], "res_net.bn1")
    li = 1
    while f"layer{li}_0" in tp:
        bi = 0
        while f"layer{li}_{bi}" in tp:
            bp, bs = tp[f"layer{li}_{bi}"], ts[f"layer{li}_{bi}"]
            dst = f"res_net.layer{li}.{bi}"
            for ci in (1, 2, 3):
                sd[f"{dst}.conv{ci}.weight"] = _t(_hwio_to_oihw(bp[f"conv{ci}"]["kernel"]))
                bn(bp[f"bn{ci}"], bs[f"bn{ci}"], f"{dst}.bn{ci}")
            if "downsample_conv" in bp:
                sd[f"{dst}.downsample.0.weight"] = _t(
                    _hwio_to_oihw(bp["downsample_conv"]["kernel"]))
                bn(bp["downsample_bn"], bs["downsample_bn"], f"{dst}.downsample.1")
            bi += 1
        li += 1
    sd["res_net.fc.weight"] = torch.zeros(1000, 2048)
    sd["res_net.fc.bias"] = torch.zeros(1000)
    i = 0
    while f"norm{i}_scale" in p:
        for key, leaf in (("weight", "scale"), ("bias", "bias")):
            sd[f"norms.{i}.{key}"] = _t(np.transpose(
                np.asarray(p[f"norm{i}_{leaf}"], np.float32), (2, 0, 1)))
        i += 1
    return sd


def interpolate_rel_pos_table(table: np.ndarray, src_window: int, dst_window: int) -> np.ndarray:
    """Bicubic-resize a relative-position bias table [(2Ws-1)², H] to another
    window size on its 2-D grid (`scipy.ndimage.zoom`, order 3)."""
    if src_window == dst_window:
        return table
    import scipy.ndimage

    s, d = 2 * src_window - 1, 2 * dst_window - 1
    heads = table.shape[1]
    out = scipy.ndimage.zoom(table.reshape(s, s, heads), (d / s, d / s, 1.0), order=3)
    if out.shape != (d, d, heads):
        raise ValueError(f"resized bias table has shape {out.shape}, expected {(d, d, heads)}")
    return out.reshape(d * d, heads).astype(table.dtype)


def nf_state_dict_from_jax(params: Mapping[str, Any], num_patches: int,
                           perms: Optional[Sequence[Sequence[int]]] = None
                           ) -> Dict[str, torch.Tensor]:
    """Scan-stacked JAX `NormalizingFlow` params (`a_*` 3x3 pair steps, `b_*`
    1x1 pair steps, `t_*` odd tail) → the port's `NormalizingFlow` state dict
    (FrEIA keys). `perms` defaults to `default_perms`, as for the JAX model."""
    p = _unwrap(params)
    n_pairs = np.asarray(p["a_conv1_kernel"]).shape[0] if "a_conv1_kernel" in p else 0
    tail = "t_conv1_kernel" in p
    steps = 2 * n_pairs + int(tail)
    c = np.asarray(p["a_global_scale" if n_pairs else "t_global_scale"]).shape[-1]
    perms = default_perms(steps, c) if perms is None else perms
    if len(perms) != steps:
        raise ValueError(f"{len(perms)} perms for {steps} steps")
    sd: Dict[str, torch.Tensor] = {}
    for i in range(steps):
        if tail and i == steps - 1:
            leaf = lambda name: np.asarray(p[f"t_{name}"], np.float32)
        else:
            tag = "a" if i % 2 == 0 else "b"
            leaf = lambda name: np.asarray(p[f"{tag}_{name}"][i // 2], np.float32)
        pre = f"fast_flow_decoder.module_list.{i}"
        for slot, src in (("0", "conv1"), ("2", "conv2")):
            sd[f"{pre}.subnet.{slot}.weight"] = _t(_hwio_to_oihw(leaf(f"{src}_kernel")))
            sd[f"{pre}.subnet.{slot}.bias"] = _t(leaf(f"{src}_bias"))
        sd[f"{pre}.global_scale"] = _t(leaf("global_scale").reshape(1, c, 1, 1))
        sd[f"{pre}.global_offset"] = _t(leaf("global_offset").reshape(1, c, 1, 1))
        w_perm = np.zeros((c, c), np.float32)
        w_perm[np.arange(c), np.asarray(perms[i], np.int64)] = 1.0
        sd[f"{pre}.w_perm"] = _t(w_perm.reshape(c, c, 1, 1))
        sd[f"{pre}.w_perm_inv"] = _t(w_perm.T.reshape(c, c, 1, 1))
    side = int(round(np.sqrt(num_patches)))
    sd["layer_norm.weight"] = torch.ones(c, side, side)
    sd["layer_norm.bias"] = torch.zeros(c, side, side)
    return sd


def mdn_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `GaussianMDN` params (w [D_in, D_out, K], b [D_out, K]) → the
    port's `GaussianMDN` state dict, the reference's pi/sigma/mu nn.Linear
    layout: the inverse of `torch_convert.convert_mdn_head` (:418). Row
    e*K + k of sigma/mu.weight is output feature e of component k."""
    p = _unwrap(params)
    w_sigma = np.asarray(p["w_sigma"], np.float32)
    d, _, k = w_sigma.shape
    flat = lambda w: _t(np.asarray(w, np.float32).reshape(d, d * k).T)
    return {
        "pi.weight": _t(np.asarray(p["w_pi"], np.float32).T),
        "pi.bias": _t(p["b_pi"]),
        "sigma.weight": flat(w_sigma),
        "sigma.bias": _t(np.asarray(p["b_sigma"], np.float32).reshape(d * k)),
        "mu.weight": flat(p["w_mu"]),
        "mu.bias": _t(np.asarray(p["b_mu"], np.float32).reshape(d * k)),
    }
