"""Carry JAX-trained weights into the port.

`vit_state_dict_from_jax`, `swin_state_dict_from_jax`,
`nest_state_dict_from_jax`, `efficientformer_state_dict_from_jax`,
`resnet_state_dict_from_jax`, `nf_state_dict_from_jax` and
`mdn_state_dict_from_jax` take the JAX package's params as nested dicts of
numpy arrays (the caller does jax → numpy) and return the port's state dicts,
in the timm, EsViT, timm NesT, timm EfficientFormer, reference-ResNetEncoder,
FrEIA and reference-MDN layouts that `vit_ad_tpu/utils/torch_convert.export_vit`
(:607), `export_swin` (:803), `export_nest` (:662), `export_efficientformer`
(:712), `export_resnet_encoder` (:977), `export_nf_head` (:518) and
`export_mdn_head` (:497) emit (the trunks without their classifier heads).
`efficientnet_state_dict_from_jax` gives the NVIDIA widese layout that
`convert_efficientnet` (:365) reads.
`recon_state_dict_from_jax` takes a JAX auto-encoder's variables (params and
batch_stats) to the port's state dict, in the reference .pth layouts that
`export_vanilla_ae` (:1440), `export_resnet_ae` (:1000) and
`export_transformer_ae` (:1022) emit.
`nf_resnet_state_dicts_from_jax` carries a JAX NF-ResNet run (three stage
flows and the encoder's variables) into the port's stage flows and
`ResNetEncoder`.
`interpolate_rel_pos_table` is the port's copy of the bias-table resize of
`torch_convert.py` (:1099). numpy and scipy only: no jax, no `vit_ad_tpu`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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


def _ln_from_jax(sd: Dict[str, torch.Tensor], tree: Mapping[str, Any], name: str) -> None:
    """A JAX LayerNorm's {scale, bias}, inside the package's wrapper
    ({'LayerNorm_0': ...}) or bare, → `name`'s weight and bias."""
    inner = tree.get("LayerNorm_0", tree)
    sd[f"{name}.weight"], sd[f"{name}.bias"] = _t(inner["scale"]), _t(inner["bias"])


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
    sd = {"patch_embed.proj.weight": _t(_hwio_to_oihw(p["patch_embed"]["kernel"])),
          "patch_embed.proj.bias": _t(p["patch_embed"]["bias"])}
    _ln_from_jax(sd, p["patch_norm"], "patch_embed.norm")
    _ln_from_jax(sd, p["norm"], "norm")
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
            _ln_from_jax(sd, dp["norm"], f"{pre}.norm")
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


def nf_resnet_state_dicts_from_jax(flow_params: Sequence[Mapping[str, Any]],
                                   enc_variables: Mapping[str, Any], img_size: int,
                                   stages: Sequence[int] = (0, 1, 2)
                                   ) -> Tuple[List[Dict[str, torch.Tensor]],
                                              Dict[str, torch.Tensor]]:
    """The JAX `train_nf_resnet`'s weights (one flow param tree per stage of
    `stages`, and the `ResNetEncoder` variables {'params', 'batch_stats'}) →
    (the port's stage `NormalizingFlow` state dicts, its `ResNetEncoder`
    state dict)."""
    from vit_ad_tpu_torch.models.resnet import STAGE_SCALES

    flows = [nf_state_dict_from_jax(p, (img_size // STAGE_SCALES[i]) ** 2)
             for i, p in zip(stages, flow_params)]
    return flows, resnet_state_dict_from_jax(enc_variables["params"],
                                             enc_variables["batch_stats"])


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


def _bn_from_jax(sd: Dict[str, torch.Tensor], bp: Mapping[str, Any], bs: Mapping[str, Any],
                 name: str) -> None:
    """flax BatchNorm (params, batch_stats) → the five `nn.BatchNorm2d` entries
    (`num_batches_tracked` 0: strict loads need the key, nothing reads it)."""
    sd[f"{name}.weight"], sd[f"{name}.bias"] = _t(bp["scale"]), _t(bp["bias"])
    sd[f"{name}.running_mean"], sd[f"{name}.running_var"] = _t(bs["mean"]), _t(bs["var"])
    sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _convt_from_jax(kernel) -> torch.Tensor:
    """flax ConvTranspose kernel [kh, kw, in, out] → torch ConvTranspose2d
    weight [in, out, kh, kw], spatially flipped (`torch_convert._inv_convt`
    :577)."""
    return _t(np.transpose(np.asarray(kernel, np.float32)[::-1, ::-1], (2, 3, 0, 1)))


def _linear_from_jax(sd: Dict[str, torch.Tensor], leaf: Mapping[str, Any], name: str) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(leaf["kernel"], np.float32).T)
    sd[f"{name}.bias"] = _t(leaf["bias"])


def nest_state_dict_from_jax(params: Mapping[str, Any], num_heads: Sequence[int] = (3, 6, 12)
                             ) -> Dict[str, torch.Tensor]:
    """JAX `NesT` params → the port's `NesT` state dict (timm `jx_nest_tiny`
    keys), key for key and value for value `export_nest` (:662) without the
    classifier `head`. `num_heads` (per level) sets the re-permutation of
    `attn.proj`'s input rows from the JAX (heads, head_dim) order to timm's
    (head_dim, heads)."""
    p = _unwrap(params)
    sd = {"patch_embed.proj.weight": _t(_hwio_to_oihw(p["patch_embed"]["kernel"])),
          "patch_embed.proj.bias": _t(p["patch_embed"]["bias"])}
    li = 0
    while f"pos_embed_{li}" in p:
        sd[f"levels.{li}.pos_embed"] = _t(p[f"pos_embed_{li}"])
        if li > 0:
            pool, pre = p[f"pool{li - 1}"], f"levels.{li}.pool"
            sd[f"{pre}.conv.weight"] = _t(_hwio_to_oihw(pool["conv"]["kernel"]))
            sd[f"{pre}.conv.bias"] = _t(pool["conv"]["bias"])
            _ln_from_jax(sd, pool["norm"], f"{pre}.norm")
        bj = 0
        while f"level{li}_block{bj}" in p:
            bp, t = p[f"level{li}_block{bj}"], f"levels.{li}.transformer_encoder.{bj}"
            _ln_from_jax(sd, bp["norm1"], f"{t}.norm1")
            _linear_from_jax(sd, bp["qkv"], f"{t}.attn.qkv")
            pk = np.asarray(bp["proj"]["kernel"], np.float32)  # [C_in, C_out], (heads, hd) rows
            c, heads = pk.shape[0], num_heads[li]
            pk = pk.reshape(heads, c // heads, c).transpose(1, 0, 2).reshape(c, c)
            sd[f"{t}.attn.proj.weight"] = _t(pk.T)
            sd[f"{t}.attn.proj.bias"] = _t(bp["proj"]["bias"])
            _ln_from_jax(sd, bp["norm2"], f"{t}.norm2")
            _linear_from_jax(sd, bp["mlp"]["fc1"], f"{t}.mlp.fc1")
            _linear_from_jax(sd, bp["mlp"]["fc2"], f"{t}.mlp.fc2")
            bj += 1
        li += 1
    _ln_from_jax(sd, p["norm"], "norm")
    return sd


def efficientformer_state_dict_from_jax(variables: Mapping[str, Any]
                                        ) -> Dict[str, torch.Tensor]:
    """JAX `EfficientFormer` variables (params and batch_stats) → the port's
    `EfficientFormer` state dict (timm `efficientformer_l3` keys), key for key
    and value for value `export_efficientformer` (:712) without the
    classifier `head` and `head_dist`: the 3D blocks one slot further on (the
    `Flat` slot), `attention_bias_idxs` recomputed."""
    from vit_ad_tpu_torch.models.efficientformer import abs_rel_pos_index

    p, s = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def conv_bn(bp, bs, conv: str, bn: str) -> None:
        sd[f"{conv}.weight"] = _t(_hwio_to_oihw(bp["conv"]["kernel"]))
        sd[f"{conv}.bias"] = _t(bp["conv"]["bias"])
        _bn_from_jax(sd, bp["bn"], bs["bn"], bn)

    conv_bn(p["stem1"], s["stem1"], "stem.conv1", "stem.norm1")
    conv_bn(p["stem2"], s["stem2"], "stem.conv2", "stem.norm2")
    si = 0
    while f"stage{si}_block0" in p:
        if si > 0:
            conv_bn(p[f"downsample{si}"], s[f"downsample{si}"], f"stages.{si}.downsample.conv",
                    f"stages.{si}.downsample.norm")
        depth = 0
        while f"stage{si}_block{depth}" in p:
            depth += 1
        n_3d = sum("qkv" in p[f"stage{si}_block{bj}"] for bj in range(depth))
        for bj in range(depth):
            bp = p[f"stage{si}_block{bj}"]
            src = f"stages.{si}.blocks.{bj if bj < depth - n_3d else bj + 1}"
            sd[f"{src}.layer_scale_1"] = _t(bp["layer_scale_1"])
            sd[f"{src}.layer_scale_2"] = _t(bp["layer_scale_2"])
            if "qkv" in bp:
                _ln_from_jax(sd, bp["norm1"], f"{src}.norm1")
                _linear_from_jax(sd, bp["qkv"], f"{src}.token_mixer.qkv")
                ab = np.asarray(bp["attention_biases"], np.float32)  # [heads, res²]
                sd[f"{src}.token_mixer.attention_biases"] = _t(ab)
                sd[f"{src}.token_mixer.attention_bias_idxs"] = torch.from_numpy(
                    abs_rel_pos_index(int(round(np.sqrt(ab.shape[1])))))
                _linear_from_jax(sd, bp["proj"], f"{src}.token_mixer.proj")
                _ln_from_jax(sd, bp["norm2"], f"{src}.norm2")
                _linear_from_jax(sd, bp["mlp"]["fc1"], f"{src}.mlp.fc1")
                _linear_from_jax(sd, bp["mlp"]["fc2"], f"{src}.mlp.fc2")
            else:
                bs = s[f"stage{si}_block{bj}"]
                conv_bn(bp["mlp_fc1"], bs["mlp_fc1"], f"{src}.mlp.fc1", f"{src}.mlp.norm1")
                conv_bn(bp["mlp_fc2"], bs["mlp_fc2"], f"{src}.mlp.fc2", f"{src}.mlp.norm2")
        si += 1
    _ln_from_jax(sd, p["norm"], "norm")
    return sd


def efficientnet_state_dict_from_jax(variables: Mapping[str, Any],
                                     blocks: Optional[Sequence[Sequence[int]]] = None
                                     ) -> Dict[str, torch.Tensor]:
    """JAX `EfficientNetEncoder` variables (params and batch_stats) → the
    port's `EfficientNetEncoder` state dict (NVIDIA widese keys), the
    inverse of `convert_efficientnet` (:365): `block{i}` → `layer{L}.block{j}`
    along `blocks` (default B0's, B4-scaled repeats), `depthwise` → `depsep`,
    `project` → `proj`, the 1x1 squeeze-excite convs → Linears, `head` →
    `features`."""
    from vit_ad_tpu_torch.models.efficientnet import B0_BLOCKS, round_repeats

    p, s = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def conv_bn(bp, bs, dst: str) -> None:
        sd[f"{dst}.conv.weight"] = _t(_hwio_to_oihw(bp["conv"]["kernel"]))
        _bn_from_jax(sd, bp["bn"], bs["bn"], f"{dst}.bn")

    conv_bn(p["stem"], s["stem"], "stem")
    bi = 0
    for li, (expand, _ch, reps, _stride, _k) in enumerate(blocks or B0_BLOCKS):
        for r in range(round_repeats(reps)):
            bp, bs, dst = p[f"block{bi}"], s[f"block{bi}"], f"layer{li + 1}.block{r}"
            if expand != 1:
                conv_bn(bp["expand"], bs["expand"], f"{dst}.expand")
            conv_bn(bp["depthwise"], bs["depthwise"], f"{dst}.depsep")
            for src, name in (("se_reduce", "squeeze"), ("se_expand", "expand")):
                k = np.asarray(bp[src]["kernel"], np.float32)  # [1, 1, in, out]
                sd[f"{dst}.se.{name}.weight"] = _t(k.reshape(k.shape[2], k.shape[3]).T)
                sd[f"{dst}.se.{name}.bias"] = _t(bp[src]["bias"])
            conv_bn(bp["project"], bs["project"], f"{dst}.proj")
            bi += 1
    conv_bn(p["head"], s["head"], "features")
    return sd


def small_decoder_state_dict_from_jax(p: Mapping[str, Any], s: Mapping[str, Any]
                                      ) -> Dict[str, torch.Tensor]:
    """`SmallDecoder` params and batch_stats → the reference DecoderVanillaCNN
    / DecoderCNNLinEnd keys (`export_small_decoder` :858): every conv under
    both of its names, the z-space MLP's second Linear re-permuted from the
    JAX NHWC unflatten to the reference's channel-first one."""
    sd: Dict[str, torch.Tensor] = {}
    if "fc1" in p:
        _linear_from_jax(sd, p["fc1"], "decoder_lin.0")
        w = np.asarray(p["fc2"]["kernel"], np.float32)  # [in, s*s*768]
        side = int(round(np.sqrt(w.shape[1] // 768)))
        sd["decoder_lin.2.weight"] = _t(
            w.reshape(-1, side, side, 768).transpose(0, 3, 1, 2).reshape(w.shape[0], -1).T)
        sd["decoder_lin.2.bias"] = _t(np.asarray(p["fc2"]["bias"], np.float32)
                                      .reshape(side, side, 768).transpose(2, 0, 1).reshape(-1))
    for i in range(5):
        leaf = p[f"recon_conv{i + 1}"]
        for name in (f"recon_conv{i + 1}", f"decoder_cnn.{3 * i}"):
            sd[f"{name}.weight"], sd[f"{name}.bias"] = _convt_from_jax(leaf["kernel"]), \
                _t(leaf["bias"])
        _bn_from_jax(sd, p[f"bn{i + 1}"], s[f"bn{i + 1}"], f"decoder_cnn.{3 * i + 1}")
    if "linear_end" in p:
        for name in ("linear_end", "decoder_cnn.14"):
            sd[f"{name}.weight"] = _t(_hwio_to_oihw(p["linear_end"]["kernel"]))
            sd[f"{name}.bias"] = _t(p["linear_end"]["bias"])
    return sd


def reverse_resnet_state_dict_from_jax(p: Mapping[str, Any], s: Mapping[str, Any]
                                       ) -> Dict[str, torch.Tensor]:
    """`ReverseResNet` params (trunk blocks `layer{n}_{i}` at the root, or under
    `trunk` for `ResNetDecoder`), `de_conv1` and `bn1` → the reference
    ReverseResNet keys (`export_reverse_resnet` :934; `export_resnet_decoder`
    :920 adds `fc1.0` and `fc2.0`)."""
    tp, ts = (p["trunk"], s["trunk"]) if "trunk" in p else (p, s)
    sd: Dict[str, torch.Tensor] = {}
    for n in (4, 3, 2, 1):
        i = 0
        while f"layer{n}_{i}" in tp:
            bp, bs, t = tp[f"layer{n}_{i}"], ts[f"layer{n}_{i}"], f"layer{n}.{i}"
            for c in ("conv1", "conv2", "conv3"):
                sd[f"{t}.{c}.weight"] = _convt_from_jax(bp[c]["kernel"])
            for b in ("bn1", "bn2", "bn3"):
                _bn_from_jax(sd, bp[b], bs[b], f"{t}.{b}")
            if "upsample_conv" in bp:
                sd[f"{t}.upsample.0.weight"] = _convt_from_jax(bp["upsample_conv"]["kernel"])
                _bn_from_jax(sd, bp["upsample_bn"], bs["upsample_bn"], f"{t}.upsample.1")
            i += 1
    sd["de_conv1.weight"] = _convt_from_jax(p["de_conv1"]["kernel"])
    _bn_from_jax(sd, p["bn1"], s["bn1"], "bn1")
    if "fc1" in p:
        _linear_from_jax(sd, p["fc1"], "fc1.0")
        _linear_from_jax(sd, p["fc2"], "fc2.0")
    return sd


def vanilla_encoder_state_dict_from_jax(p: Mapping[str, Any], s: Mapping[str, Any]
                                        ) -> Dict[str, torch.Tensor]:
    """`VanillaCNNEncoder` params and batch_stats → the reference
    EncoderVanillaCNN keys (`export_vanilla_encoder` :1425): each conv as
    `conv{i}` and `encoder.{4(i-1)}`, the BatchNorms at `encoder.{4(i-1)+1}`."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(5):
        leaf = p[f"conv{i + 1}"]
        for name in (f"conv{i + 1}", f"encoder.{4 * i}"):
            sd[f"{name}.weight"] = _t(_hwio_to_oihw(leaf["kernel"]))
            sd[f"{name}.bias"] = _t(leaf["bias"])
        _bn_from_jax(sd, p[f"bn{i + 1}"], s[f"bn{i + 1}"], f"encoder.{4 * i + 1}")
    return sd


def recon_state_dict_from_jax(variables: Mapping[str, Any],
                              nest_num_heads: Sequence[int] = (3, 6, 12)
                              ) -> Dict[str, torch.Tensor]:
    """A JAX auto-encoder's variables ({'params', 'batch_stats'} as numpy
    arrays) → the port's AE state dict, key for key the reference .pth layout
    the JAX exporters emit: `VanillaAutoEncoder` (`export_vanilla_ae` :1440),
    `ResNetAutoEncoder` (`export_resnet_ae` :1000) and
    `TransformerAutoEncoder` on a ViT/DeiT, Swin, NesT or EfficientFormer
    trunk (`export_transformer_ae` :1022: the trunk under `encoder.vit.`,
    `encoder.deit.`, `encoder.nest.` or `encoder.efficientformer.` with
    zeroed classifier heads, or `encoder.esvit.`). The encoder family is read
    from the encoder's params, the decoder kind from the decoder's;
    `nest_num_heads` is a NesT trunk's heads per level
    (`nest_state_dict_from_jax`)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    ep, es = p["encoder"], s.get("encoder", {})
    dp, ds = p["decoder"], s.get("decoder", {})
    dec = (small_decoder_state_dict_from_jax(dp, ds) if "recon_conv1" in dp
           else reverse_resnet_state_dict_from_jax(dp, ds))
    if "trunk" in ep:
        enc = resnet_state_dict_from_jax(ep, es)
    elif "conv1" in ep:
        enc = vanilla_encoder_state_dict_from_jax(ep, es)
    elif "esvit" in ep:
        enc = {f"esvit.{k}": v for k, v in swin_state_dict_from_jax(ep).items()}
    elif "prefix_tokens" in ep or "pos_embed_0" in ep or "stem1" in ep:
        if "pos_embed_0" in ep:
            family, heads = "nest", ("head",)
            trunk = nest_state_dict_from_jax(ep, nest_num_heads)
        elif "stem1" in ep:
            family, heads = "efficientformer", ("head", "head_dist")
            trunk = efficientformer_state_dict_from_jax({"params": ep, "batch_stats": es})
        else:
            trunk = vit_state_dict_from_jax(ep)
            family = "deit" if "dist_token" in trunk else "vit"
            heads = ("head", "head_dist") if family == "deit" else ("head",)
        d = trunk["norm.weight"].shape[0]
        for head in heads:  # the timm classifier heads the reference's files carry
            trunk[f"{head}.weight"], trunk[f"{head}.bias"] = torch.zeros(1000, d), \
                torch.zeros(1000)
        enc = {f"{family}.{k}": v for k, v in trunk.items()}
    else:
        raise ValueError(f"no port of the AE encoder with params {sorted(ep)[:6]}")
    return {**{f"encoder.{k}": v for k, v in enc.items()},
            **{f"decoder.{k}": v for k, v in dec.items()}}


def vae_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `VariationalAutoEncoder` variables ({'params', 'batch_stats'} as
    numpy arrays) → the port's `models/vae.VariationalAutoEncoder` state
    dict: the vanilla encoder and the small decoder as the AE converters give
    them, the two Dense heads by a plain transpose (both packages flatten the
    encoder's map in (h, w, c) order)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd = {f"encoder.{k}": v
          for k, v in vanilla_encoder_state_dict_from_jax(p["encoder"], s["encoder"]).items()}
    for name in ("fc_mu", "fc_log_var"):
        _linear_from_jax(sd, p[name], name)
    sd.update({f"decoder.{k}": v
               for k, v in small_decoder_state_dict_from_jax(p["decoder"], s["decoder"]).items()})
    return sd
