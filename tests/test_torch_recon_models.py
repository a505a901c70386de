"""The port's reconstruction models against the JAX package: the training half
of `FusedBatchNorm`, `VanillaCNNEncoder`, `upsample_nearest`,
`ReverseBottleneck`, `ReverseResNet`, `ResNetDecoder` and `SmallDecoder`, each
in eval and in train mode (outputs and the running statistics the step
leaves), with the same jittered weights carried across by the converters of
`utils/convert` and the same seeded inputs; and the state-dict keys against
the JAX exporters. f32 unless stated. The auto-encoders are
tests/test_torch_recon_ae.py's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from test_torch_swin import jax_swin, port_swin
from test_torch_vit import D, IMG
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.models import decoders as jdec
from vit_ad_tpu.models import reverse_resnet as jrr
from vit_ad_tpu.models.cnn import VanillaCNNEncoder as JaxVanillaCNNEncoder
from vit_ad_tpu.models.layers import FusedBatchNorm as JaxFusedBatchNorm
from vit_ad_tpu.utils import torch_convert as tc
from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models import decoders as pdec
from vit_ad_tpu_torch.models import reverse_resnet as prr
from vit_ad_tpu_torch.models.cnn import VanillaCNNEncoder
from vit_ad_tpu_torch.models.layers import FusedBatchNorm
from vit_ad_tpu_torch.utils.convert import (
    reverse_resnet_state_dict_from_jax,
    small_decoder_state_dict_from_jax,
    vanilla_encoder_state_dict_from_jax,
)

F32, JF32 = DtypePolicy.f32(), JaxDtypePolicy.f32()
# f32, the same math, sums in other orders (JAX at "highest" precision,
# tests/conftest.py); relative to the largest entry of each output. RTOL: a
# block, or up to six transposed-conv or conv stages with BatchNorm.
# RTOL_DEEP: the whole ReverseResNet chain (16 bottlenecks: 49 transposed
# convs over up to 4608 terms, 49 BatchNorms dividing by deviations down to
# ~0.2), where the f32 differences of each block (~1.5e-6 of its scale, held
# to RTOL block by block in `test_reverse_resnet_matches_jax`) add up block
# after block to 1e-4 of the trunk's scale and, through the last BatchNorm,
# up to 8e-4 of the output's largest entry (measured at batch 8, 32 px).
RTOL, RTOL_DEEP = 1e-5, 1e-3
# the vanilla CNN's 3x3 conv stages with BatchNorm, in training mode too (five
# in the encoder, ten through its AE): up to 1.2e-5 and 2.6e-5 of the largest
# entry measured
RTOL_CNN = 1e-4
SWIN_IMG = 32


class TinyEsViT(flax_nn.Module):
    """The JAX `EsViTEncoder` wrapper (params under `esvit`, the layout of
    `export_transformer_ae`) around the tiny Swin of tests/test_torch_swin.py."""

    img_size: int = SWIN_IMG

    def setup(self) -> None:
        self.esvit = jax_swin(self.img_size, JF32)

    @property
    def embed_dim(self) -> int:
        return port_swin(self.img_size).embed_dim

    def __call__(self, x, block_index: int = 0):
        return self.esvit(x, block_index=block_index)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _variables(module, *inputs, seed=0, **kw):
    """Seeded random variables of the tree `module.init(key, *inputs, **kw)`
    makes, from `jax.eval_shape` without running it (flax's eager init of
    these decoders takes tens of seconds on the CPU): kernels N(0, 1/fan_in),
    scales 1 + N(0, 0.05²), biases N(0, 0.05²), other params N(0, 0.02²);
    running statistics 0 and 1 (`_calibrated` replaces them)."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name, n = path[-1].key, rng.standard_normal(shape.shape).astype(np.float32)
        if name == "mean":
            return np.zeros(shape.shape, np.float32)
        if name == "var":
            return np.ones(shape.shape, np.float32)
        if name.endswith("kernel"):  # dense [in, out], stacked [depth, in, out], conv HWIO
            dims = shape.shape
            fan_in = dims[0] if len(dims) == 2 else dims[1] if len(dims) == 3 \
                else int(np.prod(dims[:-1]))
            return n / np.float32(np.sqrt(fan_in))
        if name.endswith("scale"):
            return 1.0 + 0.05 * n
        return (0.05 if name.endswith("bias") else 0.02) * n

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(lambda: module.init(jax.random.key(0), *inputs, **kw)))


def _close(got, want, rtol=RTOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


@functools.lru_cache(maxsize=None)
def _apply(jax_mod, train: bool):
    """The module's apply, jitted once per module and mode (train mode
    returns the batch_stats updates too)."""
    if train:
        return jax.jit(lambda v, x: jax_mod.apply(v, x, train=True, mutable=["batch_stats"]))
    return jax.jit(lambda v, x: jax_mod.apply(v, x, train=False))


def _calibrated(jax_mod, variables, jax_in, seed=7):
    """`variables` with running statistics near the batch statistics of
    `jax_in` (recovered from one train-mode step from mean 0, var 1: the
    update is 0.9·init + 0.1·batch), jittered by up to 10%: eval mode then
    sees activations of the scale training gives them, instead of the
    growth that arbitrary statistics compound through a deep decoder."""
    rng = np.random.default_rng(seed)
    unit = jax.tree_util.tree_map_with_path(
        lambda path, a: np.ones_like(a) if path[-1].key == "var" else np.zeros_like(a),
        variables["batch_stats"])
    _, upd = _apply(jax_mod, True)({"params": variables["params"], "batch_stats": unit},
                                   jnp.asarray(jax_in))
    stats = jax.tree_util.tree_map_with_path(
        lambda path, u, i: ((np.asarray(u) - 0.9 * i) / 0.1
                            * (1.0 + 0.1 * rng.random(i.shape))).astype(np.float32),
        upd["batch_stats"], unit)
    return {"params": variables["params"], "batch_stats": stats}


def _both_modes(jax_mod, variables, port_mod, jax_in, port_in, to_port_sd, to_nhwc,
                what, pick=lambda out: out, rtol=RTOL):
    """The module in eval mode, then in train mode: the outputs (`pick` of
    each side's, the port's through `to_nhwc`) and the running statistics
    after the step (JAX `mutable=['batch_stats']`). `port_mod` holds
    `to_port_sd(variables)`."""
    x = jnp.asarray(jax_in)
    want = _apply(jax_mod, False)(variables, x)
    with torch.no_grad():
        got = port_mod.eval()(port_in)
    _close(to_nhwc(pick(got)), pick(want), rtol, what=f"{what} eval")
    want, upd = _apply(jax_mod, True)(variables, x)
    with torch.no_grad():
        got = port_mod.train()(port_in)
    _close(to_nhwc(pick(got)), pick(want), rtol, what=f"{what} train")
    after = to_port_sd({"params": variables["params"], "batch_stats": _np(upd["batch_stats"])})
    own = port_mod.state_dict()
    for k, v in after.items():
        if "running_" in k:
            _close(own[k], v.numpy(), rtol, what=f"{what} {k}")


def _nhwc_of(t):
    return t.permute(0, 2, 3, 1)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_batch_norm_training_matches_jax(dt):
    """Two training steps from running statistics away from (0, 1): f32
    output and both running statistics within 1e-6 of the largest entry (the
    same f32 fast variance, mean(x²) - mean², and blend); under bf16 both
    normalise the bf16 map in f32, so the f32 outputs differ by the order of
    the mean sums only (2e-2: the bf16 cast both sides make after)."""
    rng = np.random.default_rng(5)
    c = 16
    scale, bias, mean = (rng.standard_normal(c).astype(np.float32) for _ in range(3))
    var = (0.5 + rng.random(c)).astype(np.float32)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    policy = JaxDtypePolicy() if dt == "bfloat16" else JF32
    jbn = JaxFusedBatchNorm(use_running_average=False, epsilon=1e-5, dtypes=policy)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    bn = FusedBatchNorm(c).train()
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean.copy()),
                        "running_var": torch.from_numpy(var.copy()),
                        "num_batches_tracked": torch.tensor(0)})
    tol = 1e-6 if dt == "float32" else 2e-2
    for step in range(2):
        x = (2.0 + 3.0 * rng.standard_normal((4, 5, 5, c))).astype(np.float32)
        want, upd = jbn.apply(variables, jnp.asarray(x, jdt), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": _np(upd["batch_stats"])}
        with torch.no_grad():
            got = bn(_nchw(x).to(tdt))
        assert got.dtype == torch.float32
        _close(_nhwc_of(got), want.astype(jnp.float32), tol, f"step {step} output")
        _close(bn.running_mean, variables["batch_stats"]["mean"], 1e-6, f"step {step} mean")
        _close(bn.running_var, variables["batch_stats"]["var"], 1e-6, f"step {step} var")
    assert int(bn.num_batches_tracked) == 2


def test_fused_batch_norm_training_gradient_matches_jax():
    """The batch statistics are differentiated through, as flax does."""
    rng = np.random.default_rng(6)
    c = 8
    x = (1.0 + 2.0 * rng.standard_normal((3, 4, 4, c))).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    scale, bias = 1.0 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c)
    jbn = JaxFusedBatchNorm(use_running_average=False, epsilon=1e-5, dtypes=JF32)
    variables = {"params": {"scale": scale.astype(np.float32), "bias": bias.astype(np.float32)},
                 "batch_stats": {"mean": np.zeros(c, np.float32),
                                 "var": np.ones(c, np.float32)}}

    def f(xx, params):
        out, _ = jbn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(out * g)

    want_x, want_p = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), variables["params"])
    bn = FusedBatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
    xt = _nchw(x).requires_grad_(True)
    (bn(xt) * _nchw(g)).sum().backward()
    _close(_nhwc_of(xt.grad), want_x, what="dx")
    _close(bn.weight.grad, want_p["scale"], what="dscale")
    _close(bn.bias.grad, want_p["bias"], what="dbias")


@pytest.mark.parametrize("img", [32, 100])
def test_vanilla_cnn_encoder_matches_jax(img):
    """At 100 px every pool rounds up: a 4x4 grid, not 3x3."""
    jenc = JaxVanillaCNNEncoder(img_size=img, dtypes=JF32)
    variables = _variables(jenc, jnp.zeros((1, img, img, 3)), train=True)
    enc = VanillaCNNEncoder(img, F32)
    to_sd = lambda v: vanilla_encoder_state_dict_from_jax(v["params"], v["batch_stats"])
    enc.load_state_dict(to_sd(variables), strict=True)
    assert enc.num_patches == jenc.num_patches == (1 if img == 32 else 16)
    x = _x((4, img, img, 3))
    variables = _calibrated(jenc, variables, x)
    enc.load_state_dict(to_sd(variables), strict=True)
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(x)).latent
    _close(got, _apply(jenc, False)(variables, jnp.asarray(x)).latent, what="latent")
    _both_modes(jenc, variables, enc, x, torch.from_numpy(x), to_sd, lambda t: t, "tokens",
                pick=lambda out: out.patch_embedding, rtol=RTOL_CNN)


@pytest.mark.parametrize("src,size", [(2, 8), (7, 12), (4, 4)])
def test_upsample_nearest_matches_jax(src, size):
    x = _x((2, src, src, 3))
    want = jrr._upsample_nearest(jnp.asarray(x), size)
    _close(_nhwc_of(prr.upsample_nearest(_nchw(x), size)), want, 0.0)


@pytest.mark.parametrize("stride", [1, 2])
def test_reverse_bottleneck_matches_jax(stride):
    """Eval and train mode, the running statistics, and the training-mode
    gradients of every parameter and of the input."""
    cin, planes, cout = 32, 8, 16
    jblk = jrr.ReverseBottleneck(planes=planes, out_channels=cout, stride=stride,
                                 upsample_identity=True, dtypes=JF32)
    x = _x((2, 5, 5, cin))
    variables = _calibrated(jblk, _variables(jblk, jnp.asarray(x), seed=1, train=True), x)
    blk = prr.ReverseBottleneck(cin, planes, cout, stride, upsample=True)

    def to_sd(v):  # one block's keys out of the trunk converter
        trunk = {"layer1_0": v["params"]}, {"layer1_0": v["batch_stats"]}
        zero = {"kernel": np.zeros((7, 7, 64, 3), np.float32)}
        bn = {"scale": np.ones(3, np.float32), "bias": np.zeros(3, np.float32)}
        sd = reverse_resnet_state_dict_from_jax(
            {"trunk": trunk[0], "de_conv1": zero, "bn1": bn},
            {"trunk": trunk[1], "bn1": {"mean": np.zeros(3, np.float32),
                                        "var": np.ones(3, np.float32)}})
        return {k[len("layer1.0."):]: v for k, v in sd.items() if k.startswith("layer1.0.")}

    blk.load_state_dict(to_sd(variables), strict=True)
    # the block takes the compute dtype as its second argument
    want = jblk.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = blk.eval()(_nchw(x), torch.float32)
    _close(_nhwc_of(got), want, what="eval")
    want, upd = jblk.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = blk.train()(_nchw(x), torch.float32)
    _close(_nhwc_of(got), want, what="train")
    after = to_sd({"params": variables["params"], "batch_stats": _np(upd["batch_stats"])})
    for k, v in after.items():
        if "running_" in k:
            _close(blk.state_dict()[k], v.numpy(), what=k)
    # the backward in training mode: every parameter's gradient and dx
    g = _x(got.permute(0, 2, 3, 1).shape, seed=3)

    def f(params, xx):
        out, _ = jblk.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * g)

    want_p, want_x = jax.grad(f, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    (blk(xt, torch.float32) * _nchw(g)).sum().backward()
    _close(_nhwc_of(xt.grad), want_x, what="dx")
    want_grads = to_sd({"params": jax.tree.map(np.asarray, want_p),
                        "batch_stats": variables["batch_stats"]})
    for name, p in blk.named_parameters():
        _close(p.grad, want_grads[name].numpy(), what=f"grad {name}")


@pytest.fixture(scope="module")
def jax_resnet_decoder():
    """One ResNetDecoder at 32 px, shared by the tests of the decoders on its
    trunk."""
    jd = jdec.ResNetDecoder(embedding_size=D, img_size=IMG, dtypes=JF32)
    variables = _variables(jd, jnp.zeros((1, D)), seed=3, train=True)
    return jd, variables


def test_reverse_resnet_matches_jax(jax_resnet_decoder):
    """The ReverseResNet of the shared decoder's trunk, de_conv1 and bn1 (the
    JAX ReverseResNet's tree: the trunk's blocks at its root)."""
    p, st = (jax_resnet_decoder[1][k] for k in ("params", "batch_stats"))
    variables = {"params": {**p["trunk"], "de_conv1": p["de_conv1"], "bn1": p["bn1"]},
                 "batch_stats": {**st["trunk"], "bn1": st["bn1"]}}
    jdec_ = jrr.ReverseResNet(img_size=IMG, dtypes=JF32)
    to_sd = lambda v: reverse_resnet_state_dict_from_jax(v["params"], v["batch_stats"])
    z = _x((8, 2048))
    variables = _calibrated(jdec_, variables, z)
    dec = prr.ReverseResNet(IMG, F32)
    dec.load_state_dict(to_sd(variables), strict=True)
    _both_modes(jdec_, variables, dec, z, torch.from_numpy(z), to_sd, _nhwc_of, "ReverseResNet",
                rtol=RTOL_DEEP)
    assert set(dec.state_dict()) == set(tc.export_reverse_resnet(variables))
    # block by block, each port block fed the JAX block's input: RTOL
    x = jrr._upsample_nearest(jnp.asarray(z)[:, None, None, :], IMG // 32)
    for train in (False, True):
        dec.load_state_dict(to_sd(variables), strict=True)
        dec.train(train)
        _, st = jax.jit(lambda v, zz: jdec_.apply(
            v, zz, train=train, mutable=["batch_stats", "intermediates"],
            capture_intermediates=True))(variables, jnp.asarray(z))
        block_in = x
        for layer, *_ in prr.STAGES:
            for i, blk in enumerate(getattr(dec, f"layer{layer}")):
                want = st["intermediates"][f"layer{layer}_{i}"]["__call__"][0]
                with torch.no_grad():
                    got = blk(_nchw(block_in), torch.float32)
                _close(_nhwc_of(got), want, what=f"layer{layer}.{i} train={train}")
                block_in = want


def test_resnet_decoder_matches_jax(jax_resnet_decoder):
    jd, variables = jax_resnet_decoder
    to_sd = lambda v: reverse_resnet_state_dict_from_jax(v["params"], v["batch_stats"])
    z = _x((8, D))
    variables = _calibrated(jd, variables, z)
    dec = pdec.ResNetDecoder(D, IMG, F32)
    dec.load_state_dict(to_sd(variables), strict=True)
    assert set(dec.state_dict()) == set(tc.export_resnet_decoder(variables))
    _both_modes(jd, variables, dec, z, torch.from_numpy(z), to_sd, _nhwc_of, "ResNetDecoder",
                rtol=RTOL_DEEP)


@pytest.mark.parametrize("img,z_space,linear_end", [(32, 0, False), (64, 24, False),
                                                    (32, 24, True), (100, 0, True)])
def test_small_decoder_matches_jax(img, z_space, linear_end):
    """z_space 0 takes a [s, s, 768] map, z_space > 0 a latent through the
    MLP (the reference's channel-first unflatten); linear_end ends in a 3x3
    conv instead of tanh; 100 px: s = ceil(100/32) = 4."""
    jd = jdec.SmallDecoder(img_size=img, z_space=z_space, linear_end=linear_end, dtypes=JF32)
    s = -(-img // 32)
    shape = (2, z_space) if z_space else (2, s, s, 768)
    z = _x(shape)
    variables = _calibrated(jd, _variables(jd, jnp.zeros(shape), seed=4, train=True), z)
    to_sd = lambda v: small_decoder_state_dict_from_jax(v["params"], v["batch_stats"])
    dec = pdec.SmallDecoder(img, z_space, linear_end, F32)
    dec.load_state_dict(to_sd(variables), strict=True)
    assert set(dec.state_dict()) == set(tc.export_small_decoder(variables))
    port_in = torch.from_numpy(z) if z_space else _nchw(z)
    _both_modes(jd, variables, dec, z, port_in, to_sd, _nhwc_of,
                f"SmallDecoder z={z_space} linear_end={linear_end}")
