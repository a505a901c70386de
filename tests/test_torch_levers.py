"""The JAX package's opt-in model levers in the port, each against the JAX
package with the same environment variable set on both sides (both read it
at call time; every JAX forward here is traced afresh, so no jit cache
replays another case's route):

  * `VITAD_SWIN_PARTITION=gather`, `VITAD_SWIN_PACKED=0` (the split route onto
    B5a's plain version), `VITAD_SWIN_LN_FOLD=1` on the Swin of the JAX
    package's own lever tests (tests/test_swin.py: 32 px, patch 2, embed 8,
    depths 2/2, heads 2/4, window 4);
  * `VITAD_VIT_LN_FOLD=1` on the tiny ViT of tests/test_torch_vit.py, with the
    fused MLP taken and not;
  * `VITAD_BF16_LN=1` on the LayerNorm module and the Swin trunk under bf16;
  * `VITAD_EFFNET_HARDSWISH=1` on the toy EfficientNet of
    tests/test_torch_efficientnet.py;
  * `VITAD_FOLD_FLOW_PERMS=1` and `VITAD_NF_REVERSIBLE=1` on the flows of
    tests/test_torch_flow.py, and one reversible train step of `train_nf`'s
    and of `train_nf_resnet`'s against the plain step.

f32 throughout but for the bf16 control, as the JAX package's lever tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_ad_tpu.models.efficientnet as jax_effnet
import test_torch_vit as tv
from test_torch_efficientnet import TOY_BLOCKS, port_effnet
from test_torch_flow import C as FLOW_C
from test_torch_flow import SIDE as FLOW_SIDE
from test_torch_flow import _features, jax_flow, jax_flow_params, port_flow
from test_torch_vit import jitter
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.models.flow import NormalizingFlow as JaxFlow
from vit_ad_tpu.models.layers import LayerNorm as JaxLayerNorm
from vit_ad_tpu.models.swin import SwinTransformer as JaxSwin
from vit_ad_tpu.ops import window_attention as jax_wa
from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models import flow as pflow
from vit_ad_tpu_torch.models import layers
from vit_ad_tpu_torch.models import swin as pswin
from vit_ad_tpu_torch.models import vit as pvit
from vit_ad_tpu_torch.models.flow import NormalizingFlow
from vit_ad_tpu_torch.models.swin import SwinTransformer
from vit_ad_tpu_torch.ops import window_attention as wa
from vit_ad_tpu_torch.ops.cuda import window_attention as cwa
from vit_ad_tpu_torch.utils.convert import (
    efficientnet_state_dict_from_jax,
    nf_state_dict_from_jax,
    swin_state_dict_from_jax,
    vit_state_dict_from_jax,
)

LEVERS = ("VITAD_SWIN_PARTITION", "VITAD_SWIN_PACKED", "VITAD_SWIN_LN_FOLD",
          "VITAD_VIT_LN_FOLD", "VITAD_BF16_LN", "VITAD_EFFNET_HARDSWISH",
          "VITAD_FOLD_FLOW_PERMS", "VITAD_NF_REVERSIBLE")
SWIN = dict(img_size=32, patch_size=2, embed_dim=8, depths=(2, 2), num_heads=(2, 4), window=4)
# f32, the JAX lever tests' tolerances: the split route and the folds sum in
# other orders (the fold also recovers LN(x)·W as r·(x·W' - μ·colsum));
# the reversible gradients differ from autodiff by the inverse's roundoff
ATOL_ROUTE = 2e-5
FOLD_TOL = 2e-4
REV_RTOL, REV_ATOL = 2e-4, 2e-6
FLOW_LOSS_RTOL, FLOW_MAP_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _no_levers(monkeypatch):
    for name in LEVERS:
        monkeypatch.delenv(name, raising=False)


def _apply(model, variables, x, **kw):
    """A fresh jit of the JAX forward: the levers are read while tracing."""
    return jax.jit(lambda v, a: model.apply(v, a, **kw))(variables, jnp.asarray(x))


def _counting(monkeypatch, module, name):
    """Replace `module.name` by a wrapper that counts its calls."""
    calls, fn = [], getattr(module, name)

    def spy(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


# ---- Swin ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def swin():
    model = JaxSwin(**SWIN, dtypes=JaxDtypePolicy.f32())
    params = jitter(jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3))),
                    np.random.default_rng(0), 0.05)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    return {"model": model, "params": params, "x": x,
            "state": swin_state_dict_from_jax(params)}


def _port_swin(state, dtypes=None, fused_ln=False):
    enc = SwinTransformer(**SWIN, dtypes=dtypes or DtypePolicy.f32(), fused_ln=fused_ln)
    enc.load_state_dict(state, strict=True)
    return enc


def _tokens(enc, x):
    with torch.inference_mode():
        return enc(torch.from_numpy(x)).patch_embedding


@pytest.mark.parametrize("hp,wp,window,shift", [(8, 8, 4, 0), (8, 8, 4, 2), (12, 8, 4, 2),
                                                (14, 14, 7, 3), (56, 56, 14, 7)])
def test_partition_perm_equals_jax_and_inverts(hp, wp, window, shift):
    perm, inv = wa.partition_perm(hp, wp, window, shift)
    want_perm, want_inv = jax_wa.partition_perm(hp, wp, window, shift)
    assert np.array_equal(perm, want_perm) and np.array_equal(inv, want_inv)
    x = torch.randn(2, hp, wp, 3, generator=torch.Generator().manual_seed(0))
    p, i = wa.partition_indices(hp, wp, window, shift, x.device)
    assert p.dtype == i.dtype == torch.int64
    assert wa.partition_indices(hp, wp, window, shift, x.device)[0] is p  # made once
    got = x.reshape(2, hp * wp, 3).index_select(1, p).reshape(-1, window * window, 3)
    rolled = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    assert torch.equal(got, wa.window_partition(rolled, window))
    back = got.reshape(2, hp * wp, 3).index_select(1, i).reshape(2, hp, wp, 3)
    assert torch.equal(back, x)


def test_swin_gather_is_bit_equal_and_matches_jax(swin, monkeypatch):
    enc = _port_swin(swin["state"])
    plain = _tokens(enc, swin["x"])
    monkeypatch.setenv("VITAD_SWIN_PARTITION", "gather")
    rolls = _counting(monkeypatch, torch, "roll")
    got = _tokens(enc, swin["x"])
    assert rolls == []  # the shift is folded into the permutation
    assert torch.equal(got, plain)
    want = _apply(swin["model"], swin["params"], swin["x"]).patch_embedding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL_ROUTE)


def test_swin_split_route_takes_b5a_and_matches_jax(swin, monkeypatch):
    """`VITAD_SWIN_PACKED=0`: every block's attention goes through the split
    entry (on the CPU its plain version), none through the packed one; the
    JAX side takes its split core (`VITAD_PALLAS_WINDOW_ATTN=1`, which on
    the CPU is `window_attention_core`)."""
    enc = _port_swin(swin["state"])
    plain = _tokens(enc, swin["x"])
    monkeypatch.setenv("VITAD_SWIN_PACKED", "0")
    split = _counting(monkeypatch, cwa, "split_window_attention")
    packed = _counting(monkeypatch, cwa, "swin_attention_windows")
    monkeypatch.setattr(pswin, "swin_attention_windows", cwa.swin_attention_windows)
    before = cwa.split_launches
    got = _tokens(enc, swin["x"])
    assert (len(split), len(packed)) == (4, 0)
    assert cwa.split_launches == before  # CPU tensors: the plain version, no launch
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=ATOL_ROUTE)
    monkeypatch.setenv("VITAD_PALLAS_WINDOW_ATTN", "1")
    want = _apply(swin["model"], swin["params"], swin["x"]).patch_embedding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL_ROUTE)


@pytest.mark.parametrize("gather", [False, True], ids=["roll", "gather"])
def test_swin_ln_fold_matches_jax(swin, monkeypatch, gather):
    """`VITAD_SWIN_LN_FOLD=1`, alone and with the gather partition: the block
    norms ride the qkv and fc1 GEMMs (8 folded GEMMs, no block norm)."""
    enc = _port_swin(swin["state"], fused_ln=True)
    monkeypatch.setenv("VITAD_SWIN_LN_FOLD", "1")
    if gather:
        monkeypatch.setenv("VITAD_SWIN_PARTITION", "gather")
    folds = _counting(monkeypatch, pswin, "ln_fold_gemm")
    norms = _counting(monkeypatch, layers, "layer_norm")
    got = _tokens(enc, swin["x"])
    assert len(folds) == 8
    assert len(norms) == 3  # the patch norm, the merge norm, the final norm
    want = _apply(swin["model"], swin["params"], swin["x"]).patch_embedding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FOLD_TOL, atol=FOLD_TOL)


def test_swin_ln_fold_is_off_where_a_stage_pads(monkeypatch):
    """A 10x10 map under window 4 pads in both stages: the fold stays off
    (padding the normed map is not padding the raw one), bit for bit."""
    enc = SwinTransformer(img_size=40, patch_size=4, embed_dim=8, depths=(2, 2),
                          num_heads=(2, 4), window=4, dtypes=DtypePolicy.f32(),
                          generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(2).standard_normal((2, 40, 40, 3)).astype(np.float32)
    plain = _tokens(enc, x)
    monkeypatch.setenv("VITAD_SWIN_LN_FOLD", "1")
    folds = _counting(monkeypatch, pswin, "ln_fold_gemm")
    assert torch.equal(_tokens(enc, x), plain) and folds == []


def test_swin_ln_fold_follows_a_changed_weight(swin, monkeypatch):
    """The folded W', colsum and b' are cached with the compute-dtype weights:
    made once while the parameters stay, made again when one changes."""
    monkeypatch.setenv("VITAD_SWIN_LN_FOLD", "1")
    enc = _port_swin(swin["state"])
    first = _tokens(enc, swin["x"])
    fold1 = lambda: enc.compute_weights()["stages"][0]["blocks"][0]["fold1"]
    with torch.no_grad():
        cached = fold1()
        assert fold1() is cached
        enc.layers[0].blocks[0].norm1.weight.mul_(1.5)
        enc.layers[1].blocks[1].norm2.bias.add_(0.1)
    moved = _tokens(enc, swin["x"])
    with torch.no_grad():
        assert fold1() is not cached
    monkeypatch.delenv("VITAD_SWIN_LN_FOLD")
    want = _tokens(enc, swin["x"])  # the same weights through the norms
    assert not torch.allclose(moved, first, atol=1e-3)
    np.testing.assert_allclose(moved.numpy(), want.numpy(), rtol=FOLD_TOL, atol=FOLD_TOL)


# ---- ViT ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def vit():
    params = tv.jax_params(2)
    return {"params": params, "x": tv._images(), "state": vit_state_dict_from_jax(params)}


def _port_vit(state, gelu_tanh=None, fused_mlp=False):
    enc = pvit.ViTEncoder(img_size=tv.IMG, patch_size=tv.PATCH, embed_dim=tv.D, depth=tv.DEPTH,
                          num_heads=tv.HEADS, num_prefix_tokens=2, dtypes=DtypePolicy.f32(),
                          gelu_tanh=gelu_tanh, fused_mlp=fused_mlp)
    enc.load_state_dict(state, strict=True)
    return enc


@pytest.mark.parametrize("fused_mlp", [False, True], ids=["stock_tail", "fused_mlp"])
def test_vit_ln_fold_matches_jax(vit, monkeypatch, fused_mlp):
    """`VITAD_VIT_LN_FOLD=1` with the tanh GELU. With the MLP kernel taken
    (its gate opened for the tiny width) norm1 folds and norm2 stays the
    kernel's, as in JAX, where the MLP kernel's test comes first; with the
    stock tail both fold. The JAX side (no MLP kernel on the CPU) folds both:
    the same function."""
    enc = _port_vit(vit["state"], gelu_tanh=True, fused_mlp=fused_mlp)
    monkeypatch.setattr(pvit, "use_fused_mlp", lambda d, hidden: True)
    monkeypatch.setenv("VITAD_VIT_LN_FOLD", "1")
    folds = _counting(monkeypatch, pvit, "ln_fold_gemm")
    mlps = _counting(monkeypatch, pvit, "mlp_block")
    norms = _counting(monkeypatch, pvit, "layer_norm")
    with torch.inference_mode():
        got = enc(torch.from_numpy(vit["x"])).patch_embedding
    assert (len(folds), len(mlps)) == ((2, 2) if fused_mlp else (4, 0))
    assert len(norms) == 1  # the final norm
    model = tv.jax_encoder(2, JaxDtypePolicy.f32()).clone(gelu_tanh=True)
    want = _apply(model, vit["params"], vit["x"]).patch_embedding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FOLD_TOL, atol=FOLD_TOL)


@pytest.mark.parametrize("block_index", [0, 1])
def test_vit_ln_fold_erf_gelu_matches_jax(vit, monkeypatch, block_index):
    enc = _port_vit(vit["state"])
    monkeypatch.setenv("VITAD_VIT_LN_FOLD", "1")
    with torch.inference_mode():
        got = enc(torch.from_numpy(vit["x"]), block_index=block_index).patch_embedding
    want = _apply(tv.jax_encoder(2, JaxDtypePolicy.f32()), vit["params"], vit["x"],
                  block_index=block_index).patch_embedding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FOLD_TOL, atol=FOLD_TOL)


def test_vit_ln_fold_follows_a_changed_weight(vit, monkeypatch):
    monkeypatch.setenv("VITAD_VIT_LN_FOLD", "1")
    enc = _port_vit(vit["state"])
    x = torch.from_numpy(vit["x"])
    with torch.inference_mode():
        first = enc(x).patch_embedding
    with torch.no_grad():
        cached = enc.compute_weights()["blocks"][1]["fold2"]
        enc.blocks[1].mlp.fc1.weight.mul_(-1.0)
        enc.blocks[0].norm1.bias.add_(0.2)
    with torch.inference_mode():
        moved = enc(x).patch_embedding
    with torch.no_grad():
        assert enc.compute_weights()["blocks"][1]["fold2"] is not cached
    monkeypatch.delenv("VITAD_VIT_LN_FOLD")
    with torch.inference_mode():
        want = enc(x).patch_embedding
    assert not torch.allclose(moved, first, atol=1e-3)
    np.testing.assert_allclose(moved.numpy(), want.numpy(), rtol=FOLD_TOL, atol=FOLD_TOL)


def test_ln_fold_gemm_rounding_points():
    """`ln_fold_gemm` under bf16 against its definition: W' rounded to bf16,
    colsum in f32 over the rounded W', b' in f32, the raw GEMM in bf16, the
    correction in f32, one cast."""
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(5, 7, 16, generator=g) * 3 + 1).to(torch.bfloat16)
    gamma, beta = torch.rand(16, generator=g) + 0.5, torch.randn(16, generator=g)
    w = torch.randn(24, 16, generator=g).to(torch.bfloat16)
    b = torch.randn(24, generator=g).to(torch.bfloat16)
    folded = layers.ln_fold_weights(gamma, beta, w, b, torch.bfloat16)
    wp = (w.float() * gamma).to(torch.bfloat16)
    assert torch.equal(folded[0], wp)
    assert torch.equal(folded[1], wp.float().sum(dim=1))
    torch.testing.assert_close(folded[2], w.float() @ beta + b.float(), rtol=0, atol=1e-5)
    mu = x.float().mean(-1, keepdim=True)
    r = torch.rsqrt(((x.float() - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
    raw = torch.nn.functional.linear(x, wp)
    want = (r * (raw.float() - mu * folded[1]) + folded[2]).to(torch.bfloat16)
    got = layers.ln_fold_gemm(x, folded, 1e-5, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7, atol=2.0**-7)


# ---- bf16 LayerNorm control ---------------------------------------------------

def test_bf16_ln_control_matches_jax_layer_norm(monkeypatch):
    """`VITAD_BF16_LN=1` on the LayerNorm module under bf16: f32 statistics,
    the normalize in bf16 ops, as the JAX module; the f32 policy and the
    fused route do not take it."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, 10, 48)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(48)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    port = layers.LayerNorm(48, eps=1e-5, dtypes=DtypePolicy())
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    variables = {"params": {"LayerNorm_0": {"scale": scale, "bias": bias}}}
    jln = JaxLayerNorm(dtypes=JaxDtypePolicy(), eps=1e-5)
    with torch.no_grad():
        plain = port(xt)
    monkeypatch.setenv("VITAD_BF16_LN", "1")
    want = np.asarray(_apply(jln, variables, xb).astype(jnp.float32))
    with torch.no_grad():
        got = port(xt)
        fused = layers.LayerNorm(48, eps=1e-5, dtypes=DtypePolicy(), fused=True)
        fused.load_state_dict(port.state_dict())
        assert torch.equal(fused(xt), plain)
        f32 = layers.LayerNorm(48, eps=1e-5, dtypes=DtypePolicy.f32())
        f32.load_state_dict(port.state_dict())
        assert torch.equal(f32(xt.float()).to(torch.bfloat16), plain)
    assert got.dtype == torch.bfloat16 and not torch.equal(got, plain)
    # each side rounds four bf16 ops: at most a couple of ulps of |y| <= 8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=0.07)


def test_bf16_ln_control_on_the_swin_trunk_matches_jax(swin, monkeypatch):
    """The Swin trunk under the bf16 policy with the fused LayerNorm off: the
    patch, merge and final norms take the control, the block norms (the JAX
    functional norm) do not."""
    enc = _port_swin(swin["state"], dtypes=DtypePolicy())
    plain = _tokens(enc, swin["x"])
    monkeypatch.setenv("VITAD_BF16_LN", "1")
    got = _tokens(enc, swin["x"])
    assert not torch.equal(got, plain)
    model = JaxSwin(**SWIN, dtypes=JaxDtypePolicy())
    want = _apply(model, swin["params"], swin["x"]).patch_embedding.astype(jnp.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), rtol=0, atol=0.1)


# ---- EfficientNet hard-swish ----------------------------------------------------

def test_efficientnet_hardswish_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_effnet, "_B0_BLOCKS", TOY_BLOCKS)
    model = jax_effnet.EfficientNetEncoder(img_size=32, dtypes=JaxDtypePolicy.f32())
    variables = jitter(jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)))), np.random.default_rng(0), 0.05)
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    enc = port_effnet()
    enc.load_state_dict(efficientnet_state_dict_from_jax(variables, TOY_BLOCKS), strict=True)
    plain = _tokens(enc, x)
    monkeypatch.setenv("VITAD_EFFNET_HARDSWISH", "1")
    got = _tokens(enc, x)
    want = _apply(model, variables, x)
    assert not torch.allclose(got, plain, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.patch_embedding), rtol=0,
                               atol=2e-6)


# ---- flows --------------------------------------------------------------------

def _loaded_flow(steps, params):
    flow = port_flow(steps)
    flow.load_state_dict(nf_state_dict_from_jax(params, FLOW_SIDE * FLOW_SIDE), strict=True)
    return flow


@pytest.mark.parametrize("steps", [3, 4])
def test_folded_flow_matches_jax(steps, monkeypatch):
    """`VITAD_FOLD_FLOW_PERMS=1`: the scoring forward through the folded
    steps, against JAX's folded forward and the port's plain one; z comes
    back in the original channel order (JAX `transform_folded`)."""
    params, x = jax_flow_params(steps), _features()
    flow = _loaded_flow(steps, params)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        plain = flow(xt)
        z_folded, ld_folded = flow.transform_folded(xt)
        z, ld = flow.transform(xt)
    jf = jax_flow(steps)
    z_want, ld_want = _apply(jf, params, x, method=JaxFlow.transform_folded)
    np.testing.assert_allclose(z_folded.numpy(), np.asarray(z_want), rtol=0, atol=FLOW_MAP_ATOL)
    np.testing.assert_allclose(ld_folded.numpy(), np.asarray(ld_want), rtol=FLOW_LOSS_RTOL)
    np.testing.assert_allclose((z_folded ** 2).sum(-1).numpy(), (z ** 2).sum(-1).numpy(),
                               rtol=1e-5, atol=1e-5)
    monkeypatch.setenv("VITAD_FOLD_FLOW_PERMS", "1")
    calls = _counting(monkeypatch, NormalizingFlow, "_transform_folded_nchw")
    with torch.no_grad():
        got = flow(xt)
    assert len(calls) == 1
    want = _apply(jf, params, x)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss), rtol=FLOW_LOSS_RTOL)
    np.testing.assert_allclose(got.loss.numpy(), plain.loss.numpy(), rtol=FLOW_LOSS_RTOL)
    np.testing.assert_allclose(got.anomaly_score_map.numpy(),
                               np.asarray(want.anomaly_score_map), rtol=0, atol=FLOW_MAP_ATOL)


def _port_grads(flow, x, reversible, monkeypatch):
    if reversible:
        monkeypatch.setenv("VITAD_NF_REVERSIBLE", "1")
    else:
        monkeypatch.delenv("VITAD_NF_REVERSIBLE", raising=False)
    flow.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = flow(xt).loss
    loss.backward()
    grads = {k: p.grad.clone() for k, p in flow.named_parameters() if p.grad is not None}
    return loss.detach(), grads, xt.grad.clone()


@pytest.mark.parametrize("steps", [3, 4])
def test_reversible_flow_gradients_match_jax_and_autodiff(steps, monkeypatch):
    """`VITAD_NF_REVERSIBLE=1`: the loss equals the plain forward's to the
    bit; the gradients of every step's parameters and of the input match
    JAX's reversible gradients and the port's own autodiff at JAX's
    tolerance (tests/test_flow_reversible.py)."""
    params, x = jax_flow_params(steps, seed=7), _features(seed=8)
    flow = _loaded_flow(steps, params)
    loss_plain, g_plain, gx_plain = _port_grads(flow, x, False, monkeypatch)
    calls = _counting(monkeypatch, NormalizingFlow, "_transform_nchw")
    loss_rev, g_rev, gx_rev = _port_grads(flow, x, True, monkeypatch)
    assert len(calls) == 1 and torch.equal(loss_rev, loss_plain)
    assert sorted(g_rev) == sorted(g_plain) and len(g_rev) == 6 * steps
    for k in g_plain:
        np.testing.assert_allclose(g_rev[k].numpy(), g_plain[k].numpy(), rtol=REV_RTOL,
                                   atol=REV_ATOL, err_msg=k)
    np.testing.assert_allclose(gx_rev.numpy(), gx_plain.numpy(), rtol=REV_RTOL, atol=REV_ATOL)
    jf = jax_flow(steps)
    loss = jax.jit(jax.value_and_grad(lambda v, a: jf.apply(v, a).loss, argnums=(0, 1)))
    _, (gp, gx) = loss(params, jnp.asarray(x))
    want = nf_state_dict_from_jax(jax.tree.map(np.asarray, gp), FLOW_SIDE * FLOW_SIDE)
    for k in g_rev:
        np.testing.assert_allclose(g_rev[k].numpy(), want[k].numpy(), rtol=REV_RTOL,
                                   atol=REV_ATOL, err_msg=k)
    np.testing.assert_allclose(gx_rev.numpy(), np.asarray(gx), rtol=REV_RTOL, atol=REV_ATOL)


def test_reversible_flow_is_not_taken_without_grad(monkeypatch):
    flow = port_flow(3)
    x = torch.from_numpy(_features())
    monkeypatch.setenv("VITAD_NF_REVERSIBLE", "1")
    spy = _counting(monkeypatch, pflow._ReversibleSteps, "apply")
    with torch.no_grad():
        flow.transform(x)
    with torch.inference_mode():
        flow(x)
    assert spy == []
    flow.transform(x)
    assert spy == ["apply"]


def test_reversible_train_nf_step_matches_the_plain_step(monkeypatch):
    """One `train_nf` optimizer step (`masked_nf_loss`, Adam) with the lever
    on against the plain step from the same head: the same loss, the same
    parameters after the step (Adam's first step is lr · g / (|g| + eps),
    so the gradients' roundoff moves it by far less than lr)."""
    from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
    from vit_ad_tpu_torch.pipeline.train import masked_nf_loss, train_step

    feats = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, FLOW_SIDE * FLOW_SIDE, FLOW_C)).astype(np.float32))
    valid = torch.tensor([1.0, 1.0, 1.0, 0.0])
    out = {}
    for rev in (False, True):
        if rev:
            monkeypatch.setenv("VITAD_NF_REVERSIBLE", "1")
        flow = NormalizingFlow(FLOW_C, 16, FLOW_SIDE * FLOW_SIDE, hidden_ratio=0.5,
                               flow_steps=4, generator=torch.Generator().manual_seed(11))
        opt = torch_adam(flow.parameters(), 1e-3, 1e-5)
        loss = train_step(masked_nf_loss, flow, opt, feats, valid, None)
        out[rev] = (loss, {k: v.clone() for k, v in flow.state_dict().items()})
    assert torch.equal(out[True][0], out[False][0])
    for k, v in out[False][1].items():
        np.testing.assert_allclose(out[True][1][k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_reversible_nf_resnet_gradients_match_autodiff(monkeypatch):
    """`train_nf_resnet`'s objective on a 32-px ResNet-50 (f32): the flows'
    and the stage norms' gradients with the lever on against the plain
    backward (the stage norms' reach the flows' input through the
    reversible backward)."""
    from vit_ad_tpu_torch.models.resnet import ResNetEncoder
    from vit_ad_tpu_torch.pipeline.train import nf_resnet_loss, stage_flow
    from vit_ad_tpu_torch.config import HyperParams

    hp = HyperParams(img_size=32, flow_steps=3, hidden_ratio=0.05, dtypes=DtypePolicy.f32())
    enc = ResNetEncoder(32, DtypePolicy.f32(), generator=torch.Generator().manual_seed(0)).eval()
    init = torch.Generator().manual_seed(1)
    flows = torch.nn.ModuleList(stage_flow(hp, i, init) for i in (0, 1, 2))
    images = torch.from_numpy(np.random.default_rng(12).integers(
        0, 256, (2, 32, 32, 3), dtype=np.uint8))
    trainable = torch.nn.ModuleDict({"flows": flows, "norms": enc.norms})
    grads = {}
    for rev in (False, True):
        if rev:
            monkeypatch.setenv("VITAD_NF_REVERSIBLE", "1")
        trainable.zero_grad(set_to_none=True)
        nf_resnet_loss(enc, flows, images, torch.ones(2), None, None).backward()
        grads[rev] = {k: p.grad.clone() for k, p in trainable.named_parameters()
                      if p.grad is not None}
    assert sorted(grads[True]) == sorted(grads[False])
    assert any(k.startswith("norms.") for k in grads[True])
    for k, g in grads[False].items():
        np.testing.assert_allclose(grads[True][k].numpy(), g.numpy(), rtol=REV_RTOL,
                                   atol=REV_ATOL, err_msg=k)
