"""Port GMM math (`vit_ad_tpu_torch/ops/gmm.py`, `ops/cuda/gmm.py` on CPU
tensors, i.e. the plain version of the B2/B3/B4 kernels) against the JAX
package: `fused_log_likelihood`, `log_likelihood_dense`, the bf16 operand
rounding against the Pallas kernel in interpret mode, the gradients against
`jax.grad` and against the Pallas training kernels, and the Gumbel noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ad_tpu.ops import gmm as jgmm
from vit_ad_tpu.ops.pallas.gmm import gmm_log_likelihood_pallas
from vit_ad_tpu.ops.pallas.gmm_train import gmm_log_likelihood_train
from vit_ad_tpu_torch.ops import gmm
from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

# f32, the same math: sums over D and K in other orders; ll is O(1..10), and
# O(100) where one narrow component dominates (a few f32 ulps relative).
ATOL, RTOL = 1e-5, 2e-6
# gradients: the same, through a logsumexp and a mean; relative to the
# largest entry of each gradient.
GRAD_RTOL = 1e-4


def _args(seed, b=2, p=5, d=32, k=6):
    """x [B,P,D], pi head, and sigma/mu heads in the JAX layout [D,D,K]."""
    r = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * r.standard_normal(s)).astype(np.float32)
    return {"x": f(b, p, d), "w_pi": f(d, k, sc=0.3), "b_pi": f(k, sc=0.1),
            "w_sigma": f(d, d, k, sc=0.15), "b_sigma": f(d, k, sc=0.1),
            "w_mu": f(d, d, k, sc=0.15), "b_mu": f(d, k, sc=0.1)}


NAMES = ("x", "w_pi", "b_pi", "w_sigma", "b_sigma", "w_mu", "b_mu")


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _linear(w, b):
    """JAX layout → nn.Linear layout ([D*K, D_in], [D*K])."""
    d, _, k = w.shape
    return np.ascontiguousarray(w.reshape(d, d * k).T), b.reshape(d * k)


@pytest.mark.parametrize("k,k_chunk", [(8, 8), (6, 4), (5, 2), (1, 8)])
def test_fused_log_likelihood_matches_jax(k, k_chunk):
    a = _args(0, k=k)
    want = jgmm.fused_log_likelihood(*(jnp.asarray(a[n]) for n in NAMES), rng=None,
                                     k_chunk=k_chunk)
    got = gmm.fused_log_likelihood(*(_t(a[n]) for n in NAMES), k_chunk=k_chunk)
    assert got.shape == (2, 5, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_log_likelihood_dense_matches_jax_and_fused():
    a = _args(1)
    r = np.random.default_rng(2)
    logits = r.standard_normal((2, 5, 6)).astype(np.float32)
    sigma = (0.5 + r.random((2, 5, 32, 6))).astype(np.float32)
    mu = r.standard_normal((2, 5, 32, 6)).astype(np.float32)
    want = jgmm.log_likelihood_dense(jnp.asarray(a["x"]), jnp.asarray(logits),
                                     jnp.asarray(sigma), jnp.asarray(mu))
    got = gmm.log_likelihood_dense(_t(a["x"]), _t(logits), _t(sigma), _t(mu))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the fused form equals the dense form of its own mu/sigma heads
    xt = _t(a["x"])
    pre = torch.einsum("bpd,dek->bpek", xt, _t(a["w_sigma"])) + _t(a["b_sigma"])
    mu_h = torch.einsum("bpd,dek->bpek", xt, _t(a["w_mu"])) + _t(a["b_mu"])
    logits_h = torch.einsum("bpd,dk->bpk", xt, _t(a["w_pi"])) + _t(a["b_pi"])
    dense = gmm.log_likelihood_dense(xt, logits_h, gmm.sigma_from_pre(pre), mu_h)
    fused = gmm.fused_log_likelihood(*(_t(a[n]) for n in NAMES), k_chunk=4)
    np.testing.assert_allclose(fused.numpy(), dense.numpy(), rtol=RTOL, atol=ATOL)


def test_bf16_operands_match_pallas_interpret():
    """matmul_dtype=bf16 rounds x and the weights for the products only
    (f32 accumulation, f32 x - mu): the arithmetic of the Pallas kernel with
    bf16 weight blocks, run in interpret mode. Both sum exact bf16 products
    in f32, in other orders."""
    a = _args(3, b=2, p=8, d=32, k=5)
    logits = np.random.default_rng(4).standard_normal((2, 8, 5)).astype(np.float32)
    log_pi = np.log(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True) + 1e-15)
    log_pi = log_pi.astype(np.float32)
    k_major = lambda w: jnp.moveaxis(jnp.asarray(w), -1, 0)
    want = gmm_log_likelihood_pallas(
        jnp.asarray(a["x"]), jnp.asarray(log_pi), k_major(a["w_sigma"]), k_major(a["b_sigma"]),
        k_major(a["w_mu"]), k_major(a["b_mu"]), interpret=True, matmul_dtype=jnp.bfloat16)
    ws, bs = _linear(a["w_sigma"], a["b_sigma"])
    wm, bm = _linear(a["w_mu"], a["b_mu"])
    args = (_t(a["x"]), _t(log_pi), _t(ws), _t(bs), _t(wm), _t(bm))
    got = cgmm.gmm_log_likelihood(*args, matmul_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    f32 = cgmm.gmm_log_likelihood(*args, matmul_dtype=torch.float32)
    assert np.abs(f32.numpy() - got.numpy()).max() > 1e-3  # the rounding is real


def test_gradients_match_jax_grad():
    """Autograd of the port's checkpointed K-chunk loop (the plain version
    of B3/B4) vs jax.grad of the JAX scan, w.r.t. x and all six heads."""
    a = _args(5, k=6)
    c = np.random.default_rng(6).standard_normal((2, 5, 32)).astype(np.float32)

    def jloss(*args):
        return jnp.sum(jgmm.fused_log_likelihood(*args, rng=None, k_chunk=4) * c)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*(jnp.asarray(a[n]) for n in NAMES))
    ts = [_t(a[n], grad=True) for n in NAMES]
    (gmm.fused_log_likelihood(*ts, k_chunk=4) * _t(c)).sum().backward()
    for name, t, w in zip(NAMES, ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(), err_msg=name)


def test_gradients_match_pallas_train_interpret():
    """The wrapper's CPU path in the Linear layout vs the Pallas training
    kernels (`gmm_log_likelihood_train`, interpret mode) at a tiny shape:
    d x, d log_pi and the weight and bias gradients."""
    r = np.random.default_rng(7)
    b, p, d, k = 2, 5, 16, 3
    x = r.standard_normal((b, p, d)).astype(np.float32)
    logits = r.standard_normal((b, p, k)).astype(np.float32)
    log_pi = np.log(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True) + 1e-15)
    log_pi = log_pi.astype(np.float32)
    w_s, w_m = (0.2 * r.standard_normal((d, d, k))).astype(np.float32), \
        (0.2 * r.standard_normal((d, d, k))).astype(np.float32)
    b_s, b_m = (0.1 * r.standard_normal((d, k))).astype(np.float32), \
        (0.1 * r.standard_normal((d, k))).astype(np.float32)
    c = r.standard_normal((b, p, d)).astype(np.float32)

    def jloss(*args):
        return jnp.sum(gmm_log_likelihood_train(*args, interpret=True) * c)

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(v) for v in (x, log_pi, w_s, b_s, w_m, b_m)))
    ws, bs = _linear(w_s, b_s)
    wm, bm = _linear(w_m, b_m)
    ts = [_t(v, grad=True) for v in (x, log_pi, ws, bs, wm, bm)]
    (cgmm.gmm_log_likelihood(*ts) * _t(c)).sum().backward()
    got = [ts[0].grad.numpy(), ts[1].grad.numpy()]
    for i in (2, 4):  # Linear-layout weight / bias gradients → JAX layout
        got.append(ts[i].grad.numpy().T.reshape(d, d, k))
        got.append(ts[i + 1].grad.numpy().reshape(d, k))
    for name, g, w in zip(("x", "log_pi", "w_sigma", "b_sigma", "w_mu", "b_mu"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=name)


def test_gumbel_noise():
    """Seeded Gumbel noise: the same seed gives the same draw, another seed
    another; weights stay finite, sum to 1 and, for equal logits, each of
    two components wins half the time (a logistic difference of two Gumbels).
    The JAX and torch streams differ, so parity tests run noiseless."""
    logits = torch.zeros(20000, 2)
    draw = lambda seed: gmm.mixture_log_weights(logits, torch.Generator().manual_seed(seed))
    lw = draw(0)
    assert torch.isfinite(lw).all()
    assert torch.equal(lw, draw(0)) and not torch.equal(lw, draw(1))
    w = torch.exp(lw)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    assert abs(w[:, 0].mean().item() - 0.5) < 0.01
    assert abs((w[:, 0] > 0.5).float().mean().item() - 0.5) < 0.02
    noiseless = gmm.mixture_log_weights(logits)
    np.testing.assert_allclose(noiseless.numpy(), np.log(0.5 + 1e-15), atol=1e-7)


def test_loss_and_probability_map_match_jax():
    ll = np.random.default_rng(8).standard_normal((3, 7, 4)).astype(np.float32)
    np.testing.assert_allclose(gmm.mdn_loss_from_log_likelihood(_t(ll)).item(),
                               float(jgmm.mdn_loss_from_log_likelihood(jnp.asarray(ll))),
                               rtol=1e-6)
    np.testing.assert_allclose(gmm.probability_map(_t(ll)).numpy(),
                               np.asarray(jgmm.probability_map(jnp.asarray(ll))), atol=1e-7)


@pytest.mark.parametrize("d,dtype,err,match", [
    (48, torch.float32, ValueError, "multiple of 64"),
    (64, torch.float16, TypeError, "bf16 or f32"),
])
def test_kernel_wrapper_refuses_what_the_kernels_do_not_take(d, dtype, err, match):
    k = 2
    x, lp = torch.zeros(1, 3, d), torch.zeros(1, 3, k)
    w, b = torch.zeros(d * k, d), torch.zeros(d * k)
    with pytest.raises(err, match=match):
        cgmm.check_kernel_shape(x, lp, w, b, w, b, dtype)
    with pytest.raises(RuntimeError, match="no path"):
        cgmm.gmm_log_likelihood(x.to("meta"), lp.to("meta"), w.to("meta"), b.to("meta"),
                                w.to("meta"), b.to("meta"))


@pytest.mark.parametrize("rows,dtype,chunk", [
    (392, torch.bfloat16, 150),     # the kernel check's rows: one chunk
    (3136, torch.bfloat16, 111),    # a train step at batch 16: two chunks
    (3136, torch.float32, 55),      # three chunks
    (12544, torch.bfloat16, 27),    # batch 64: six chunks
])
def test_backward_chunk_keeps_the_scratch_under_its_bound(rows, dtype, chunk):
    kc = cgmm.backward_chunk(rows, 768, 150, dtype)
    assert kc == chunk
    assert 2 * kc * rows * 768 * dtype.itemsize <= cgmm.SCRATCH_BYTES


def test_component_major_staging_matches_the_jax_layout():
    """B2 reads the biases [K, D] and log_pi [K, rows] component-major:
    entry [k, e] of the staged bias is entry [e, k] of the JAX layout
    (`linear_to_jax_layout`), entry [k, r] of the staged log_pi is log_pi[r, k];
    the weights stay in the Linear layout, in the matmul type."""
    r = np.random.default_rng(9)
    d, k, rows = 64, 3, 5
    w = [torch.from_numpy(r.standard_normal((d * k, d)).astype(np.float32)) for _ in range(2)]
    b = [torch.from_numpy(r.standard_normal(d * k).astype(np.float32)) for _ in range(2)]
    ops = cgmm.kernel_operands(w[0], b[0], w[1], b[1], torch.bfloat16)
    for name, wt, bt in (("sigma", w[0], b[0]), ("mu", w[1], b[1])):
        _, jax_b = cgmm.linear_to_jax_layout(wt, bt, k)
        staged = ops[f"b_{name}_t"]
        assert staged.shape == (k, d) and staged.dtype == torch.float32
        assert staged.is_contiguous()
        assert torch.equal(staged, jax_b.t())
        for kk, e in ((0, 0), (2, 5), (1, d - 1)):
            assert staged[kk, e] == bt[e * k + kk]
        assert ops[f"w_{name}"].dtype == torch.bfloat16
        assert torch.equal(ops[f"w_{name}"], wt.to(torch.bfloat16))
    log_pi = torch.from_numpy(r.standard_normal((rows, k)).astype(np.float32))
    staged = cgmm.component_major(log_pi)
    assert staged.shape == (k, rows) and staged.is_contiguous()
    assert torch.equal(staged, log_pi.t())
    # f32 matmuls: the weights are the parameters themselves
    f32 = cgmm.kernel_operands(w[0], b[0], w[1], b[1], torch.float32)
    assert f32["w_sigma"].data_ptr() == w[0].data_ptr()


@pytest.mark.parametrize("d", [64, 128, 192, 768, 1024, 1088, 2048, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_route_covers_every_width_the_entry_takes(d, dtype):
    """Every feature width the C entry takes (a multiple of 64) has a route:
    the FMA kernel under f32, under bf16 the wgmma kernel with the block's x
    rows resident in shared memory up to D = 1024 and streamed above."""
    route = cgmm.forward_route(d, dtype)
    if dtype == torch.float32:
        assert route == "fma"
    else:
        assert route == ("wgmma_x_resident" if d <= cgmm.RESIDENT_X_MAX_D
                         else "wgmma_x_streamed")


@pytest.mark.parametrize("d,dtype,err", [
    (48, torch.bfloat16, ValueError), (0, torch.bfloat16, ValueError),
    (100, torch.float32, ValueError), (768, torch.float16, TypeError),
])
def test_forward_route_refuses_what_the_kernel_shape_check_refuses(d, dtype, err):
    with pytest.raises(err):
        cgmm.forward_route(d, dtype)
    k = 2
    x, lp = torch.zeros(1, 3, d), torch.zeros(1, 3, k)
    w, b = torch.zeros(d * k, d), torch.zeros(d * k)
    with pytest.raises(err):
        cgmm.check_kernel_shape(x, lp, w, b, w, b, dtype)


def test_cpu_path_ignores_prepared_operands():
    """The plain version reads the heads it is given; staged kernel operands
    (a frozen head's cache) change nothing on the CPU."""
    a = _args(10, k=3)
    ws, bs = _linear(a["w_sigma"], a["b_sigma"])
    wm, bm = _linear(a["w_mu"], a["b_mu"])
    lp = np.log(np.full((2, 5, 3), 1 / 3, dtype=np.float32))
    args = (_t(a["x"]), _t(lp), _t(ws), _t(bs), _t(wm), _t(bm))
    ops = cgmm.kernel_operands(*args[2:], torch.bfloat16)
    got = cgmm.gmm_log_likelihood(*args, matmul_dtype=torch.bfloat16, operands=ops)
    want = cgmm.gmm_log_likelihood(*args, matmul_dtype=torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", [64, 128, 192, 768, 1024, 1088, 2048, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_routes_cover_every_width_the_entries_take(d, dtype):
    """Every width the backward's C entries take has a route for each: under
    bf16 the terms kernel on B2's block (x resident up to D = 1024, streamed
    above) and the wgmma GEMMs for the weight gradients and dx; under f32 the
    FMA kernels."""
    routes = cgmm.backward_routes(d, dtype)
    assert set(routes) == {"terms", "weights", "x"}
    assert routes["terms"] == cgmm.forward_route(d, dtype)
    gemm = "fma" if dtype == torch.float32 else "wgmma"
    assert routes["weights"] == routes["x"] == gemm


@pytest.mark.parametrize("d,dtype,err", [
    (48, torch.bfloat16, ValueError), (0, torch.bfloat16, ValueError),
    (100, torch.float32, ValueError), (768, torch.float16, TypeError),
])
def test_backward_routes_refuse_what_the_kernel_shape_check_refuses(d, dtype, err):
    with pytest.raises(err):
        cgmm.backward_routes(d, dtype)


def test_route_codes_match_the_c_entries():
    """The codes the wrapper reads back are the ones gmm.cu writes, and every
    GMM entry point takes the route out-parameter last."""
    import ctypes
    import re

    from vit_ad_tpu_torch.ops.cuda import build

    src = (build.CSRC_DIR / "gmm.cu").read_text()
    codes = dict(re.findall(r"kRoute(\w+) = (\d)", src))
    names = {"WgmmaResident": "wgmma_x_resident", "Fma": "fma",
             "WgmmaStreamed": "wgmma_x_streamed", "Wgmma": "wgmma"}
    assert {int(v): names[k] for k, v in codes.items()} == cgmm._ROUTES
    for entry in ("gmm_forward", "gmm_backward_terms", "gmm_backward_weights",
                  "gmm_backward_x"):
        assert build.ENTRY_POINTS[entry][-1] is ctypes.POINTER(ctypes.c_int)


@pytest.mark.parametrize("rows,d,kc,sms,splits", [
    (784, 2048, 100, 132, 7),   # ResNet stage 3: 56 tiles, 0.42 of one wave alone
    (3136, 1024, 83, 132, 5),   # stage 2, first chunk: 100 tiles
    (3136, 1024, 17, 132, 5),   # its second chunk
    (12544, 768, 27, 132, 4),   # DeiT at B=64: 294 tiles, the third wave 0.23 full
    (784, 2048, 2, 132, 2),     # never more ranges than components
    (16896, 256, 14, 132, 1),   # 132 tiles, one whole wave: no split
    (1, 64, 20, 132, 8),        # one tile: nor more than MAX_DX_SPLITS
])
def test_dx_splits_fill_the_card(rows, d, kc, sms, splits):
    got = cgmm.dx_splits(rows, d, kc, sms)
    assert got == splits
    assert 1 <= got <= min(kc, cgmm.MAX_DX_SPLITS)
    tiles = -(-rows // cgmm.DX_TILE_ROWS) * -(-d // cgmm.DX_TILE_COLS)
    fill = lambda s: tiles * s / (-(-tiles * s // sms) * sms)
    assert fill(got) >= fill(1)


@pytest.mark.parametrize("need_x", [True, False])
@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_backward_decomposition_matches_pallas_train_interpret(dtype, jdtype, need_x):
    """The kernels' decomposition of the backward (`backward_decomposition`:
    terms per chunk of components into a scratch rounded to the matmul type,
    bias partials per 64-row tile, d log_pi partials per 64-feature group,
    weight gradients from the scratch, dx in split partials summed in order
    across chunks, the wrapper's reductions) vs jax.grad of the Pallas
    training kernels in interpret mode, with the same operand rounding: 70
    rows (a ragged 64-row tile), two 64-feature groups, K = 5 in chunks of 2
    (three chunks, k0 > 0, the dx carry), dx split in two on a card of 4 SMs.
    Tolerance GRAD_RTOL of each gradient's largest entry: both sum the same
    rounded products in f32 in other orders."""
    r = np.random.default_rng(11)
    b, p, d, k = 2, 35, 128, 5
    f = lambda *s, sc=1.0: (sc * r.standard_normal(s)).astype(np.float32)
    x, logits = f(b, p, d), f(b, p, k)
    lp = np.log(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True) + 1e-15)
    lp = lp.astype(np.float32)
    w_s, w_m = f(d, d, k, sc=0.1), f(d, d, k, sc=0.1)
    b_s, b_m = f(d, k, sc=0.1), f(d, k, sc=0.1)
    c = f(b, p, d)
    assert cgmm.dx_splits(b * p, d, 2, 4) == 2

    def jloss(*args):
        return jnp.sum(gmm_log_likelihood_train(*args, interpret=True, matmul_dtype=jdtype) * c)

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(v) for v in (x, lp, w_s, b_s, w_m, b_m)))
    ws, bs = _linear(w_s, b_s)
    wm, bm = _linear(w_m, b_m)
    args = [_t(v) for v in (x, lp, ws, bs, wm, bm)]
    ll = cgmm.gmm_log_likelihood_reference(*args, matmul_dtype=dtype)
    got = cgmm.backward_decomposition(*args, _t(c), ll, dtype, need_x=need_x, chunk=2, sms=4)
    assert (got[0] is None) == (not need_x)
    names = ("x", "log_pi", "w_sigma", "b_sigma", "w_mu", "b_mu")
    for name, g, w in zip(names, got, want):
        if g is None:
            continue
        g = g.numpy()
        if name.startswith("w_"):
            g = g.T.reshape(d, d, k)
        elif name.startswith("b_"):
            g = g.reshape(d, k)
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=name)
