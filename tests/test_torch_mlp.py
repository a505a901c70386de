"""Port fused MLP half-block (`vit_ad_tpu_torch/ops/mlp.py`, `ops/cuda/mlp.py`)
against the JAX package's `ops/pallas/mlp.py`: the Pallas kernel
`mlp_block_pallas` run in interpret mode, as tests/test_pallas_mlp.py runs it,
and the custom VJP of `mlp_block`; and `ViTEncoder(fused_mlp=True)` against the
unfused encoder and the JAX encoder.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA kernel
itself is checked against that plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vit import jitter
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.models.vit import ViTEncoder as JaxViTEncoder
from vit_ad_tpu.ops.pallas.mlp import mlp_block as jax_mlp_block
from vit_ad_tpu.ops.pallas.mlp import mlp_block_pallas
from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models.vit import FUSED_MLP_DEFAULT, ViTEncoder
from vit_ad_tpu_torch.ops import mlp as mops
from vit_ad_tpu_torch.ops.cuda import mlp as cmlp
from vit_ad_tpu_torch.utils.convert import vit_state_dict_from_jax

# Tolerances (max abs difference; outputs are of magnitude ~3):
# f32: the same math, f32 sums in other orders (JAX at "highest" matmul
#   precision, tests/conftest.py) and another tanh.
# bf16: both round the LayerNorm output, the GELU output and the result to
#   bf16 from f32 sums taken in other orders; a flipped rounding of the result
#   is one bf16 ulp (2^-6 at 2..4).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [  # (B, N, D, H, dtype): rows ragged (24, 3) and exact (32) for row_tile=16
    (2, 12, 16, 64, "float32"), (1, 3, 8, 32, "float32"), (2, 16, 16, 64, "float32"),
    (2, 12, 16, 64, "bfloat16"), (2, 16, 128, 512, "bfloat16"),
]


def _inputs(b, n, d, h, seed=0):
    """(x, norm scale, norm bias, W1 [D, H], b1, W2 [H, D], b2) as numpy, the
    JAX layouts and the scales of tests/test_pallas_mlp.py."""
    rng = np.random.default_rng(seed)
    f = lambda a: a.astype(np.float32)
    return (f(rng.normal(size=(b, n, d))), f(rng.uniform(0.5, 1.5, size=(d,))),
            f(rng.normal(size=(d,)) * 0.1), f(rng.normal(size=(d, h)) * 0.05),
            f(rng.normal(size=(h,)) * 0.1), f(rng.normal(size=(h, d)) * 0.05),
            f(rng.normal(size=(d,)) * 0.1))


def _port_args(x, ns, nb, w1, b1, w2, b2, dtype=torch.float32):
    """The same inputs for the port: activations and weights in `dtype`,
    weights transposed to the nn.Linear layouts."""
    t = torch.from_numpy
    return [t(x).to(dtype), t(ns), t(nb), t(w1.T.copy()).to(dtype), t(b1),
            t(w2.T.copy()).to(dtype), t(b2)]


@pytest.mark.parametrize("b,n,d,h,dt", CASES)
def test_plain_version_matches_jax_kernel(b, n, d, h, dt):
    x, ns, nb, w1, b1, w2, b2 = _inputs(b, n, d, h)
    jdt = getattr(jnp, dt)
    want = mlp_block_pallas(jnp.asarray(x, jdt), jnp.asarray(ns), jnp.asarray(nb),
                            jnp.asarray(w1, jdt), jnp.asarray(b1), jnp.asarray(w2, jdt),
                            jnp.asarray(b2), row_tile=16, interpret=True)
    got = mops.mlp_block_reference(*_port_args(x, ns, nb, w1, b1, w2, b2, getattr(torch, dt)))
    assert got.dtype == getattr(torch, dt) and got.shape == (b, n, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=TOL[dt])


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    args = _port_args(*_inputs(2, 5, 128, 256, seed=1))
    before = cmlp.launches
    out = cmlp.mlp_block(*args)
    assert cmlp.launches == before
    torch.testing.assert_close(out, mops.mlp_block_reference(*args), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="no path"):
        cmlp.mlp_block(*[a.to("meta") for a in args])


def test_backward_matches_jax_custom_vjp():
    """Gradients of every input against `jax.grad` of `mlp_block`, whose
    custom VJP recomputes through its XLA expression as the port's recomputes
    through the plain version (f32, where the two expressions round alike)."""
    np_args = _inputs(2, 4, 8, 16, seed=2)
    want = jax.grad(lambda *a: jax_mlp_block(*a).sum(), argnums=tuple(range(7)))(
        *map(jnp.asarray, np_args))
    args = [a.requires_grad_(True) for a in _port_args(*np_args)]
    got = torch.autograd.grad(cmlp.mlp_block(*args).sum(), args)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).T if i in (3, 5) else np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=f"input {i}")


@pytest.mark.parametrize("d,hidden,want", [
    (768, 3072, True), (384, 1536, True), (128, 512, True), (1024, 4096, True),
    (96, 384, False), (768, 3000, False), (32, 128, False), (1152, 4608, False),
    (0, 0, False),
])
def test_gate_truth_table(d, hidden, want):
    assert cmlp.use_fused_mlp(d, hidden) is want


@pytest.mark.parametrize("d,hidden,dtype,want", [
    (768, 3072, torch.bfloat16, "wgmma"), (384, 1536, torch.bfloat16, "wgmma"),
    (128, 512, torch.bfloat16, "wgmma"), (1024, 4096, torch.bfloat16, "wgmma"),
    (768, 3072, torch.float32, "fma"), (1024, 4096, torch.float32, "fma"),
    (128, 128, torch.float32, "fma"),
    (96, 384, torch.bfloat16, ""), (768, 3000, torch.bfloat16, ""),
    (1152, 4608, torch.bfloat16, ""), (768, 3072, torch.float16, ""),
    (768, 3072, torch.float64, ""), (0, 0, torch.float32, ""),
])
def test_route_truth_table(d, hidden, dtype, want):
    """Which kernels a CUDA tensor would take: every bf16 width the gate admits
    goes to the LayerNorm + wgmma products, f32 to the fused FMA kernel; the
    wrapper raises exactly where the route is empty."""
    assert cmlp.mlp_route(d, hidden, dtype) == want
    assert bool(want) == (cmlp.use_fused_mlp(d, hidden) and dtype in (torch.bfloat16,
                                                                      torch.float32))
    if d > 0:
        z = lambda *s: torch.zeros(*s)
        args = [torch.zeros(3, d, dtype=dtype), z(d), z(d), torch.zeros(hidden, d, dtype=dtype),
                z(hidden), torch.zeros(d, hidden, dtype=dtype), z(d)]
        if want:
            assert cmlp.check_kernel_shape(*args) == (d, hidden)
        else:
            with pytest.raises((TypeError, ValueError)):
                cmlp.check_kernel_shape(*args)


@pytest.mark.parametrize("rows", [5, 128, 129])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_three_steps_compose_to_the_plain_version(rows, dt):
    """The contract the bf16 route's three kernels are built to: k0 is the
    LayerNorm kernel's function at eps 1e-6 (its plain version, rounded to the
    dtype), k1 rounds gelu_tanh(y.W1^T + b1) once, k2 rounds
    f32(x) + (hidden.W2^T + b2) once; composed, they are `mlp_block_reference`
    bit for bit, in f32 and in bf16."""
    from vit_ad_tpu_torch.ops.cuda.layer_norm import layer_norm_reference

    dtype = getattr(torch, dt)
    x, nw, nb, w1, b1, w2, b2 = _port_args(*_inputs(1, rows, 128, 256, seed=3), dtype)
    x = x[0]
    y = layer_norm_reference(x, nw, nb, 1e-6)
    assert y.dtype == dtype
    # the LayerNorm step inside the plain version is the same expression
    xf = x.float()
    centred = xf - xf.mean(dim=-1, keepdim=True)
    var = centred.square().mean(dim=-1, keepdim=True)
    inside = ((centred * torch.rsqrt(var + 1e-6)) * nw + nb).to(dtype)
    assert torch.equal(y, inside)
    hidden = mops.gelu_tanh(y.float() @ w1.float().t() + b1).to(dtype)
    out = (x.float() + (hidden.float() @ w2.float().t() + b2)).to(dtype)
    want = mops.mlp_block_reference(x, nw, nb, w1, b1, w2, b2, 1e-6)
    assert torch.equal(out, want)
    assert torch.equal(cmlp.mlp_block(x, nw, nb, w1, b1, w2, b2, 1e-6), want)


def test_route_counter_reads_the_entry_points_report():
    """`wgmma_launches` counts what `mlp_block_forward` reports through its
    `route` out-parameter, not what `mlp_route` predicts: the wrapper's names
    for the reported codes are those of the C source, and the entry point's last
    argument is that out-parameter."""
    import ctypes
    import re

    from vit_ad_tpu_torch.ops.cuda import build

    src = (build.CSRC_DIR / "mlp_block.cu").read_text()
    codes = dict(re.findall(r"kRoute(\w+) = (\d)", src))
    assert {int(v): k.lower() for k, v in codes.items()} == cmlp.ROUTE_NAMES
    assert build.ENTRY_POINTS["mlp_block_forward"][-1] is ctypes.POINTER(ctypes.c_int)
    assert src.count("*route = kRoute") == 2


def test_gemm_step_is_a_card_side_entry():
    """`gemm_step` (one product of the bf16 route alone, for the card-side
    checks) takes bf16 CUDA matrices only and counts no launch."""
    a, w = torch.zeros(4, 128, dtype=torch.bfloat16), torch.zeros(256, 128, dtype=torch.bfloat16)
    before = cmlp.launches, cmlp.wgmma_launches
    with pytest.raises(ValueError, match="bf16 CUDA matrices"):
        cmlp.gemm_step(a, w, torch.zeros(256), cmlp.EPILOGUE_GELU)
    assert (cmlp.launches, cmlp.wgmma_launches) == before


@pytest.mark.parametrize("shape,w1_shape,dtype,err,match", [
    ((4, 96), (384, 96), torch.float32, ValueError, "multiples of 128"),
    ((4, 128), (500, 128), torch.float32, ValueError, "multiples of 128"),
    ((4, 128), (512, 128), torch.float16, TypeError, "bf16 or f32"),
    ((0, 128), (512, 128), torch.float32, ValueError, "at least one row"),
])
def test_kernel_shape_check_raises_on_unsupported(shape, w1_shape, dtype, err, match):
    d, h = shape[-1], w1_shape[0]
    z = lambda *s: torch.zeros(*s)
    with pytest.raises(err, match=match):
        cmlp.check_kernel_shape(torch.zeros(shape, dtype=dtype), z(d), z(d),
                                torch.zeros(w1_shape, dtype=dtype), z(h),
                                torch.zeros(d, h, dtype=dtype), z(d))
    ok = [torch.zeros(2, 198, 768, dtype=torch.bfloat16), z(768), z(768),
          torch.zeros(3072, 768, dtype=torch.bfloat16), z(3072),
          torch.zeros(768, 3072, dtype=torch.bfloat16), z(768)]
    assert cmlp.check_kernel_shape(*ok) == (768, 3072)
    with pytest.raises(TypeError, match="x's dtype"):
        cmlp.check_kernel_shape(ok[0], ok[1], ok[2], ok[3].float(), *ok[4:])
    with pytest.raises(ValueError, match="nn.Linear layouts"):
        cmlp.check_kernel_shape(ok[0], ok[1], ok[2], ok[3].t(), *ok[4:])


# a width the gate admits: D=128 (hidden 512), two blocks, 16 patches of 8 px
WIDE = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=4, num_prefix_tokens=2)


@pytest.fixture(scope="module")
def wide_params():
    enc = JaxViTEncoder(**WIDE, dtypes=JaxDtypePolicy.f32())
    params = jax.jit(enc.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))  # jitted: faster
    return jitter(params, np.random.default_rng(6), 0.05)


def _encoder(params, dtypes, **kw):
    enc = ViTEncoder(**WIDE, dtypes=dtypes, **kw)
    enc.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    return enc


def test_fused_encoder_matches_unfused_and_jax_bf16(wide_params, monkeypatch):
    """Under the bf16 policy (tanh GELU) the fused encoder goes through
    `mlp_block` once per block; it differs from the unfused one only by where
    the MLP tail rounds (hidden activations and residual in f32 instead of
    bf16), so both lie within the bf16 drift of the JAX encoder."""
    x = np.random.default_rng(7).standard_normal((2, 32, 32, 3)).astype(np.float32)
    calls = []
    real = cmlp.mlp_block
    monkeypatch.setattr("vit_ad_tpu_torch.models.vit.mlp_block",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    assert FUSED_MLP_DEFAULT is True
    assert _encoder(wide_params, DtypePolicy()).fused_mlp
    encoders = [_encoder(wide_params, DtypePolicy(), fused_mlp=False),
                _encoder(wide_params, DtypePolicy(), fused_mlp=True)]
    with torch.inference_mode():
        unfused = encoders[0](torch.from_numpy(x)).patch_embedding
        assert calls == []
        fused = encoders[1](torch.from_numpy(x)).patch_embedding
    assert calls == [(2, 18, 128)] * 2 and fused.dtype == torch.bfloat16
    want = JaxViTEncoder(**WIDE, dtypes=JaxDtypePolicy()).apply(wide_params, jnp.asarray(x))
    want = np.asarray(want.patch_embedding.astype(jnp.float32))
    np.testing.assert_allclose(fused.float().numpy(), unfused.float().numpy(), rtol=0, atol=0.1)
    np.testing.assert_allclose(fused.float().numpy(), want, rtol=0, atol=0.1)


@pytest.mark.parametrize("kw,dtypes,n_calls", [
    (dict(fused_mlp=True), DtypePolicy.f32(), 0),                   # erf GELU: gate off
    (dict(fused_mlp=True, gelu_tanh=True), DtypePolicy.f32(), 2),   # tanh forced: f32 kernel path
    (dict(fused_mlp=False), DtypePolicy(), 0),
], ids=["f32_erf", "f32_tanh", "flag_off"])
def test_fused_path_is_taken_only_under_tanh_gelu(wide_params, monkeypatch, kw, dtypes, n_calls):
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 32, 32, 3))
                         .astype(np.float32))
    calls = []
    real = cmlp.mlp_block
    monkeypatch.setattr("vit_ad_tpu_torch.models.vit.mlp_block",
                        lambda *a: calls.append(1) or real(*a))
    stock_kw = {**kw, "fused_mlp": False}  # the stock tail, whatever the default
    encoders = [_encoder(wide_params, dtypes, **kw), _encoder(wide_params, dtypes, **stock_kw)]
    with torch.inference_mode():
        got = encoders[0](x).patch_embedding
        assert len(calls) == n_calls
        want = encoders[1](x).patch_embedding
    assert len(calls) == n_calls
    # in f32 the fused and the stock tail are the same math
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=0,
                               atol=1e-5 if dtypes == DtypePolicy.f32() else 0)


def test_narrow_encoder_ignores_the_flag(monkeypatch):
    """D=32 fails the gate: `fused_mlp=True` takes the stock tail."""
    monkeypatch.setattr("vit_ad_tpu_torch.models.vit.mlp_block",
                        lambda *a: pytest.fail("mlp_block called at D=32"))
    enc = ViTEncoder(img_size=32, patch_size=8, embed_dim=32, depth=1, num_heads=4,
                     fused_mlp=True)
    assert enc.fused_mlp
    with torch.inference_mode():
        out = enc(torch.zeros(1, 32, 32, 3)).patch_embedding
    assert out.shape == (1, 16, 32)
