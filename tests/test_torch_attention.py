"""Port attention (`vit_ad_tpu_torch/ops/cuda/window_attention.py`) against the
JAX package's packed-qkv attention: the Pallas kernel `_call_qkv` run in
interpret mode and the XLA reference `_xla_packed_attention`.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA kernel
itself is checked against that plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ad_tpu.ops.pallas.window_attention import (
    _call_qkv,
    _xla_packed_attention,
    vit_attention_qkv as jax_vit_attention_qkv,
)
from vit_ad_tpu_torch.ops.cuda import build
from vit_ad_tpu_torch.ops.cuda import window_attention as wa

# Tolerances (max abs difference):
# f32 — the same math; sums run in other orders (JAX at "highest" matmul
#   precision, tests/conftest.py), so a few f32 ulps of unit-scale outputs.
# bf16 — both round q*scale, the probabilities and the output to bf16; a
#   probability rounded the other way moves an output by at most one bf16 ulp
#   of |v| ≤ 4 (2^-6 at 2..4), so 2^-5 leaves room for two.
TOL = {"float32": 2e-6, "bfloat16": 2.0**-5}
CASES = [  # (B, N, heads, head_dim, dtype)
    (2, 10, 3, 8, "float32"),
    (1, 198, 12, 64, "float32"),
    (2, 198, 12, 64, "bfloat16"),
    (2, 65, 4, 32, "bfloat16"),
]


def _inputs(b, n, h, hd, dt, seed=0):
    x = np.random.default_rng(seed).standard_normal((b, n, 3 * h * hd)).astype(np.float32)
    return jnp.asarray(x, dtype=getattr(jnp, dt)), torch.from_numpy(x).to(getattr(torch, dt))


@pytest.mark.parametrize("b,n,h,hd,dt", CASES)
def test_plain_version_matches_jax(b, n, h, hd, dt):
    xj, xt = _inputs(b, n, h, hd, dt)
    got = wa.vit_attention_qkv_reference(xt, h)
    assert got.dtype == xt.dtype and got.shape == (b, n, h * hd)
    got = got.float().numpy()
    pallas = np.asarray(_call_qkv(xj, h, interpret=True).astype(jnp.float32))
    xla = np.asarray(_xla_packed_attention(xj, h).astype(jnp.float32))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL[dt])
    np.testing.assert_allclose(got, xla, rtol=0, atol=TOL[dt])


@pytest.mark.parametrize("b,n,h,hd,dt", CASES[:2])
def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing(b, n, h, hd, dt):
    _, xt = _inputs(b, n, h, hd, dt, seed=1)
    before = wa.launches
    out = wa.vit_attention_qkv(xt, h)
    assert wa.launches == before
    torch.testing.assert_close(out, wa.vit_attention_qkv_reference(xt, h), rtol=0, atol=0)


def test_backward_matches_jax_custom_vjp():
    """The wrapper's backward recomputes through the plain version, as the JAX
    custom VJP recomputes through XLA (f32; same tolerance reasoning)."""
    b, n, h, hd = 2, 10, 3, 8
    xj, xt = _inputs(b, n, h, hd, "float32", seed=2)
    g = np.random.default_rng(3).standard_normal((b, n, h * hd)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jax_vit_attention_qkv(t, h), xj)
    (want,) = vjp(jnp.asarray(g))
    xt.requires_grad_(True)
    (got,) = torch.autograd.grad(wa.vit_attention_qkv(xt, h), xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,heads", [((4, 24), 2), ((1, 4, 25), 2), ((1, 4, 24), 5)])
def test_wrapper_raises_on_malformed_packed_qkv(shape, heads):
    with pytest.raises(ValueError, match="packed qkv"):
        wa.vit_attention_qkv(torch.zeros(shape), heads)


@pytest.mark.parametrize("shape,heads,dtype,err,match", [
    ((1, 8, 3 * 64), 4, torch.float32, ValueError, "head dim"),      # hd 16
    ((1, 8, 3 * 768), 6, torch.bfloat16, ValueError, "head dim"),    # hd 128
    ((1, 257, 3 * 128), 2, torch.float32, ValueError, "tokens"),
    ((1, 8, 3 * 128), 2, torch.float16, TypeError, "bf16 or f32"),
])
def test_kernel_shape_check_raises_on_unsupported(shape, heads, dtype, err, match):
    with pytest.raises(err, match=match):
        wa.check_kernel_shape(torch.zeros(shape, dtype=dtype), heads)


def test_kernel_shape_check_accepts_flagship_shapes():
    for n, c, h in ((198, 768, 12), (197, 768, 12), (196, 128, 4)):
        assert wa.check_kernel_shape(torch.zeros(1, n, 3 * c, dtype=torch.bfloat16), h) \
            == (1, n, c, c // h)


def test_wrapper_raises_on_a_device_without_a_path():
    with pytest.raises(RuntimeError, match="no path"):
        wa.vit_attention_qkv(torch.empty(1, 4, 3 * 64, device="meta"), 2)


def test_build_raises_clearly_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "_build").exists()


def test_build_is_keyed_on_the_sources():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path()
    assert [f.name for f in build.source_files()] == [
        "gmm.cu", "layer_norm.cu", "mlp_block.cu", "swin_window_attention.cu",
        "vit_attention_qkv.cu", "attention_common.cuh"]
    assert set(build.ENTRY_POINTS) >= {"vit_attention_qkv_forward", "layer_norm_forward",
                                       "swin_window_attention_forward", "mlp_block_forward"}
