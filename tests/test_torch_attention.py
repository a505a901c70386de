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
        "flow_coupling.cu", "gmm.cu", "layer_norm.cu", "mlp_block.cu",
        "swin_window_attention.cu", "vit_attention_qkv.cu", "attention_common.cuh",
        "hopper_mma.cuh", "launch_common.cuh", "layer_norm_common.cuh", "tensor_map.cuh"]
    assert set(build.ENTRY_POINTS) >= {"vit_attention_qkv_forward", "layer_norm_forward",
                                       "swin_window_attention_forward", "mlp_block_forward",
                                       "mlp_gemm_forward", "flow_coupling_forward"}


# Every edge the card-side check drives through the kernels (chip_smoke.py
# KERNEL_CASES): one token, one 16-key tile exactly and one token more, a Swin
# window's 49, 196, both sides of the one-pass kernel's cap and of the token
# limit, at both head dims. Tolerances as stated there and in the JAX tests:
# f32 1e-5 (summation order at up to 256 keys), bf16 2e-2.
EDGE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
EDGE_TOKENS = (1, 16, 17, 49, 196, 208, 255, 256)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,h", [(32, 3), (64, 2)])
@pytest.mark.parametrize("n", EDGE_TOKENS)
def test_plain_version_matches_jax_at_the_kernel_edges(n, hd, h, dt):
    xj, xt = _inputs(2, n, h, hd, dt, seed=n)
    got = wa.vit_attention_qkv_reference(xt, h).float().numpy()
    assert got.shape == (2, n, h * hd)
    want = np.asarray(jax_vit_attention_qkv(xj, h).astype(jnp.float32))
    pallas = np.asarray(_call_qkv(xj, h, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=EDGE_TOL[dt])
    np.testing.assert_allclose(got, pallas, rtol=0, atol=EDGE_TOL[dt])


@pytest.mark.parametrize("n,dtype,want", [
    (1, torch.bfloat16, "one_pass"), (16, torch.bfloat16, "one_pass"),
    (198, torch.bfloat16, "one_pass"), (208, torch.bfloat16, "one_pass"),
    (209, torch.bfloat16, "two_pass"), (256, torch.bfloat16, "two_pass"),
    (1, torch.float32, "fma"), (198, torch.float32, "fma"), (256, torch.float32, "fma"),
    (0, torch.bfloat16, ""), (257, torch.bfloat16, ""), (257, torch.float32, ""),
    (198, torch.float16, ""),
])
def test_attention_route_truth_table(n, dtype, want):
    """Which kernel of csrc/vit_attention_qkv.cu a CUDA tensor would take; the
    wrapper raises exactly where the route is empty."""
    assert wa.attention_route(n, dtype) == want
    if n > 0:
        qkv = torch.zeros(1, n, 3 * 128, dtype=dtype)
        if want:
            wa.check_kernel_shape(qkv, 2)
        else:
            with pytest.raises((TypeError, ValueError)):
                wa.check_kernel_shape(qkv, 2)
    assert wa.ONE_PASS_MAX_TOKENS == 208 and wa.one_pass_launches == 0


def test_route_counter_reads_the_entry_points_report():
    """`one_pass_launches` counts what `vit_attention_qkv_forward` reports
    through its `route` out-parameter, not what `attention_route` predicts: the
    wrapper's names for the reported codes and its one-pass cap are those of the
    C source, and the entry point's last argument is that out-parameter."""
    import ctypes
    import re

    src = (build.CSRC_DIR / "vit_attention_qkv.cu").read_text()
    codes = dict(re.findall(r"kRoute(\w+) = (\d)", src))
    assert {int(v): k for k, v in codes.items()} == {1: "OnePass", 2: "TwoPass", 3: "Fma"}
    assert wa.ROUTE_NAMES == {1: "one_pass", 2: "two_pass", 3: "fma"}
    assert int(re.search(r"kOnePassMaxTokens = (\d+)", src).group(1)) == wa.ONE_PASS_MAX_TOKENS
    assert int(re.search(r"kMaxTokens = (\d+)", (build.CSRC_DIR / "attention_common.cuh")
                         .read_text()).group(1)) == wa.MAX_TOKENS
    assert build.ENTRY_POINTS["vit_attention_qkv_forward"][-1] is ctypes.POINTER(ctypes.c_int)
    assert src.count("*route = kRoute") == 3
