"""The port's window attention (`vit_ad_tpu_torch/ops/window_attention.py` and
the wrappers in `ops/cuda/window_attention.py`, on the CPU: the plain
versions) against the JAX package: the partition helpers exactly, the packed
entry against the Pallas kernel `_call_win` run in interpret mode and against
`_xla_attention_windows`, the split entry against
`window_attention_core_pallas` in interpret mode, and the gradients against
the JAX custom VJP; which kernel a CUDA tensor would take, and that the
wrapper's routes are those of the C source. Inputs are seeded numpy arrays
handed to both."""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ad_tpu.ops import window_attention as jwa
from vit_ad_tpu.ops.pallas import window_attention as jpallas
from vit_ad_tpu_torch.ops import window_attention as wa
from vit_ad_tpu_torch.ops.cuda import build
from vit_ad_tpu_torch.ops.cuda import window_attention as cwa

# f32: the same math, sums over hd and N in other orders; outputs are convex
# combinations of unit-normal v.
ATOL_F32 = 2e-6
# bf16: both sides round q*scale, the probabilities and the output to bf16
# (8-bit mantissa) at the same points, but XLA's CPU bf16 dot and torch's
# accumulate in other orders, which can flip those roundings: two bf16 ulps
# (2^-8 each) of an output of magnitude <= 2.
ATOL_BF16 = 2e-2
GEOMETRIES = [(8, 8, 4, 0), (8, 8, 4, 2), (8, 12, 4, 2), (14, 14, 7, 3), (7, 7, 7, 0)]


def _case(seed, hp, wp, window, shift, heads=2, hd=8, images=2):
    rng = np.random.default_rng(seed)
    n = window * window
    n_w = (hp // window) * (wp // window)
    qkv3 = rng.standard_normal((images * n_w, n, 3 * heads * hd)).astype(np.float32)
    table = (0.5 * rng.standard_normal(((2 * window - 1) ** 2, heads))).astype(np.float32)
    return qkv3, table, jwa.shift_attention_mask(hp, wp, window, shift)


def _jax_bias(table, window, heads):
    n = window * window
    idx = jwa.relative_position_index(window, window).reshape(-1)
    return jnp.transpose(jnp.asarray(table)[idx].reshape(n, n, heads), (2, 0, 1))


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(dtype)


@pytest.mark.parametrize("b,h,w,c,window", [(2, 8, 12, 3, 4), (1, 14, 14, 5, 7), (3, 7, 7, 2, 7)])
def test_partition_and_reverse_equal_jax(b, h, w, c, window):
    x = np.random.default_rng(0).standard_normal((b, h, w, c)).astype(np.float32)
    want = np.asarray(jwa.window_partition(jnp.asarray(x), window))
    got = wa.window_partition(torch.from_numpy(x), window)
    assert np.array_equal(got.numpy(), want)
    back = wa.window_reverse(got, window, h, w)
    assert np.array_equal(back.numpy(), x)
    assert np.array_equal(back.numpy(),
                          np.asarray(jwa.window_reverse(jnp.asarray(want), window, h, w)))


@pytest.mark.parametrize("wh,ww", [(4, 4), (7, 7), (14, 14), (2, 3)])
def test_relative_position_index_equals_jax(wh, ww):
    got = wa.relative_position_index(wh, ww)
    assert got.dtype == np.int64
    assert np.array_equal(got, jwa.relative_position_index(wh, ww))


@pytest.mark.parametrize("hp,wp,window,shift", GEOMETRIES + [(28, 28, 14, 7), (56, 56, 14, 7)])
def test_shift_attention_mask_equals_jax(hp, wp, window, shift):
    got, want = (m.shift_attention_mask(hp, wp, window, shift) for m in (wa, jwa))
    if shift == 0:
        assert got is None and want is None
    else:
        assert got.dtype == np.float32 and np.array_equal(got, want)
        assert set(np.unique(got)) <= {0.0, -100.0}


@pytest.mark.parametrize("hp,wp,window,shift", GEOMETRIES)
def test_packed_entry_matches_pallas_kernel_f32(hp, wp, window, shift):
    """`swin_attention_windows` (CPU: the plain version of B5) against the
    TPU kernel in interpret mode and against the XLA unpack + core path."""
    qkv3, table, mask = _case(1, hp, wp, window, shift)
    heads = table.shape[1]
    jmask = None if mask is None else jnp.asarray(mask)
    kernel = jpallas._call_win(jnp.asarray(qkv3), _jax_bias(table, window, heads), jmask, heads,
                               1 if mask is None else mask.shape[0], interpret=True)
    xla = jpallas._xla_attention_windows(jnp.asarray(qkv3), jnp.asarray(table), heads, window,
                                         jmask)
    got = cwa.swin_attention_windows(_t(qkv3), _t(table), heads, window, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=0, atol=ATOL_F32)
    # a pre-gathered bias takes the place of the table
    index = torch.from_numpy(wa.relative_position_index(window, window))
    again = cwa.swin_attention_windows(_t(qkv3), _t(table), heads, window, _t(mask),
                                       bias=wa.gather_bias(_t(table), index))
    assert torch.equal(again, got)


@pytest.mark.parametrize("hp,wp,window,shift", [(8, 8, 4, 2), (14, 14, 7, 0)])
def test_packed_entry_matches_pallas_kernel_bf16(hp, wp, window, shift):
    """Under bf16 the plain version rounds where `_kernel_win` rounds: the
    unnormalised exponentials before PV, the division after it."""
    qkv3, table, mask = _case(2, hp, wp, window, shift)
    heads = table.shape[1]
    jmask = None if mask is None else jnp.asarray(mask)
    want = jpallas._call_win(jnp.asarray(qkv3).astype(jnp.bfloat16),
                             _jax_bias(table, window, heads), jmask, heads,
                             1 if mask is None else mask.shape[0], interpret=True)
    got = cwa.swin_attention_windows(_t(qkv3, torch.bfloat16), _t(table), heads, window,
                                     _t(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=ATOL_BF16)


@pytest.mark.parametrize("hp,wp,window,shift", GEOMETRIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_entry_matches_pallas_kernel(hp, wp, window, shift, dtype):
    """`window_attention` (CPU: the plain version of B5a) against
    `window_attention_core_pallas` in interpret mode and the XLA core."""
    qkv3, table, mask = _case(3, hp, wp, window, shift)
    heads, hd = table.shape[1], 8
    b_, n, _ = qkv3.shape
    q, k, v = (np.ascontiguousarray(a) for a in
               np.moveaxis(qkv3.reshape(b_, n, 3, heads, hd), 2, 0))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmask = None if mask is None else jnp.asarray(mask)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    kernel = jpallas.window_attention_core_pallas(jq, jk, jv, jnp.asarray(table), heads,
                                                  (window, window), jmask, interpret=True)
    core = jwa.window_attention_core(jq, jk, jv, jnp.asarray(table), heads, (window, window),
                                     jmask)
    got = cwa.window_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(table), heads,
                               (window, window), _t(mask))
    assert got.dtype == tdt and got.shape == (b_, n, heads * hd)
    atol = ATOL_F32 if dtype == "float32" else ATOL_BF16
    for want in (kernel, core):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=atol)


def test_packed_and_split_plain_versions_round_at_different_points():
    """f32: the two plain versions agree to summation order. bf16: they are
    two roundings of the same function (unnormalised vs normalised
    probabilities), close but not equal."""
    qkv3, table, mask = _case(4, 14, 14, 7, 3)
    heads = table.shape[1]
    index = torch.from_numpy(wa.relative_position_index(7, 7))
    bias = wa.gather_bias(_t(table), index)
    for dtype, atol in ((torch.float32, ATOL_F32), (torch.bfloat16, ATOL_BF16)):
        x = _t(qkv3, dtype)
        packed = wa.window_attention_reference(x, bias, _t(mask), heads)
        q, k, v = (t.transpose(1, 2) for t in wa.split_packed(x, heads))
        split = wa.window_attention_core_reference(q, k, v, bias, _t(mask))
        torch.testing.assert_close(packed.float(), split.float(), rtol=0, atol=atol)
    assert not torch.equal(packed, split)


@pytest.mark.parametrize("shift", [0, 2])
def test_gradients_match_the_jax_custom_vjp(shift):
    """qkv and bias-table gradients of the packed entry, and q, k, v, table
    gradients of the split entry, against the JAX custom VJPs (both recompute
    through the XLA core). f32; relative to each gradient's largest entry."""
    qkv3, table, mask = _case(5, 8, 8, 4, shift)
    heads, hd = table.shape[1], 8
    g = np.random.default_rng(6).standard_normal(qkv3.shape[:2] + (heads * hd,)).astype(
        np.float32)
    jmask = None if mask is None else jnp.asarray(mask)
    want = jax.grad(lambda t, bt: jnp.sum(
        jpallas.swin_attention_windows(t, bt, heads, 4, jmask) * jnp.asarray(g)),
        argnums=(0, 1))(jnp.asarray(qkv3), jnp.asarray(table))
    x, bt = _t(qkv3).requires_grad_(True), _t(table).requires_grad_(True)
    got = torch.autograd.grad(cwa.swin_attention_windows(x, bt, heads, 4, _t(mask)), [x, bt],
                              _t(g))
    b_, n, _ = qkv3.shape
    split = [np.ascontiguousarray(a) for a in
             np.moveaxis(qkv3.reshape(b_, n, 3, heads, hd), 2, 0)]
    want += jax.grad(lambda q, k, v, t: jnp.sum(
        jpallas.window_attention(q, k, v, t, heads, (4, 4), jmask) * jnp.asarray(g)),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, split), jnp.asarray(table))
    ins = [_t(a).requires_grad_(True) for a in split + [table]]
    got += torch.autograd.grad(cwa.window_attention(*ins, heads, (4, 4), _t(mask)), ins, _t(g))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("bad", ["tokens", "bias", "mask", "heads"])
def test_wrappers_refuse_misshapen_inputs(bad):
    qkv3, table, mask = _case(7, 8, 8, 4, 2)
    x, bt, m = _t(qkv3), _t(table), _t(mask)
    with pytest.raises(ValueError):
        if bad == "tokens":
            cwa.swin_attention_windows(x[:, :15], bt, 2, 4, m)
        elif bad == "heads":
            cwa.swin_attention_windows(x, bt, 5, 4, m)
        elif bad == "bias":
            cwa._check_window_inputs(16, 2, 8, torch.float32, torch.zeros(2, 16, 15), m, 8)
        else:
            cwa._check_window_inputs(16, 2, 8, torch.float32, torch.zeros(2, 16, 16), m[:3], 8)


@pytest.mark.parametrize("n,dtype,want", [
    *[(n, torch.bfloat16, "one_pass") for n in (1, 49, 64, 196, 208)],
    *[(n, torch.bfloat16, "two_pass") for n in (209, 225, 256)],
    *[(n, torch.float32, "fma") for n in (1, 49, 196, 256)],
    (0, torch.bfloat16, ""), (257, torch.bfloat16, ""), (257, torch.float32, ""),
    (196, torch.float16, ""),
])
def test_window_attention_route_truth_table(n, dtype, want):
    """Which kernel of csrc/swin_window_attention.cu a CUDA tensor would take;
    the wrapper raises exactly where the route is empty."""
    assert cwa.window_attention_route(n, dtype) == want
    if n > 0:
        bias = torch.zeros(2, n, n)
        if want:
            cwa._check_window_inputs(n, 2, 32, dtype, bias, None, 4)
        else:
            with pytest.raises((TypeError, ValueError)):
                cwa._check_window_inputs(n, 2, 32, dtype, bias, None, 4)
    assert cwa.window_one_pass_launches == cwa.split_one_pass_launches == 0


def test_window_route_counters_read_the_entry_points_report():
    """`window_one_pass_launches` and `split_one_pass_launches` count what
    `swin_window_attention_forward` reports through its `route` out-parameter:
    the wrapper's names for the reported codes and its one-pass cap are those of
    the C source, every launching branch reports, and the entry point's last
    argument is that out-parameter."""
    src = (build.CSRC_DIR / "swin_window_attention.cu").read_text()
    codes = dict(re.findall(r"kRoute(\w+) = (\d)", src))
    assert {int(v): k for k, v in codes.items()} == {1: "OnePass", 2: "TwoPass", 3: "Fma"}
    assert cwa.ROUTE_NAMES == {1: "one_pass", 2: "two_pass", 3: "fma"}
    assert int(re.search(r"kOnePassMaxTokens = (\d+)", src).group(1)) == cwa.ONE_PASS_MAX_TOKENS
    assert build.ENTRY_POINTS["swin_window_attention_forward"][-1] is \
        ctypes.POINTER(ctypes.c_int)
    assert src.count("*route = kRoute") == 3


# The kernel's edge shapes, two windows each, hd = 32 (3 heads): N = 49 (the
# narrow one-pass form) and 196 (the wide one) under a shift mask, N = 225 (the
# two-pass form) unmasked: (map height, width, window, shift)
EDGE_GEOMETRIES = [(7, 14, 7, 3), (14, 28, 14, 7), (15, 30, 15, 0)]


@pytest.mark.parametrize("hp,wp,window,shift", EDGE_GEOMETRIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_pallas_at_the_kernel_edges(hp, wp, window, shift, dtype):
    """Both plain versions (the packed `swin_attention_windows` and the split
    `window_attention` on CPU tensors) against the TPU kernels `_call_win` and
    `window_attention_core_pallas` in interpret mode."""
    qkv3, table, mask = _case(8, hp, wp, window, shift, heads=3, hd=32, images=1)
    heads, hd = 3, 32
    b_, n, _ = qkv3.shape
    assert b_ == 2
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmask = None if mask is None else jnp.asarray(mask)
    n_w = 1 if mask is None else mask.shape[0]
    atol = ATOL_F32 if dtype == "float32" else ATOL_BF16
    want = jpallas._call_win(jnp.asarray(qkv3).astype(jdt), _jax_bias(table, window, heads),
                             jmask, heads, n_w, interpret=True)
    got = cwa.swin_attention_windows(_t(qkv3, tdt), _t(table), heads, window, _t(mask))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=atol)
    q, k, v = (np.ascontiguousarray(a) for a in
               np.moveaxis(qkv3.reshape(b_, n, 3, heads, hd), 2, 0))
    want = jpallas.window_attention_core_pallas(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), jnp.asarray(table), heads,
        (window, window), jmask, interpret=True)
    got = cwa.window_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(table), heads,
                               (window, window), _t(mask))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=atol)
