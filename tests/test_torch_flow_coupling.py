"""F1, the flow's coupling tail in one launch (`ops/cuda/flow.py`,
`csrc/flow_coupling.cu`), and the flow's state carried as its two halves
(`models/flow.py`).

On the CPU: the wrapper's plain path and the halves-carried forward against
the step as it was written before the kernel (`old_step`, kept here as the
reference), to the bit; the halves-carried forward against the JAX flow; the
shape check; the backward by recomputation. Those marked `card` need a CUDA
card and skip without one: on the card, run them with

    python -m pytest --noconftest tests/test_torch_flow_coupling.py -m card -q

(`--noconftest`: the suite's conftest imports JAX, which the card's host does
not have; this module imports JAX only inside its JAX comparison)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vit_ad_tpu_torch.models.flow import AllInOneBlock, NormalizingFlow
from vit_ad_tpu_torch.ops.cuda import flow as cflow

ULP = 2.0 ** -23


def old_step(blk: AllInOneBlock, x: torch.Tensor, p) -> tuple:
    """`AllInOneBlock.step` as it was before F1: whole maps, cat, gather."""
    h, w = x.shape[2], x.shape[3]
    x1, x2 = x[:, : blk.split1], x[:, blk.split1:]
    pad = p[0].shape[-1] // 2
    a = F.conv2d(F.relu(F.conv2d(x1, p[0], p[1], padding=pad)), p[2], p[3],
                 padding=pad) * 0.1
    s = blk.clamp * 0.636 * torch.atan(a[:, : blk.split2])
    x2 = x2 * torch.exp(s) + a[:, blk.split2:]
    logdet = s.sum(dim=(1, 2, 3))
    scale = 0.2 * torch.logaddexp(torch.zeros_like(p[4]), 0.5 * p[4])
    y = torch.cat([x1, x2], dim=1) * scale + p[5]
    logdet = logdet + h * w * torch.log(scale).sum()
    return y.index_select(1, blk.perm), logdet


def jittered(module: torch.nn.Module, seed: int, conv_gain: float = 3.0) -> torch.nn.Module:
    """Seeded noise on every parameter: global scales spread around their
    init (scales ~0.4 to ~2.5), offsets ~0.3, conv weights scaled up so the
    soft clamp's atan works off its linear range."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.named_parameters():
            noise = torch.randn(t.shape, generator=gen)
            if name.endswith("global_scale"):
                t.add_(2.0 * noise)
            elif name.endswith("global_offset"):
                t.copy_(0.3 * noise)
            elif name.endswith("weight"):
                t.mul_(conv_gain)
            else:
                t.copy_(0.1 * noise)
    return module


def block(c: int, kernel: int, seed: int, device="cpu") -> AllInOneBlock:
    perm = np.random.default_rng(seed).permutation(c)
    hidden = max(1, int((c - c // 2) * 0.16))
    blk = AllInOneBlock(c, hidden, kernel, perm, generator=torch.Generator().manual_seed(seed))
    return jittered(blk, seed).to(device)


def features(*shape, seed: int, device="cpu") -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=gen).to(device)


def subnet(x1: torch.Tensor, p, bias: bool = True) -> tuple:
    """The subnet's hidden activation and its second convolution's output,
    with or without that convolution's bias."""
    pad = p[0].shape[-1] // 2
    hidden = F.relu(F.conv2d(x1, p[0], p[1], padding=pad))
    return hidden, F.conv2d(hidden, p[2], p[3] if bias else None, padding=pad)


# (C, side, kernel): both kernels, even and odd C, plane lengths 16 and 9
STEP_CASES = [(32, 4, 3), (32, 4, 1), (31, 4, 3), (31, 3, 1), (33, 3, 3)]


@pytest.mark.parametrize("c,side,kernel", STEP_CASES)
def test_plain_path_equals_the_old_step_to_the_bit(c, side, kernel):
    blk = block(c, kernel, seed=c + kernel)
    x = features(3, c, side, side, seed=side)
    p = blk.step_params()
    with torch.no_grad():
        want, want_ld = old_step(blk, x, p)
        got, got_ld = blk.step(x, p)
        y1, y2, ld = blk.step_halves(x[:, : blk.split1].contiguous(), x[:, blk.split1:], p)
    assert torch.equal(got, want) and torch.equal(got_ld, want_ld)
    assert torch.equal(y1, want[:, : blk.split1]) and torch.equal(y2, want[:, blk.split1:])
    assert torch.equal(ld, want_ld)


@pytest.mark.parametrize("c,side", [(32, 4), (31, 4), (31, 3)])
def test_halves_carried_forward_equals_whole_steps(c, side):
    flow = jittered(NormalizingFlow(c, 16, side * side, hidden_ratio=0.16, flow_steps=4,
                                    generator=torch.Generator().manual_seed(c)), seed=side)
    x = features(2, side, side, c, seed=c)
    with torch.no_grad():
        z, logdet = flow._transform_nchw(x)
        want = x.permute(0, 3, 1, 2).contiguous()
        want_ld = torch.zeros(2)
        for blk in flow.steps:
            want, ld = old_step(blk, want, blk.step_params())
            want_ld = want_ld + ld
        out = flow(x)
    assert z.is_contiguous() and torch.equal(z, want) and torch.equal(logdet, want_ld)
    zz = want * want
    assert torch.equal(out.loss, torch.mean(0.5 * zz.sum(dim=(1, 2, 3)) - want_ld))


@pytest.mark.parametrize("c", [32, 31])
def test_halves_carried_forward_matches_jax(c):
    import jax
    import jax.numpy as jnp
    from test_torch_flow import ATOL, IMG, RATIO, RTOL_LOGDET, SIDE
    from test_torch_vit import jitter
    from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
    from vit_ad_tpu.models.flow import NormalizingFlow as JaxFlow
    from vit_ad_tpu_torch.utils.convert import nf_state_dict_from_jax

    jf = JaxFlow(num_channels=c, img_size=IMG, num_patches=SIDE * SIDE, hidden_ratio=RATIO,
                 flow_steps=4, dtypes=JaxDtypePolicy.f32())
    x = np.random.default_rng(c).standard_normal((2, SIDE, SIDE, c)).astype(np.float32)
    params = jax.jit(jf.init)(jax.random.key(c), jnp.zeros((1, SIDE, SIDE, c)))
    params = jitter(params, np.random.default_rng(c), 0.1)
    z_want, ld_want = jax.jit(lambda p, v: jf.apply(p, v, method=JaxFlow.transform))(
        params, jnp.asarray(x))
    flow = NormalizingFlow(c, IMG, SIDE * SIDE, hidden_ratio=RATIO, flow_steps=4)
    flow.load_state_dict(nf_state_dict_from_jax(params, SIDE * SIDE), strict=True)
    with torch.no_grad():
        z, ld = flow.transform(torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_want), rtol=RTOL_LOGDET)


def _kernel_inputs(c=6, side=4, b=2):
    c1, c2 = c - c // 2, c // 2
    return dict(x1=torch.zeros(b, c1, side, side), x2=torch.zeros(b, c2, side, side),
                a=torch.zeros(b, 2 * c2, side, side), bias=torch.zeros(2 * c2),
                g=torch.zeros(1, c, 1, 1), o=torch.zeros(1, c, 1, 1), perm=torch.arange(c))


@pytest.mark.parametrize("change,error", [
    ({"x1": torch.zeros(2, 3, 4, 4, dtype=torch.float64)}, TypeError),
    ({"a": torch.zeros(2, 6, 4, 4, dtype=torch.bfloat16)}, TypeError),
    ({"g": torch.zeros(1, 6, 1, 1, dtype=torch.float16)}, TypeError),
    ({"bias": torch.zeros(6, dtype=torch.float64)}, TypeError),
    ({"perm": torch.arange(6, dtype=torch.int32)}, TypeError),
    ({"x2": torch.zeros(2, 3, 4, 5)}, ValueError),   # halves of other maps
    ({"x2": torch.zeros(3, 3, 4, 4)}, ValueError),   # halves of other batches
    ({"a": torch.zeros(2, 5, 4, 4)}, ValueError),    # not 2 c2 channels
    ({"x1": torch.zeros(2, 3, 16)}, ValueError),     # not a map
    ({"perm": torch.arange(5)}, ValueError),         # a perm of the wrong length
    ({"o": torch.zeros(1, 7, 1, 1)}, ValueError),
    ({"bias": torch.zeros(5)}, ValueError),          # not the bias of 2 c2 channels
])
def test_shape_check_refuses(change, error):
    args = {**_kernel_inputs(), **change}
    with pytest.raises(error):
        cflow.check_kernel_shape(*args.values())


def test_shape_check_takes_the_flow_halves():
    assert cflow.check_kernel_shape(*_kernel_inputs(c=7, side=3).values()) == (2, 4, 3, 9)


def test_fake_states_the_plain_outputs():
    import vit_ad_tpu_torch.ops.cuda.library  # noqa: F401  (registers every op)
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _kernel_inputs(c=7, side=3)
    want = cflow.flow_coupling_reference(*args.values(), 1.272)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in args.values()]
        got = torch.ops.vit_ad_tpu_torch.flow_coupling(*fake, 1.272)
        with pytest.raises(ValueError):
            torch.ops.vit_ad_tpu_torch.flow_coupling(*fake[:-1], fake[-1][:5], 1.272)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    assert all(t.dtype == torch.float32 for t in got)


def test_planes_keeps_a_channel_slice_and_copies_a_transpose():
    z = torch.zeros(2, 7, 3, 4)
    assert cflow._planes(z[:, 3:]).data_ptr() == z[:, 3:].data_ptr()
    t = torch.zeros(2, 3, 4, 7).permute(0, 3, 1, 2)
    assert cflow._planes(t).is_contiguous()


def test_backward_by_recomputation_equals_autograd_of_the_plain_version():
    blk = block(31, 3, seed=5)
    x = features(2, 31, 4, 4, seed=6)
    x1, x2 = x[:, : blk.split1], x[:, blk.split1:]
    p = blk.step_params()
    a = subnet(x1, p, bias=False)[1].detach()
    g_out = [features(*s, seed=i) for i, s in enumerate([x1.shape, x2.shape, (2,)])]
    ins = [t.detach().clone().requires_grad_(True) for t in (x1, x2, a, p[3], p[4], p[5])]
    outs = cflow._FlowCoupling.apply(*ins, blk.perm, blk.clamp * 0.636)
    got = torch.autograd.grad(outs, ins, g_out)
    ref = [t.detach().clone().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(cflow.flow_coupling_reference(*ref, blk.perm, 1.272), ref, g_out)
    for gg, ww in zip(got, want):
        assert torch.equal(gg, ww)


# ---- on the card --------------------------------------------------------------------


@pytest.fixture
def card():
    """The CUDA device with the port's numerics policy; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    from vit_ad_tpu_torch.config import set_numerics_policy

    set_numerics_policy()
    return torch.device("cuda", 0)


def plain_transform(flow: NormalizingFlow, x: torch.Tensor):
    """The halves-carried forward with the plain tail on whatever device."""
    split = flow.steps[0].split1
    z1 = x[..., :split].permute(0, 3, 1, 2).contiguous()
    z2 = x[..., split:].permute(0, 3, 1, 2).contiguous()
    logdet = torch.zeros(x.shape[0], device=x.device)
    for blk in flow.steps:
        p = blk.step_params()
        z1 = z1.contiguous()
        z1, z2, ld = cflow.flow_coupling_reference(z1, z2, subnet(z1, p)[1], None, p[4], p[5],
                                                   blk.perm, blk.clamp * 0.636)
        logdet = logdet + ld
    return torch.cat([z1, z2], dim=1), logdet


def assert_tail_close(got, want, s_abs_sum):
    """y within a few f32 ulps of the map's largest value; logdet within 1e-5
    of the magnitude it sums."""
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=4 * ULP, atol=8 * ULP * w.abs().max().item())
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5 * s_abs_sum)


# (B, C, H, W, kernel): DeiT-base's map both kernels, EsViT's 7x7 (scalar
# loads), a ResNet stage-0 map, odd C on vector and scalar planes
CARD_CASES = [(128, 768, 14, 14, 3), (128, 768, 14, 14, 1), (32, 768, 7, 7, 3),
              (8, 256, 56, 56, 3), (4, 31, 14, 14, 3), (4, 31, 7, 7, 1)]


@pytest.mark.card
@pytest.mark.parametrize("b,c,h,w,kernel", CARD_CASES)
def test_kernel_matches_the_plain_tail(b, c, h, w, kernel, card):
    blk = block(c, kernel, seed=c, device=card)
    x = features(b, c, h, w, seed=b, device=card)
    x1, x2 = x[:, : blk.split1].contiguous(), x[:, blk.split1:].contiguous()
    p = blk.step_params()
    with torch.no_grad():
        hidden, a = subnet(x1, p)
        before = cflow.launches
        got = cflow.flow_coupling(x1, x2, hidden, *p[2:], blk.perm, blk.clamp * 0.636)
        want = cflow.flow_coupling_reference(x1, x2, a, None, p[4], p[5], blk.perm,
                                             blk.clamp * 0.636)
        s = blk.clamp * 0.636 * torch.atan(a[:, : blk.split2] * 0.1)
        scale = cflow.affine_scale(p[4])
        s_abs = (s.abs().sum(dim=(1, 2, 3)) + h * w * torch.log(scale).abs().sum()).max().item()
    torch.cuda.synchronize()
    assert cflow.launches == before + 1
    assert cflow.flow_coupling_route(h * w, x1, x2, a, *got[:2]) == (
        "vector" if (h * w) % 4 == 0 else "scalar")
    assert_tail_close(got, want, s_abs)


@pytest.mark.card
def test_logdet_repeats_to_the_bit(card):
    blk = block(768, 3, seed=1, device=card)
    x = features(128, 768, 14, 14, seed=2, device=card)
    x1, x2 = x[:, :384], x[:, 384:]
    p = blk.step_params()
    with torch.no_grad():
        hidden = subnet(x1.contiguous(), p)[0]
        first, second = (cflow.flow_coupling(x1, x2, hidden, *p[2:], blk.perm, 1.272)
                         for _ in range(2))
    for u, v in zip(first, second):
        assert torch.equal(u, v)


@pytest.mark.card
def test_backward_through_the_op_equals_the_plain_gradients(card):
    blk = block(31, 3, seed=3, device=card)
    x = features(4, 31, 14, 14, seed=4, device=card).requires_grad_(True)
    p = blk.step_params()
    y, ld = blk.step(x, p)
    loss = (y * y).sum() - ld.sum()
    got = torch.autograd.grad(loss, [x, *p])
    x1, x2 = x[:, : blk.split1], x[:, blk.split1:]
    ref = cflow.flow_coupling_reference(x1, x2, subnet(x1, p)[1], None, p[4], p[5], blk.perm,
                                        blk.clamp * 0.636)
    yr = torch.cat(ref[:2], dim=1)
    want = torch.autograd.grad((yr * yr).sum() - ref[2].sum(), [x, *p])
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg, ww, rtol=1e-5, atol=1e-5 * ww.abs().max().item())


# (C, side) of each NF trunk's feature map: DeiT/ViT, EsViT Swin-T, NesT-T,
# EfficientFormer-L3, EfficientNet-B4, ResNet-50 stage maps 0-2
TRUNK_MAPS = [(768, 14), (768, 7), (384, 14), (512, 7), (1792, 7), (256, 56), (512, 28),
              (1024, 14)]


@pytest.mark.card
@pytest.mark.parametrize("c,side", TRUNK_MAPS)
def test_each_trunks_flow_runs_through_the_kernel(c, side, card):
    steps = 4
    flow = jittered(NormalizingFlow(c, 224, side * side, hidden_ratio=0.16, flow_steps=steps,
                                    generator=torch.Generator().manual_seed(c)), seed=side,
                    conv_gain=1.0).to(card)
    x = features(8, side, side, c, seed=c, device=card)
    with torch.no_grad():
        before = cflow.launches
        z, logdet = flow._transform_nchw(x)
        launched = cflow.launches - before
        want, want_ld = plain_transform(flow, x)
    assert launched == steps
    torch.testing.assert_close(z, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    torch.testing.assert_close(logdet, want_ld, rtol=1e-5,
                               atol=1e-5 * math.sqrt(c * side * side))


@pytest.mark.card
def test_export_carries_one_op_a_step(card):
    from vit_ad_tpu_torch.serving.aot import _ops_in

    class Scores(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.flow = NormalizingFlow(768, 224, 196, hidden_ratio=0.16, flow_steps=20)

        def forward(self, x):
            return self.flow(x).anomaly_score_map

    x = features(2, 14, 14, 768, seed=0, device=card)
    with torch.no_grad():
        ep = torch.export.export(Scores().to(card), (x,), strict=False)
    assert _ops_in(ep) == ["vit_ad_tpu_torch::flow_coupling"] * 20
