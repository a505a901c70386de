"""Port NF head (`vit_ad_tpu_torch/models/flow.py`) against the JAX
`NormalizingFlow`: flow_steps 3 (one coupling pair + the odd 3x3 tail) and 4
(two pairs), hidden_ratio 0.16, the same weights carried across by
`utils/convert.nf_state_dict_from_jax` and the same seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vit import jitter
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.models.flow import NormalizingFlow as JaxFlow
from vit_ad_tpu.models.flow import default_perms as jax_default_perms
from vit_ad_tpu.utils.torch_convert import export_nf_head
from vit_ad_tpu_torch.models.flow import NormalizingFlow, default_perms, patch_tokens_to_map
from vit_ad_tpu_torch.utils.convert import nf_state_dict_from_jax

C, SIDE, IMG, RATIO = 32, 4, 16, 0.16  # hidden width int(16 * 0.16) = 2
# f32 throughout: sums in other orders. z, maps and loss are unit-scale
# (atol); logdet sums H*W*C soft-clamped log-scales (rtol).
ATOL, RTOL_LOGDET = 2e-5, 1e-5


def jax_flow(steps, perms=None):
    return JaxFlow(num_channels=C, img_size=IMG, num_patches=SIDE * SIDE,
                   hidden_ratio=RATIO, flow_steps=steps, perms=perms,
                   dtypes=JaxDtypePolicy.f32())


def port_flow(steps):
    return NormalizingFlow(C, IMG, SIDE * SIDE, hidden_ratio=RATIO, flow_steps=steps)


def jax_flow_params(steps, seed=0):
    x = jnp.zeros((1, SIDE, SIDE, C))
    params = jax.jit(jax_flow(steps).init)(jax.random.key(seed), x)  # jitted: twice as fast
    return jitter(params, np.random.default_rng(seed), 0.1)


def _features(seed=1):
    return np.random.default_rng(seed).standard_normal((2, SIDE, SIDE, C)).astype(np.float32)


@pytest.mark.parametrize("steps", [3, 4])
def test_flow_matches_jax(steps):
    params = jax_flow_params(steps)
    x = _features()
    jf = jax_flow(steps)
    z_want, ld_want = jf.apply(params, jnp.asarray(x), method=JaxFlow.transform)
    out_want = jf.apply(params, jnp.asarray(x))
    flow = port_flow(steps)
    flow.load_state_dict(nf_state_dict_from_jax(params, SIDE * SIDE), strict=True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        z, ld = flow.transform(xt)
        out = flow(xt)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_want), rtol=RTOL_LOGDET)
    np.testing.assert_allclose(out.loss.numpy(), np.asarray(out_want.loss), rtol=RTOL_LOGDET)
    assert out.anomaly_score_map.shape == (2, IMG, IMG)
    np.testing.assert_allclose(out.anomaly_score_map.numpy(),
                               np.asarray(out_want.anomaly_score_map), rtol=0, atol=ATOL)


@pytest.mark.parametrize("steps", [3, 4])
def test_inverse_round_trips_and_matches_jax(steps):
    params = jax_flow_params(steps, seed=2)
    z = _features(seed=3)
    want = jax_flow(steps).apply(params, jnp.asarray(z), method=JaxFlow.inverse)
    flow = port_flow(steps)
    flow.load_state_dict(nf_state_dict_from_jax(params, SIDE * SIDE), strict=True)
    with torch.no_grad():
        x = flow.inverse(torch.from_numpy(z))
        z_back, _ = flow.transform(x)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(z_back.numpy(), z, rtol=0, atol=ATOL)


def test_default_perms_identical_to_jax():
    for steps, c in ((20, 768), (3, C)):
        assert np.array_equal(default_perms(steps, c), jax_default_perms(steps, c))
        assert default_perms(steps, c).dtype == np.int32
    assert np.array_equal(port_flow(4).perms, jax_default_perms(4, C))


@pytest.mark.parametrize("steps", [3, 4])
def test_export_nf_head_loads_strict_and_perms_come_from_w_perm(steps):
    params = jax_flow_params(steps, seed=4)
    rng = np.random.default_rng(5)
    perms = np.stack([rng.permutation(C) for _ in range(steps)])
    exported = export_nf_head(params, SIDE * SIDE, perms)
    ours = nf_state_dict_from_jax(params, SIDE * SIDE, perms)
    assert sorted(exported) == sorted(ours)
    for k, v in exported.items():
        assert np.array_equal(v, ours[k].numpy()), k
    flow = port_flow(steps)  # built with the default perms
    flow.load_state_dict({k: torch.from_numpy(v) for k, v in exported.items()}, strict=True)
    assert np.array_equal(flow.perms, perms)
    # the loaded perms drive the forward: the JAX flow built with them agrees
    x = _features(seed=6)
    want = jax_flow(steps, perms=tuple(map(tuple, perms))).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = flow(torch.from_numpy(x))
    np.testing.assert_allclose(got.anomaly_score_map.numpy(),
                               np.asarray(want.anomaly_score_map), rtol=0, atol=ATOL)


def test_patch_tokens_to_map_and_hidden_width():
    t = torch.arange(2 * 16 * 3, dtype=torch.float32).reshape(2, 16, 3)
    m = patch_tokens_to_map(t)
    assert m.shape == (2, 4, 4, 3) and torch.equal(m[1, 2, 3], t[1, 11])
    flow = NormalizingFlow(768, 224, 196, hidden_ratio=0.16, flow_steps=2)
    assert flow.steps[0].subnet[0].out_channels == 61  # int(384 * 0.16)
    assert flow.steps[0].subnet[0].kernel_size == (3, 3)
    assert flow.steps[1].subnet[0].kernel_size == (1, 1)
    assert flow.layer_norm.weight.shape == (768, 14, 14)
