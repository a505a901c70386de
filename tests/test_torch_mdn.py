"""Port MDN head (`vit_ad_tpu_torch/models/mdn.py`) and its scoring slice
against the JAX package: `export_mdn_head` output loads with strict=True,
`mdn_state_dict_from_jax` inverts `convert_mdn_head`, the log-likelihood,
loss and probability map match the JAX `GaussianMDN`, and `score_mdn` and
`cli.score -a mdn --device cpu` give the JAX `score_mdn` image scores on the
same exported weights and images (tiny DeiT of tests/test_torch_vit.py)."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import pil_decode
from test_torch_score import _tiny_port_encoder
from test_torch_vit import D, IMG, jax_encoder, jax_params, jitter
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.config import HyperParams as JaxHyperParams
from vit_ad_tpu.data.loader import DataPipeline as JaxPipeline
from vit_ad_tpu.data.synthetic import make_mvtec_category
from vit_ad_tpu.models.mdn import GaussianMDN as JaxMDN
from vit_ad_tpu.pipeline.eval import score_mdn as jax_score_mdn
from vit_ad_tpu.utils.torch_convert import convert_mdn_head, export_mdn_head, export_vit
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.cli import score as score_cli
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.pipeline import loading
from vit_ad_tpu_torch.pipeline.eval import score_mdn
from vit_ad_tpu_torch.utils.convert import mdn_state_dict_from_jax, vit_state_dict_from_jax

K, BATCH = 4, 4
# f32 end to end: sums in other orders through the encoder and the mixture;
# scores lie in [0, 1].
ATOL = 2e-5


def jax_mdn_params(d=D, k=K, seed=0):
    mdn = JaxMDN(features=d, num_gaussians=k, dtypes=JaxDtypePolicy.f32())
    params = mdn.init(jax.random.key(seed), jnp.zeros((1, 1, d)))
    return jitter(params, np.random.default_rng(seed + 100), 0.05)


def port_mdn(params, d=D, k=K) -> GaussianMDN:
    mdn = GaussianMDN(d, k, dtypes=DtypePolicy.f32())
    mdn.load_state_dict({n: torch.from_numpy(np.ascontiguousarray(v))
                         for n, v in export_mdn_head(params).items()}, strict=True)
    return mdn


def test_export_loads_strict_and_converters_invert():
    params = jax_mdn_params()
    mdn = port_mdn(params)
    ours = mdn_state_dict_from_jax(params)
    exported = export_mdn_head(params)
    assert set(ours) == set(exported) == set(mdn.state_dict())
    for name, v in exported.items():
        assert np.array_equal(ours[name].numpy(), v), name
    back = convert_mdn_head({n: t.numpy() for n, t in mdn.state_dict().items()})
    for name, v in params["params"].items():
        assert np.array_equal(back["params"][name], np.asarray(v)), name


def test_log_likelihood_loss_and_map_match_jax():
    params = jax_mdn_params(seed=1)
    x = np.random.default_rng(2).standard_normal((2, 6, D)).astype(np.float32)
    jmdn = JaxMDN(features=D, num_gaussians=K, dtypes=JaxDtypePolicy.f32())
    xj = jnp.asarray(x)
    mdn = port_mdn(params)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        pairs = [
            (mdn.log_likelihood(xt), jmdn.apply(params, xj, method=JaxMDN.log_likelihood)),
            (mdn.loss(xt), jmdn.apply(params, xj, method=JaxMDN.loss)),
            (mdn.probability_map(xt), jmdn.apply(params, xj, method=JaxMDN.probability_map)),
        ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=1e-5)


def test_init_follows_the_jax_initializers():
    """Flax's xavier-normal (truncated at 2 std, rescaled to the xavier
    variance) on the flat weights, mu bias 0.001, other biases 0; seeded."""
    d, k = 32, 8
    a = GaussianMDN(d, k, generator=torch.Generator().manual_seed(0))
    b = GaussianMDN(d, k, generator=torch.Generator().manual_seed(0))
    for name, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[name]), name
    w = a.sigma.weight
    std = (2.0 / (d + d * k)) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.05
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-7
    assert torch.all(a.mu.bias == 0.001) and torch.all(a.sigma.bias == 0) \
        and torch.all(a.pi.bias == 0)


@pytest.fixture(scope="module")
def mdn_slice(tmp_path_factory):
    """Synthetic category, tiny JAX DeiT + MDN-4, and the JAX package's own
    MDN scores for the test folder (PIL decode)."""
    mp = pytest.MonkeyPatch()
    pil_decode(mp)
    root = tmp_path_factory.mktemp("torch_mdn")
    cat = make_mvtec_category(str(root), "widget", img_size=48, n_train=1, n_test_good=3,
                              n_test_defect=4)
    test_dir = os.path.join(cat, "test")
    files = score_cli.list_images(test_dir)
    enc_params = jax_params(2, seed=21)
    mdn_params = jax_mdn_params(seed=22)
    hp = JaxHyperParams(img_size=IMG, batch_size=BATCH, dtypes=JaxDtypePolicy.f32())
    mean, std = default_norm_stats()
    want = jax_score_mdn(jax_encoder(2, JaxDtypePolicy.f32()), enc_params,
                         JaxMDN(features=D, num_gaussians=K), mdn_params,
                         JaxPipeline(batch_size=BATCH, img_size=IMG, files=files), hp, mean, std)
    yield {"test_dir": test_dir, "files": files, "enc_params": enc_params,
           "mdn_params": mdn_params, "want": want, "mean": mean, "std": std}
    mp.undo()


def test_score_mdn_matches_jax(mdn_slice):
    r = mdn_slice
    enc = _tiny_port_encoder()
    enc.load_state_dict(vit_state_dict_from_jax(r["enc_params"]), strict=True)
    hp = HyperParams(img_size=IMG, batch_size=BATCH, dtypes=DtypePolicy.f32())
    got = score_mdn(enc.eval(), port_mdn(r["mdn_params"]).eval(),
                    DataPipeline(BATCH, IMG, files=r["files"]), hp, r["mean"], r["std"])
    want = r["want"]
    assert got.pixel_scores.shape == (len(r["files"]), IMG, IMG)
    np.testing.assert_allclose(got.image_scores, want.image_scores, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.pixel_scores, want.pixel_scores, rtol=0, atol=ATOL)
    assert np.array_equal(got.labels, want.labels) and np.array_equal(got.masks, want.masks)


def test_cli_score_mdn_matches_jax(mdn_slice, tmp_path, monkeypatch):
    r = mdn_slice
    # the CLI's models pinned to the f32 policy, as the JAX package scores MDN
    # heads on the CPU (its default bf16 policy rounds the head's products)
    monkeypatch.setitem(registry._BUILDERS, "enc_deit", _tiny_port_encoder)
    monkeypatch.setattr(loading, "GaussianMDN",
                        lambda d, k, dtypes: GaussianMDN(d, k, dtypes=DtypePolicy.f32()))
    deit = tmp_path / "deit.pth"
    head = tmp_path / f"{K}_gaussians_enc_deit_widget.pth"
    torch.save({k: torch.from_numpy(v) for k, v in export_vit(r["enc_params"]["params"]).items()},
               deit)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in export_mdn_head(r["mdn_params"]).items()}, head)
    out = tmp_path / "out"
    rc = score_cli.main(["--pth", str(head), "-a", "mdn", "-m", "enc_deit", "-E", str(deit),
                         "-d", r["test_dir"], "-b", str(BATCH), "-i", str(IMG), "-o", str(out),
                         "--device", "cpu"])
    assert rc == 0
    with open(out / "scores.csv") as f:
        rows = list(csv.reader(f))[1:]
    assert [row[0] for row in rows] == r["files"]
    np.testing.assert_allclose([float(row[1]) for row in rows], r["want"].image_scores,
                               rtol=0, atol=ATOL)


def test_kernel_operands_are_cached_while_the_head_is_frozen():
    """`GaussianMDN.kernel_operands` (the bf16 heads and component-major
    biases the GMM kernels take) is made once and reused while no gradient
    flows, made again after an in-place update of a weight, and made per call
    while gradients flow to the head (training casts per call)."""
    head = GaussianMDN(64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = head.kernel_operands()
        b = head.kernel_operands()
        assert a is b and a["w_mu"].dtype == torch.bfloat16
        assert torch.equal(a["w_mu"], head.mu.weight.to(torch.bfloat16))
        head.mu.weight.add_(1.0)
        c = head.kernel_operands()
        assert c is not a
        assert torch.equal(c["w_mu"], head.mu.weight.to(torch.bfloat16))
        assert not torch.equal(c["w_mu"], a["w_mu"])
        head.sigma.bias.mul_(2.0)
        e = head.kernel_operands()
        assert e is not c
        assert torch.equal(e["b_sigma_t"], head.sigma.bias.reshape(64, 3).t())
    d1, d2 = head.kernel_operands(), head.kernel_operands()
    assert d1 is not d2 and d1 is not e
    assert not d1["w_mu"].requires_grad
    with torch.no_grad():
        assert head.kernel_operands() is e
