"""Port k-means MDN init (`vit_ad_tpu_torch/pipeline/cluster_init.py`)
against the JAX package: the centres of one seeded input equal the JAX
function's bit for bit, through sklearn and through the numpy Lloyd
fallback; the seeded mu bias is the JAX `b_mu = centers.T` in the port's
e*K + k layout; `train_mdn(kmeans_init=True)` seeds its head from the cached
training features before the optimizer is built (tiny DeiT of
tests/test_torch_vit.py, 32 px)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_score import _tiny_port_encoder
from test_torch_vit import IMG
from vit_ad_tpu.models.mdn import GaussianMDN as JaxMDN
from vit_ad_tpu.pipeline import cluster_init as jax_cluster_init
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.data import synthetic
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.pipeline import cluster_init, train
from vit_ad_tpu_torch.utils.convert import mdn_state_dict_from_jax


def _features(seed=0, n=40, p=9, d=6):
    """Three separated blobs in d dimensions, as [n, p, d] patch tokens."""
    rng = np.random.default_rng(seed)
    modes = 4.0 * rng.standard_normal((3, d))
    pick = rng.integers(0, 3, n * p)
    return (modes[pick] + 0.3 * rng.standard_normal((n * p, d))).reshape(n, p, d).astype(
        np.float32)


@pytest.mark.parametrize("max_samples", [100_000, 200], ids=["all_rows", "subsampled"])
@pytest.mark.parametrize("backend", ["sklearn", "lloyd"])
def test_centers_equal_jax_bit_for_bit(backend, max_samples, monkeypatch):
    """The same rows, the same seed 42, the same library: equal centres.
    "lloyd" hides sklearn (an ImportError), so both packages take their numpy
    Lloyd fallback; "subsampled" draws 200 of the 360 rows first."""
    if backend == "lloyd":
        monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    feats = _features()
    want = jax_cluster_init.kmeans_cluster_centers(feats, 3, max_samples=max_samples)
    got = cluster_init.kmeans_cluster_centers(feats, 3, max_samples=max_samples)
    assert got.dtype == np.float32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)
    assert cluster_init.KMEANS_SEED == jax_cluster_init.KMEANS_SEED == 42


def test_seeded_mu_bias_is_the_jax_layout():
    """K != D and distinct centres: the port's bias must be
    `centers.T.reshape(-1)`, the converted JAX `b_mu`; `centers.reshape(-1)`
    has the same length and would fail here."""
    d, k = 5, 3
    centers = np.arange(k * d, dtype=np.float32).reshape(k, d) / 7.0
    jmdn = JaxMDN(features=d, num_gaussians=k)
    params = jax.jit(jmdn.init)(jax.random.key(0), jnp.zeros((1, 1, d)))
    want = mdn_state_dict_from_jax(jax_cluster_init.seed_mdn_mu_bias(params, centers))
    mdn = GaussianMDN(d, k, dtypes=DtypePolicy.f32(),
                      generator=torch.Generator().manual_seed(0))
    before = {n: t.clone() for n, t in mdn.state_dict().items()}
    assert cluster_init.seed_mdn_mu_bias(mdn, centers) is mdn
    got = mdn.state_dict()
    np.testing.assert_array_equal(got["mu.bias"].numpy(), want["mu.bias"].numpy())
    np.testing.assert_array_equal(got["mu.bias"].numpy(), centers.T.reshape(-1))
    assert not np.array_equal(got["mu.bias"].numpy(), centers.reshape(-1))
    assert all(torch.equal(got[n], before[n]) for n in got if n != "mu.bias")
    with pytest.raises(ValueError, match="centers"):
        cluster_init.seed_mdn_mu_bias(mdn, centers.T)


def test_train_mdn_seeds_the_head_before_the_first_step(tmp_path, monkeypatch):
    """`train_mdn(kmeans_init=True)`: the mu bias the optimizer is built
    over is the JAX function's centres of the cached training features,
    transposed; then training moves it."""
    cat = synthetic.make_mvtec_category(str(tmp_path), "widget", img_size=IMG, n_train=10,
                                        n_test_good=2, n_test_defect=2)
    k = 3
    hp = HyperParams(model_name="enc_deit", architecture="mdn", epochs=2, patience=2,
                     batch_size=4, img_size=IMG, num_gaussians=k, kmeans_init=True,
                     dtypes=DtypePolicy.f32())
    encoder = _tiny_port_encoder(generator=torch.Generator().manual_seed(3))
    seen = {}
    real_kmeans, real_adam = cluster_init.kmeans_cluster_centers, train.torch_adam

    def kmeans(features, num_clusters, max_samples=100_000):
        seen["features"] = np.array(features)
        seen["centers"] = real_kmeans(features, num_clusters, max_samples)
        return seen["centers"]

    def adam(params, lr, wd=0.0):
        params = list(params)
        seen["bias_at_adam"] = [p.detach().clone() for p in params]
        return real_adam(params, lr, wd)

    monkeypatch.setattr(cluster_init, "kmeans_cluster_centers", kmeans)
    monkeypatch.setattr(train, "torch_adam", adam)
    data = DataPipeline(4, IMG, base_path=cat, data_path="train/good")
    result = train.train_mdn(hp, data, None, encoder=encoder, device="cpu")

    n_train = len(data.train_files)
    assert seen["features"].shape == (n_train, encoder.num_patches, encoder.embed_dim)
    np.testing.assert_array_equal(
        seen["centers"], jax_cluster_init.kmeans_cluster_centers(seen["features"], k))
    mu_bias = dict(zip([n for n, _ in result.head.named_parameters()],
                       seen["bias_at_adam"]))["mu.bias"]
    np.testing.assert_array_equal(mu_bias.numpy(), seen["centers"].T.reshape(-1))
    assert not torch.equal(result.head.mu.bias.detach(), mu_bias)  # trained
    assert result.epochs_ran == 2 and np.isfinite(result.history["train_loss"]).all()
