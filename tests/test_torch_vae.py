"""Port VAE (`vit_ad_tpu_torch/models/vae.py`, `pipeline/train.train_vae`,
`pipeline/eval.evaluate_vae`) against the JAX `VariationalAutoEncoder` and
`train_vae`, at 32 px with a 16-wide latent in f32, the same weights carried
across by `utils/convert.vae_state_dict_from_jax` and the ε the JAX package
drew injected. Tolerances: f32 through five conv stages, a 768-wide Dense and
the decoder, sums in other orders: 2e-5 of the largest entry of each output
(mu reaches ~14 here, where 2e-5 is ~12 f32 ulps), and never below 2e-5;
the loss of one train step to rel 1e-5, its updated BatchNorm statistics to
1e-5 of each tensor's largest entry, its gradients to 5e-5 of each tensor's
largest entry, and the posterior heads after the Adam step to 1e-6."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vit import jitter
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.data.loader import preprocess as jax_preprocess
from vit_ad_tpu.models.vae import VariationalAutoEncoder as JaxVAE
from vit_ad_tpu.pipeline import metrics as jax_metrics
from vit_ad_tpu.pipeline.optimizers import torch_adam as jax_torch_adam
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.data import synthetic
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import DataPipeline, preprocess
from vit_ad_tpu_torch.models.vae import VariationalAutoEncoder
from vit_ad_tpu_torch.pipeline.eval import make_vae_batch_fn
from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
from vit_ad_tpu_torch.pipeline.train import train_vae, vae_train_step
from vit_ad_tpu_torch.utils.convert import vae_state_dict_from_jax

IMG, LATENT, B = 32, 16, 4
ATOL = 2e-5
# train mode: at 32 px the encoder's last BatchNorm takes its statistics over
# B x 1 x 1 = 4 values a channel, as the fast variance mean(x²) - mean², whose
# cancellation amplifies the f32 order differences of the layers before it
ATOL_BATCH_STATS = 1e-4
RTOL_STEP = 1e-5
# one step's gradients (the largest error seen is 1.5e-5 of a tensor's
# largest entry), the zero-gradient threshold, and the heads' parameters
# after one Adam step at lr 1e-3 (errors seen: 5e-8)
RTOL_GRAD, ZERO_GRAD, ATOL_ADAM = 5e-5, 1e-6, 1e-6


@pytest.fixture(scope="module")
def jax_vae():
    """The JAX VAE with jittered weights and running statistics calibrated
    by two train-mode forwards on seeded images (the eval path then sees
    unit-scale maps), and uint8 images."""
    vae = JaxVAE(img_size=IMG, latent_dim=LATENT, dtypes=JaxDtypePolicy.f32())
    x0 = jnp.zeros((1, IMG, IMG, 3))
    v = jax.jit(lambda r1, r2: vae.init(r1, x0, r2, train=True))(jax.random.key(0),
                                                                  jax.random.key(1))
    params = jitter(v["params"], np.random.default_rng(2), 0.02)
    stats = v["batch_stats"]
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    mean, std = (jnp.asarray(a) for a in default_norm_stats())
    calib = jax.jit(lambda p, s, x: vae.apply({"params": p, "batch_stats": s}, x,
                                              jax.random.key(4), train=True,
                                              mutable=["batch_stats"])[1]["batch_stats"])
    for i in range(2):
        x = jax_preprocess(jnp.asarray(np.roll(images, i, axis=0)), mean, std)
        stats = calib(params, stats, x)
    variables = {"params": params,
                 "batch_stats": jax.tree.map(lambda a: np.asarray(a), stats)}
    return {"vae": vae, "variables": variables, "images": images, "mean": mean, "std": std}


def _close(got, want, atol=ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _port_vae(variables) -> VariationalAutoEncoder:
    vae = VariationalAutoEncoder(IMG, LATENT, dtypes=DtypePolicy.f32())
    vae.load_state_dict(vae_state_dict_from_jax(variables), strict=True)
    return vae.eval()


def _x(j):
    return jax_preprocess(jnp.asarray(j["images"]), j["mean"], j["std"])


def _xt(j):
    return preprocess(torch.from_numpy(j["images"]),
                      *(torch.as_tensor(np.array(a)) for a in (j["mean"], j["std"])))


def test_converted_state_dict_loads_strict(jax_vae):
    vae = VariationalAutoEncoder(IMG, LATENT, dtypes=DtypePolicy.f32())
    sd = vae_state_dict_from_jax(jax_vae["variables"])
    assert set(sd) == set(vae.state_dict())
    assert vae.flatten_size == 768 and sd["fc_mu.weight"].shape == (LATENT, 768)


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "batch_stats"])
def test_encode_and_posterior_match_jax(jax_vae, train_mode):
    """encode, and forward_with_posterior with the JAX ε: mu, log_var, z and
    the reconstruction; in train mode on the batch statistics."""
    j = jax_vae
    key = jax.random.key(5)
    mutable = ["batch_stats"] if train_mode else False
    res = jax.jit(lambda v, x: j["vae"].apply(v, x, key, train=train_mode, mutable=mutable,
                                              method=JaxVAE.forward_with_posterior))(
        j["variables"], _x(j))
    out, mu, log_var = res[0] if train_mode else res
    eps = torch.from_numpy(np.array(jax.random.normal(key, (B, LATENT))))
    vae = _port_vae(j["variables"]).train(train_mode)
    with torch.no_grad():
        got_mu, got_lv = vae.encode(_xt(j))
        got, pmu, plv = vae.forward_with_posterior(_xt(j), eps)
    for g, w in ((got_mu, mu), (got_lv, log_var), (pmu, mu), (plv, log_var),
                 (got.latent, out.latent), (got.reconstruction, out.reconstruction)):
        _close(g.numpy(), w, ATOL_BATCH_STATS if train_mode else ATOL)
    assert got.reconstruction.shape == (B, IMG, IMG, 3) and float(plv.min()) > 0


def test_kl_loss_matches_jax():
    rng = np.random.default_rng(6)
    mu, lv = (rng.standard_normal((3, LATENT)).astype(np.float32) for _ in range(2))
    want = JaxVAE.kl_loss(jnp.asarray(mu), jnp.asarray(lv))
    got = VariationalAutoEncoder.kl_loss(torch.from_numpy(mu), torch.from_numpy(lv))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert VariationalAutoEncoder.kl_loss(torch.zeros(2, 4), torch.zeros(2, 4)).item() == 0.0


def test_one_train_step_matches_jax(jax_vae):
    """The JAX `train_vae` step (masked MSE + masked per-example KL from one
    train-mode encode, torch-semantics Adam): its loss, updated running
    statistics, gradients and updated heads, against `vae_train_step` on the
    same batch with one padded row and the same ε."""
    j = jax_vae
    key = jax.random.key(7)
    valid = np.array([1, 1, 1, 0], np.float32)

    def loss_fn(params, stats, x, v):
        (out, mu, lv), upd = j["vae"].apply(
            {"params": params, "batch_stats": stats}, x, key, train=True,
            mutable=["batch_stats"], method=JaxVAE.forward_with_posterior)
        err = jnp.mean(jnp.square(out.reconstruction - x), axis=(1, 2, 3))
        kl = -0.5 * jnp.sum(1 + lv - mu ** 2 - jnp.exp(lv), axis=-1)
        n = jnp.maximum(jnp.sum(v), 1.0)
        return jnp.sum(err * v) / n + jnp.sum(kl * v) / n, upd["batch_stats"]

    tx = jax_torch_adam(1e-3, 1e-4)

    @jax.jit
    def train_step(params, stats, x, v):
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, stats, x, v)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, new_stats, grads, jax.tree.map(lambda p, u: p + u, params, updates)

    want, new_stats, grads, new_params = train_step(
        j["variables"]["params"], j["variables"]["batch_stats"], _x(j), jnp.asarray(valid))
    vae = _port_vae(j["variables"]).train()
    opt = torch_adam(vae.parameters(), 1e-3, 1e-4)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (B, LATENT))))
    mean, std = (torch.as_tensor(np.array(a)) for a in (j["mean"], j["std"]))
    got = vae_train_step(vae, opt, torch.from_numpy(j["images"]), torch.from_numpy(valid),
                         mean, std, eps=eps)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL_STEP)
    ported = vae_state_dict_from_jax({"params": j["variables"]["params"],
                                      "batch_stats": jax.tree.map(np.asarray, new_stats)})
    state = vae.state_dict()
    stats = [n for n in ported if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 10
    for n in stats:
        want_n = ported[n].numpy()
        np.testing.assert_allclose(state[n].numpy(), want_n, rtol=0,
                                   atol=RTOL_STEP * float(np.abs(want_n).max()), err_msg=n)
    # the backward: every gradient against JAX's, to RTOL_GRAD of the
    # tensor's largest entry; a conv bias ahead of a train-mode BatchNorm has
    # a zero gradient (the batch mean takes it out), so where JAX's is
    # rounding noise below ZERO_GRAD of the model's largest gradient, the
    # port's must be too
    as_np = lambda tree: jax.tree.map(np.asarray, tree)
    stats_np = as_np(new_stats)
    want_grads = vae_state_dict_from_jax({"params": as_np(grads), "batch_stats": stats_np})
    want_params = vae_state_dict_from_jax({"params": as_np(new_params),
                                           "batch_stats": stats_np})
    assert set(want_grads) == (set(dict(vae.named_parameters(remove_duplicate=False)))
                               | set(dict(vae.named_buffers(remove_duplicate=False))))
    named = dict(vae.named_parameters())
    gmax = max(float(np.abs(want_grads[n].numpy()).max()) for n in named)
    zero = 0
    for n, p in named.items():
        g = want_grads[n].numpy()
        scale = float(np.abs(g).max())
        if scale < ZERO_GRAD * gmax:
            zero += 1
            assert float(p.grad.abs().max()) < ZERO_GRAD * gmax, n
        else:
            np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=RTOL_GRAD * scale,
                                       err_msg=n)
    assert zero == 10  # the five encoder and five decoder convs' biases
    # the Adam step on the posterior heads, fed by mu and by the ε/log_var
    # path (a first Adam step is about lr·sign(g), so a conv entry of
    # near-zero gradient may step either way on either side; the gradients
    # above hold those)
    for n in ("fc_mu.weight", "fc_mu.bias", "fc_log_var.weight", "fc_log_var.bias"):
        np.testing.assert_allclose(named[n].detach().numpy(), want_params[n].numpy(), rtol=0,
                                   atol=ATOL_ADAM, err_msg=n)



def test_mean_decoding_scores_match_jax_eval_maps(jax_vae):
    """The evaluation's error maps and image scores (the reconstruction
    decoded from the posterior mean, JAX `train_vae`'s `eval_maps`)."""
    j = jax_vae
    vae_cls = JaxVAE

    @jax.jit
    def error_maps(v, images_u8):
        x = jax_preprocess(images_u8, j["mean"], j["std"])
        mu, _ = j["vae"].apply(v, x, train=False, method=vae_cls.encode)
        recon = j["vae"].apply(v, mu, train=False,
                               method=lambda m, z, train: m.decoder(z, train=train))
        return jnp.mean(jnp.square(recon - x), axis=-1)

    want = np.asarray(error_maps(j["variables"], jnp.asarray(j["images"])))
    fn = make_vae_batch_fn(_port_vae(j["variables"]),
                           *(torch.as_tensor(np.array(a)) for a in (j["mean"], j["std"])))
    with torch.no_grad():
        got = fn(torch.from_numpy(j["images"])).numpy()
    _close(got, want)
    _close(got.reshape(B, -1).max(1), want.reshape(B, -1).max(1))
    with pytest.raises(ValueError, match="eval mode"):
        make_vae_batch_fn(_port_vae(j["variables"]).train(), None, None)(
            torch.from_numpy(j["images"]))


def test_train_vae_end_to_end(tmp_path):
    """`train_vae` at 32 px: the loss falls, the best epoch's weights come
    back in eval mode, the metric keys are the JAX suite's, the figures are
    written."""
    cat = synthetic.make_mvtec_category(str(tmp_path), "cat", img_size=IMG, n_train=12,
                                        n_test_good=3, n_test_defect=3)
    hp = HyperParams(epochs=3, patience=3, learning_rate=1e-3, batch_size=6, img_size=IMG,
                     dtypes=DtypePolicy.f32())
    data = DataPipeline(6, IMG, base_path=cat, data_path="train/good")
    test = DataPipeline(6, IMG, base_path=cat, data_path="test", validation_mode=True)
    model = VariationalAutoEncoder(IMG, LATENT, dtypes=DtypePolicy.f32(),
                                   generator=torch.Generator().manual_seed(0))
    figures = tmp_path / "figures"
    r = train_vae(hp, data, test, model=model, device="cpu", figures_dir=str(figures))
    losses = r.history["train_loss"]
    assert r.epochs_ran == 3 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert r.head is model and not model.training and r.encoder is None
    want_keys = jax_metrics.calc_all_metrics(jax_metrics.EvalResult(
        image_scores=np.array([0.1, 0.9]), image_labels=np.array([0.0, 1.0]),
        pixel_scores=np.random.default_rng(0).random((2, IMG, IMG)),
        pixel_labels=np.arange(2 * IMG * IMG).reshape(2, IMG, IMG) % 2.0), 0.3).keys()
    assert set(r.metrics) == set(want_keys)
    assert sorted(os.listdir(figures)) == sorted(
        f"{n}.png" for n in ("heatmaps", "ground_truth", "overlay", "roc_curve", "pr_curve"))
