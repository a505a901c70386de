"""The port's recon trainer on a transformer AE against the JAX package:
`train_recon` with the latent cache on the narrow DeiT trunk and the small
decoder (against the JAX `train_recon` from its own init), and one
`recon_train_step` of the ResNetDecoder on cached latents against the JAX
step of `train_recon` (`loss_fn` :536 and the torch-semantics Adam). f32.
Split from tests/test_torch_recon_train.py so that the two files run in
parallel."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from test_torch_recon_models import RTOL_DEEP
from test_torch_recon_train import (  # with its fixtures `category` and `_pil_decode`
    F32,
    JF32,
    LOSS_RTOL,
    _jax_trainer_init,
    _pil_decode,
    _run_both,
    category,
)
from test_torch_vit import IMG, jax_encoder, port_encoder
from vit_ad_tpu.data.loader import preprocess as jax_preprocess
from vit_ad_tpu.models import autoencoder as jae
from vit_ad_tpu.pipeline.optimizers import torch_adam as jax_torch_adam
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.models import autoencoder as pae
from vit_ad_tpu_torch.models.vit import ViTEncoder
from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
from vit_ad_tpu_torch.pipeline.train import cache_latents, recon_train_step
from vit_ad_tpu_torch.utils.convert import recon_state_dict_from_jax


def test_train_recon_latent_cache_matches_jax(category, monkeypatch):
    """A DeiT AE (the narrow trunk, the small decoder on its cls token):
    the trunk runs once per batch before training (the latent cache), each
    step the decoder alone; the trunk's weights do not move."""
    calls = []
    real = ViTEncoder.forward
    monkeypatch.setattr(ViTEncoder, "forward",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    jm_make = lambda: jae.TransformerAutoEncoder(encoder=jax_encoder(2, JF32), decoder_kind="cnn",
                                                 img_size=IMG, dtypes=JF32)
    _, _, got, _ = _run_both(category, jm_make,
                             lambda: pae.TransformerAutoEncoder(port_encoder(2), "cnn", IMG, F32),
                             8, 4, 1e-3)
    # 2 train + 1 valid batches cached, then 1 test batch scored
    assert len(calls) == 2 + 1 + 1
    trunk_before = recon_state_dict_from_jax(_jax_trainer_init(jm_make(), 24))
    for k, v in got.head.state_dict().items():
        if k.startswith("encoder."):
            assert torch.equal(v, trunk_before[k]), k


def test_recon_train_step_resnet_decoder_matches_jax():
    """One step of the ResNetDecoder at 32 px on the narrow DeiT trunk's
    cached latents, 14 images padded to 16 (the padded rows repeat the last
    image, as the pipelines pad, and take part in the BatchNorm statistics):
    the trunk's latents, the masked MSE, the gradients of the output end
    (`de_conv1`, `bn1`), the running statistics the step leaves, and that the
    loss falls after the Adam step. Deeper gradients are held block by block
    (tests/test_torch_recon_models.py::test_reverse_bottleneck_matches_jax):
    through the whole chain in training mode they are ill-conditioned, a
    1e-6 relative change of the latents moving the port's own trunk
    gradients by 1e-2 to 5e-2 of their largest entries (measured), so two
    implementations agree there only to that. Nor are the stepped losses
    compared: Adam's first step moves every weight by ~lr whatever its
    gradient's size."""
    lr, wd, b, n = 1e-4, 1e-4, 16, 14
    jm = jae.TransformerAutoEncoder(encoder=jax_encoder(2, JF32), decoder_kind="resnet",
                                    img_size=IMG, dtypes=JF32)
    k = jax.random.split(jax.random.key(24))[1]
    v = jax.jit(lambda key: jm.init(key, jnp.zeros((1, IMG, IMG, 3)), train=True))(k)
    v = jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})
    images = np.random.default_rng(7).integers(0, 256, (b, IMG, IMG, 3), dtype=np.uint8)
    images[n:] = images[n - 1]
    valid = np.array([1.0] * n + [0.0] * (b - n), np.float32)
    mean, std = default_norm_stats()
    x = jax_preprocess(jnp.asarray(images), jnp.asarray(mean), jnp.asarray(std))
    z = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False).latent)(v, x)

    def loss_fn(dec, stats):
        recon, upd = jm.apply({"params": {**v["params"], "decoder": dec}, "batch_stats": stats},
                              z, train=True, mutable=["batch_stats"],
                              method=lambda m, zz, train: m.decoder(zz, train=train))
        err = jnp.mean(jnp.square(recon - x), axis=(1, 2, 3))
        return jnp.sum(err * valid) / jnp.maximum(jnp.sum(valid), 1.0), upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"]["decoder"], v["batch_stats"])
    as_port = lambda dec, st: recon_state_dict_from_jax(
        {"params": {**v["params"], "decoder": jax.tree.map(np.asarray, dec)},
         "batch_stats": jax.tree.map(np.asarray, st)})
    want_grads, want_stats = as_port(grads, v["batch_stats"]), as_port(v["params"]["decoder"],
                                                                       stats)

    ae = pae.TransformerAutoEncoder(port_encoder(2), "resnet", IMG, F32)
    ae.load_state_dict(recon_state_dict_from_jax(v), strict=True)
    ae.eval()
    mean_t, std_t = (torch.as_tensor(a) for a in (mean, std))
    batch = (torch.from_numpy(images), torch.from_numpy(valid), float(n))
    (latents,) = cache_latents(ae, [batch], mean_t, std_t)
    close = lambda got, want, rtol, what: np.testing.assert_allclose(
        got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)
    close(latents.numpy(), np.asarray(z), 1e-5, "latents")
    ae.train()
    opt = torch_adam(ae.decoder.parameters(), lr, wd)
    got = recon_train_step(ae, opt, batch[0], batch[1], latents, mean_t, std_t)
    np.testing.assert_allclose(got.item(), float(loss), rtol=LOSS_RTOL)
    params = dict(ae.named_parameters())
    for key in ("decoder.bn1.weight", "decoder.bn1.bias", "decoder.de_conv1.weight"):
        close(params[key].grad.numpy(), want_grads[key].numpy(), RTOL_DEEP, f"grad {key}")
    own = ae.state_dict()
    for key, want in want_stats.items():
        if "running_" in key:
            close(own[key].numpy(), want.numpy(), RTOL_DEEP, key)
    after = recon_train_step(ae, opt, batch[0], batch[1], latents, mean_t, std_t)
    assert after.item() < got.item()
