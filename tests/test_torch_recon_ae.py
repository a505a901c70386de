"""The port's reconstruction auto-encoders against the JAX package: the
vanilla AE and the transformer AEs (narrow DeiT and ViT trunks, the tiny Swin
under the EsViT wrapper) in eval and in train mode, outputs and running
statistics, with the same weights carried across by
`utils/convert.recon_state_dict_from_jax`; the state-dict keys of every AE
family against the JAX exporters, whose output strict-loads; the registry's
ae_* keys. f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_recon_models import (
    RTOL,
    RTOL_CNN,
    RTOL_DEEP,
    SWIN_IMG,
    TinyEsViT,
    _apply,
    _both_modes,
    _calibrated,
    _close,
    _variables,
    _x,
    jax_resnet_decoder,
)
from test_torch_swin import port_swin
from test_torch_vit import IMG, jax_encoder, port_encoder
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.models import autoencoder as jae
from vit_ad_tpu.utils import torch_convert as tc
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.config import DtypePolicy
from vit_ad_tpu_torch.models import autoencoder as pae
from vit_ad_tpu_torch.models import decoders as pdec
from vit_ad_tpu_torch.utils.convert import recon_state_dict_from_jax

F32, JF32 = DtypePolicy.f32(), JaxDtypePolicy.f32()


def _ae_cases():
    return {
        "ae_cnn": (lambda: jae.VanillaAutoEncoder(img_size=IMG, dtypes=JF32),
                   lambda: pae.VanillaAutoEncoder(IMG, F32), tc.export_vanilla_ae),
        "deit_small": (lambda: jae.TransformerAutoEncoder(encoder=jax_encoder(2, JF32),
                                                          decoder_kind="cnn", img_size=IMG,
                                                          dtypes=JF32),
                       lambda: pae.TransformerAutoEncoder(port_encoder(2), "cnn", IMG, F32),
                       tc.export_transformer_ae),
        "vit_small": (lambda: jae.TransformerAutoEncoder(encoder=jax_encoder(1, JF32),
                                                         decoder_kind="cnn", img_size=IMG,
                                                         dtypes=JF32),
                      lambda: pae.TransformerAutoEncoder(port_encoder(1), "cnn", IMG, F32),
                      tc.export_transformer_ae),
        "esvit_small": (lambda: jae.TransformerAutoEncoder(
            encoder=TinyEsViT(), decoder_kind="cnn", img_size=SWIN_IMG, dtypes=JF32),
            lambda: pae.TransformerAutoEncoder(port_swin(SWIN_IMG), "cnn", SWIN_IMG, F32),
            tc.export_transformer_ae),
    }


@pytest.mark.parametrize("case", ["ae_cnn", "deit_small", "vit_small", "esvit_small"])
def test_autoencoder_matches_jax(case):
    """The whole AE in eval and in train mode: the vanilla AE trains its
    encoder's BatchNorms too; a transformer AE's trunk stays frozen (eval)
    whatever the mode, as the JAX module runs it. Keys equal the exporter's,
    whose output strict-loads."""
    make_jax, make_port, export = _ae_cases()[case]
    jm = make_jax()
    x = _x((2, IMG, IMG, 3))
    variables = _calibrated(jm, _variables(jm, jnp.zeros((1, IMG, IMG, 3)), seed=5, train=True),
                            x)
    ae = make_port()
    sd = recon_state_dict_from_jax(variables)
    exported = export(variables)
    assert set(sd) == set(exported) == set(ae.state_dict())
    ae.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in exported.items()},
                       strict=True)
    ae.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = ae.eval()(torch.from_numpy(x))
    want = _apply(jm, False)(variables, jnp.asarray(x))
    _close(got.latent, want.latent, what="latent")
    if case != "ae_cnn":
        _close(got.patch_embedding, want.patch_embedding, what="patch tokens")
    _both_modes(jm, variables, ae, x, torch.from_numpy(x), recon_state_dict_from_jax,
                lambda t: t, case, pick=lambda out: out.reconstruction,
                rtol=RTOL_CNN if case == "ae_cnn" else RTOL)
    if case != "ae_cnn":
        ae.train()
        assert not ae.trunk.training and ae.decoder.training
        assert not any(p.requires_grad for p in ae.encoder.parameters())


def test_transformer_ae_with_resnet_decoder_matches_jax(jax_resnet_decoder):
    """ae_deit's layout on the narrow DeiT trunk: the decoder of the shared
    JAX ResNetDecoder's variables, the trunk's own."""
    jd, dec_vars = jax_resnet_decoder
    jm = jae.TransformerAutoEncoder(encoder=jax_encoder(2, JF32), decoder_kind="resnet",
                                    img_size=IMG, dtypes=JF32)
    enc_vars = _variables(jax_encoder(2, JF32), jnp.zeros((1, IMG, IMG, 3)), seed=6)
    x = _x((16, IMG, IMG, 3))
    variables = _calibrated(jm, {
        "params": {"encoder": enc_vars["params"], "decoder": dec_vars["params"]},
        "batch_stats": {"decoder": dec_vars["batch_stats"]}}, x)
    ae = pae.TransformerAutoEncoder(port_encoder(2), "resnet", IMG, F32)
    sd = recon_state_dict_from_jax(variables)
    assert set(sd) == set(tc.export_transformer_ae(variables)) == set(ae.state_dict())
    ae.load_state_dict(sd, strict=True)
    _both_modes(jm, variables, ae, x, torch.from_numpy(x), recon_state_dict_from_jax,
                lambda t: t, "ae_deit layout", pick=lambda out: out.reconstruction,
                rtol=RTOL_DEEP)


def test_resnet_autoencoder_keys_match_the_exporter():
    """ae_res_net and ae_res_net_small: the encoder under `encoder.res_net.`
    and `encoder.norms.`, the decoder under `decoder.`; the exporter's output
    strict-loads (the ResNet-50's forward is tests/test_torch_resnet.py's)."""
    for small, key in ((False, "ae_res_net"), (True, "ae_res_net_small")):
        jm = jae.ResNetAutoEncoder(img_size=IMG, small_decoder=small, dtypes=JF32)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                                jnp.zeros((1, IMG, IMG, 3)), train=True))
        variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        with torch.device("meta"):  # keys and shapes only: no init, no data
            ae = registry.get_model(key, IMG, F32)
        sd = recon_state_dict_from_jax(variables)
        assert set(sd) == set(tc.export_resnet_ae(variables)) == set(ae.state_dict()), key
        ae.load_state_dict(sd, strict=True, assign=True)
        ae.train()
        assert not ae.encoder.training and ae.decoder.training


def test_registry_builds_every_ported_ae_key():
    """The JAX registry's ae_* semantics: ResNetDecoder on the transformer
    trunks, the small decoder for `_small` and the vanilla AE, ReverseResNet
    on the ResNet-50; the fused flags reach the trunk; the NesT and
    EfficientFormer keys build with their families. Built on the meta device:
    structure only."""
    from vit_ad_tpu_torch.models.reverse_resnet import ReverseResNet

    cases = {"ae_deit": (pdec.ResNetDecoder, "deit"), "ae_vit": (pdec.ResNetDecoder, "vit"),
             "ae_esvit": (pdec.ResNetDecoder, "esvit"),
             "ae_deit_small": (pdec.SmallDecoder, "deit"),
             "ae_vit_small": (pdec.SmallDecoder, "vit"),
             "ae_esvit_small": (pdec.SmallDecoder, "esvit"), "ae_cnn": (pdec.SmallDecoder, None),
             "ae_res_net": (ReverseResNet, None), "ae_res_net_small": (pdec.SmallDecoder, None),
             "ae_nest": (pdec.ResNetDecoder, "nest"),
             "ae_nest_small": (pdec.SmallDecoder, "nest"),
             "ae_eff_former": (pdec.ResNetDecoder, "efficientformer"),
             "ae_eff_former_small": (pdec.SmallDecoder, "efficientformer")}
    with torch.device("meta"):
        for key, (decoder, family) in cases.items():
            ae = registry.get_model(key, 224, F32)
            assert type(ae.decoder) is decoder and getattr(ae, "family", None) == family, key
        assert registry.get_model("ae_deit", fused_mlp=False).trunk.fused_mlp is False
        assert registry.get_model("ae_esvit_small", fused_ln=True).trunk.fused_ln is True
        assert registry.get_model("ae_nest", fused_ln=False).trunk.fused_ln is False
    with pytest.raises(ValueError, match="fused LayerNorm"):
        registry.get_model("ae_eff_former", fused_ln=True)
    with pytest.raises(ValueError, match="fused MLP"):
        registry.get_model("ae_cnn", fused_mlp=True)
