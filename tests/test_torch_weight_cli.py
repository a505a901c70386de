"""Port weight CLIs (`vit_ad_tpu_torch/cli/convert_weights.py`,
`cli/export_weights.py`) and the port's `.pth` unwrapping against the JAX
package's.

  * `load_pth` unwraps an EsViT `student` container as the JAX loader does
    (the parent of this change returned its top-level keys), and refuses a
    file that pickles a non-tensor type, naming the file and the type;
  * convert: the same small upstream files (a timm DeiT with `module.` and
    `distillation_token`, an EsViT `student` container, a torchvision
    ResNet-50 and a reference-layout encoder; seeded port weights in those
    layouts) through the JAX `convert` +
    `load_encoder_params` and the port's `convert` + `-E <dir>` give the same
    tokens: f32, sums in other orders, atol 2e-5 for the transformers; the
    ResNet-50 stage maps to 1e-4 of each map's largest entry, as
    tests/test_torch_resnet.py holds them (53 convolutions);
  * export: a port run that holds a JAX run's weights (the port's seeded
    weights, carried into the JAX run by the JAX package's own converters)
    exports through both CLIs to the same file names, key sets and values,
    bit for bit: mdn, nf, mdn_resnet, nf_resnet, and the vanilla, ResNet and
    transformer auto-encoders; and the refusals with exit code 2.
"""

import argparse
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_ad_tpu.cli.convert_weights as jax_cw
import vit_ad_tpu.models.swin as jax_swin_mod
import vit_ad_tpu.models.vit as jax_vit_mod
from test_torch_score import _tiny_port_encoder
from test_torch_swin import CFG as SWIN_CFG
from test_torch_swin import port_swin
from test_torch_vit import D, DEPTH, HEADS, IMG, PATCH
from vit_ad_tpu.cli.export_weights import main as jax_export_main
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.models.flow import NormalizingFlow as JaxNormalizingFlow
from vit_ad_tpu.models.mdn import GaussianMDN as JaxMDN
from vit_ad_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from vit_ad_tpu.models.swin import EsViTEncoder as JaxEsViTEncoder
from vit_ad_tpu.models.swin import SwinTransformer as JaxSwin
from vit_ad_tpu.models.vit import ViTEncoder as JaxViTEncoder
from vit_ad_tpu.utils import checkpoint as jax_checkpoint
from vit_ad_tpu.utils import torch_convert as tc
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.cli import convert_weights, export_weights
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.models.flow import NormalizingFlow
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.models.resnet import STAGE_CHANNELS, ResNetEncoder
from vit_ad_tpu_torch.pipeline import loading
from vit_ad_tpu_torch.pipeline.train import NF_RESNET_STAGES, RESNET_MDN_STAGES, stage_flow
from vit_ad_tpu_torch.utils.checkpoint import save_params

ATOL = 2e-5
RESNET_RTOL = 1e-4
SWIN_IMG = 40
_JIT_INITS = {}


def _jit_init(monkeypatch, cls):
    """`cls.init` jitted, one compile kept per class, configuration and
    input shape for the module (op by op a flax init takes several times its
    compile); the JAX CLIs call it to build their targets."""
    real = cls.init

    def init(self, rng, x, **kw):
        key = (cls, x.shape, *(getattr(self, f, None) for f in (
            "img_size", "depth", "flow_steps", "hidden_ratio", "num_gaussians")))
        if key not in _JIT_INITS:
            _JIT_INITS[key] = jax.jit(lambda r, a: real(self, r, a))
        return _JIT_INITS[key](rng, x)

    monkeypatch.setattr(cls, "init", init)


@pytest.fixture
def fast_jax_resnet_init(monkeypatch):
    _jit_init(monkeypatch, JaxResNetEncoder)


_JAX_RESNET_F32 = JaxResNetEncoder(img_size=IMG, dtypes=JaxDtypePolicy.f32())
# compiled once for both ResNet layouts
_jax_stage_features = jax.jit(lambda v, a: _JAX_RESNET_F32.apply(
    v, a, method=JaxResNetEncoder.stage_features))


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _images(img, seed=1):
    return np.random.default_rng(seed).standard_normal((2, img, img, 3)).astype(np.float32)


# --- the repair: the EsViT `student` container ------------------------------

def test_load_pth_unwraps_the_student_container(tmp_path):
    """{'student': ..., 'teacher': ..., 'epoch': ...}, the EsViT release
    format: the port's loader returns the student's state dict (its parent
    returned the keys ['epoch', 'student', 'teacher']), and `-E` on it
    builds the trunk the bare state dict builds."""
    enc = _tiny_port_encoder(generator=torch.Generator().manual_seed(4))
    student = {f"module.{k}": v for k, v in enc.state_dict().items()}
    wrapped, bare = tmp_path / "checkpoint_best.pth", tmp_path / "bare.pth"
    torch.save({"student": student, "teacher": {k: v + 1 for k, v in student.items()},
                "epoch": 3}, wrapped)
    torch.save(student, bare)
    got = loading.load_pth(str(wrapped))
    assert sorted(got) == sorted(student)
    assert all(torch.equal(got[k], student[k]) for k in student)
    x = torch.from_numpy(_images(IMG))
    from_wrapped = loading.load_encoder_checkpoint(_tiny_port_encoder(), str(wrapped))
    from_bare = loading.load_encoder_checkpoint(_tiny_port_encoder(), str(bare))
    with torch.inference_mode():
        a, b = from_wrapped(x), from_bare(x)
    assert torch.equal(a.patch_embedding, b.patch_embedding)
    # the JAX loader unwraps the same container to the same keys
    assert sorted(tc.load_pth(str(wrapped))) == sorted(student)


def test_load_pth_refuses_a_pickled_namespace(tmp_path):
    path = tmp_path / "dino.pth"
    torch.save({"student": {"w": torch.zeros(2)}, "args": argparse.Namespace(arch="swin")},
               path)
    with pytest.raises(ValueError, match=r"dino\.pth.*argparse\.Namespace"):
        loading.load_pth(str(path))


# --- convert ----------------------------------------------------------------

def test_convert_deit_matches_jax(tmp_path, monkeypatch):
    """A timm DeiT file with a DataParallel `module.` prefix, the
    `distillation_token` name and a classifier head."""
    sd = _tiny_port_encoder(generator=torch.Generator().manual_seed(5)).state_dict()
    sd["distillation_token"] = sd.pop("dist_token")
    sd["head.weight"], sd["head.bias"] = torch.zeros(10, D), torch.zeros(10)
    src = tmp_path / "deit.pth"
    torch.save({f"module.{k}": v for k, v in sd.items()}, src)

    small = lambda img: JaxViTEncoder(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
                                      num_heads=HEADS, num_prefix_tokens=2,
                                      dtypes=JaxDtypePolicy.f32())
    monkeypatch.setattr(jax_vit_mod, "deit_base_distilled_patch16", small)
    _jit_init(monkeypatch, JaxViTEncoder)
    real_convert_vit = tc.convert_vit
    monkeypatch.setattr(tc, "convert_vit", lambda s, depth=12, num_prefix_tokens=2:
                        real_convert_vit(s, depth=DEPTH, num_prefix_tokens=2))
    path = jax_cw.convert("deit", str(src), str(tmp_path / "jax"), img_size=IMG)
    enc = small(IMG)
    x = _images(IMG)
    want = jax.jit(enc.apply)(jax_cw.load_encoder_params(path, enc, img_size=IMG),
                              jnp.asarray(x))

    monkeypatch.setitem(registry._BUILDERS, "enc_deit", _tiny_port_encoder)
    assert convert_weights.main(["--arch", "deit", "--src", str(src), "--dst",
                                 str(tmp_path / "port"), "--img-size", str(IMG)]) == 0
    assert os.listdir(tmp_path / "port") == ["encoder.pth"]
    port = loading.load_encoder_checkpoint(_tiny_port_encoder(), str(tmp_path / "port"))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.patch_embedding.numpy(), np.asarray(want.patch_embedding),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.latent.numpy(), np.asarray(want.latent), rtol=0, atol=ATOL)
    with pytest.raises(SystemExit, match="directory"):
        convert_weights.main(["--arch", "deit", "--src", str(src), "--dst", "x.pth"])


def test_convert_esvit_student_container_matches_jax(tmp_path, monkeypatch):
    """The EsViT release format: {'student': module.-prefixed Swin keys with
    a head and cached attention masks, 'teacher', 'epoch'}, bias tables at
    window 7 for a 40-px model that runs stage 1 at window 5."""
    sd = port_swin(56, generator=torch.Generator().manual_seed(7)).state_dict()
    student = {f"module.{k}": v for k, v in sd.items()}
    student["module.head.weight"], student["module.head.bias"] = torch.zeros(10, 64), \
        torch.zeros(10)
    student["module.layers.0.blocks.1.attn_mask"] = torch.zeros(4, 49, 49)
    src = tmp_path / "checkpoint_best.pth"
    torch.save({"student": student, "teacher": student, "epoch": 3}, src)

    class TinyEsvit(JaxEsViTEncoder):
        def setup(self):
            self.esvit = JaxSwin(img_size=SWIN_IMG, **SWIN_CFG, dtypes=JaxDtypePolicy.f32())

    monkeypatch.setattr(jax_swin_mod, "esvit_swin_tiny", lambda img: TinyEsvit(img_size=img))
    _jit_init(monkeypatch, TinyEsvit)
    real_convert_swin = tc.convert_swin
    monkeypatch.setattr(tc, "convert_swin", lambda s, img_size=224: real_convert_swin(
        s, img_size=SWIN_IMG, patch_size=SWIN_CFG["patch_size"], depths=SWIN_CFG["depths"],
        window=SWIN_CFG["window"]))
    path = jax_cw.convert("esvit", str(src), str(tmp_path / "jax"), img_size=SWIN_IMG)
    enc = TinyEsvit(img_size=SWIN_IMG)
    x = _images(SWIN_IMG, seed=8)
    want = jax.jit(enc.apply)(jax_cw.load_encoder_params(path, enc, img_size=SWIN_IMG),
                              jnp.asarray(x))

    monkeypatch.setitem(registry._BUILDERS, "enc_esvit",
                        lambda img_size, dtypes=None, generator=None, **kw: port_swin(img_size))
    dst = convert_weights.convert("esvit", str(src), str(tmp_path / "port"), img_size=SWIN_IMG)
    assert dst == str(tmp_path / "port" / "encoder.pth")
    port = convert_weights.load_encoder_params(str(tmp_path / "port"), port_swin(SWIN_IMG))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.patch_embedding.numpy(), np.asarray(want.patch_embedding),
                               rtol=0, atol=ATOL)


@functools.lru_cache(maxsize=1)
def _port_resnet_state(seed=6):
    """A seeded port ResNet-50 at 32 px with running statistics and stage
    norms away from their init: the reference encoder layout (made once;
    callers do not modify it)."""
    enc = ResNetEncoder(IMG, DtypePolicy.f32(), generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in enc.state_dict().items():
        if k.endswith("running_var"):
            v = torch.from_numpy((1.0 + 0.3 * rng.random(v.shape)).astype(np.float32))
        elif k.endswith("running_mean") or k.startswith("norms."):
            v = v + torch.from_numpy(0.1 * rng.standard_normal(v.shape).astype(np.float32))
        sd[k] = v
    return sd


@pytest.mark.parametrize("layout", ["torchvision", "reference"])
def test_convert_resnet_matches_jax(layout, tmp_path, fast_jax_resnet_init):
    """Both ResNet layouts: a bare torchvision ResNet-50 (the stage norms
    then keep their init) and the reference encoder (`res_net.*` with its
    stage norms)."""
    sd = dict(_port_resnet_state())
    if layout == "torchvision":
        sd = {k[len("res_net."):]: v for k, v in sd.items() if k.startswith("res_net.")}
    src = tmp_path / "resnet50.pth"
    torch.save(sd, src)
    path = jax_cw.convert("resnet50", str(src), str(tmp_path / "jax"), img_size=IMG)
    variables = jax_cw.load_encoder_params(path, _JAX_RESNET_F32, img_size=IMG)
    x = _images(IMG, seed=9)
    want = _jax_stage_features(variables, jnp.asarray(x))

    convert_weights.convert("resnet50", str(src), str(tmp_path / "port"), img_size=IMG)
    port = loading.load_encoder_checkpoint(ResNetEncoder(IMG, DtypePolicy.f32()),
                                           str(tmp_path / "port"))
    with torch.inference_mode():
        got = port.stage_features(torch.from_numpy(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=RESNET_RTOL * float(np.abs(w).max()))


# --- export -----------------------------------------------------------------

def _jax_run(path, cfg, tree):
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    jax_checkpoint.save_params(str(path), "best_params", tree)
    return str(path)


def _port_run(path, cfg, files):
    hp = HyperParams(**cfg)
    for name, sd in files.items():
        save_params(str(path), name, sd)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**hp.to_log_dict(), "checkpoints": list(files)}, f)
    return str(path)


def _exported(path):
    """{file name: state dict} of an export (a file or a directory)."""
    if os.path.isdir(path):
        return {n: torch.load(os.path.join(path, n), weights_only=True)
                for n in sorted(os.listdir(path))}
    return {"": torch.load(path, weights_only=True)}


def _assert_same_export(jax_out, port_out):
    a, b = _exported(jax_out), _exported(port_out)
    assert sorted(a) == sorted(b)
    for name in a:
        assert sorted(a[name]) == sorted(b[name]), name
        for k, v in a[name].items():
            assert v.dtype == b[name][k].dtype and torch.equal(v, b[name][k]), (name, k)


def _both_exports(tmp_path, cfg, jax_tree, port_files, dst_dir=False):
    jax_run = _jax_run(tmp_path / "jax_run", cfg, jax_tree)
    port_run = _port_run(tmp_path / "port_run", cfg, port_files)
    suffix = "" if dst_dir else ".pth"
    jax_out, port_out = str(tmp_path / f"jax_out{suffix}"), str(tmp_path / f"port_out{suffix}")
    assert jax_export_main(["--run", jax_run, "--dst", jax_out]) == 0
    assert export_weights.main(["--run", port_run, "--dst", port_out]) == 0
    _assert_same_export(jax_out, port_out)
    return port_run


def test_export_mdn_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(registry._BUILDERS, "enc_deit", _tiny_port_encoder)
    head = GaussianMDN(D, 3, generator=torch.Generator().manual_seed(1)).state_dict()
    cfg = {"architecture": "mdn", "model_name": "enc_deit", "num_gaussians": 3,
           "img_size": IMG, "data_class": "widget"}
    _both_exports(tmp_path, cfg, tc.convert_mdn_head(_np(head)),
                  {"3_gaussians_enc_deit_widget.pth": head})


def test_export_nf_equals_jax(tmp_path, monkeypatch):
    """The JAX exporter sizes the flow's unused `layer_norm` by the JAX
    registry trunk's patches (2 x 2 at 32 px for DeiT-base/16): the port's
    file holds the same member."""
    monkeypatch.setitem(registry._BUILDERS, "enc_deit", _tiny_port_encoder)
    flow = NormalizingFlow(D, IMG, 4, hidden_ratio=0.16, flow_steps=4,
                           generator=torch.Generator().manual_seed(2)).state_dict()
    cfg = {"architecture": "nf", "model_name": "enc_deit", "img_size": IMG,
           "hidden_ratio": 0.16, "flow_steps": 4, "data_class": "widget"}
    _both_exports(tmp_path, cfg, tc.convert_nf_head(_np(flow), 4)[0],
                  {"nf_enc_deit_widget.pth": flow})


def test_export_mdn_resnet_equals_jax(tmp_path, fast_jax_resnet_init, monkeypatch):
    _jit_init(monkeypatch, JaxMDN)  # the JAX exporter's restore targets
    enc = _port_resnet_state()
    gen = torch.Generator().manual_seed(4)
    heads = [GaussianMDN(STAGE_CHANNELS[i], 2, generator=gen).state_dict()
             for i in RESNET_MDN_STAGES]
    jax_enc = tc.convert_resnet_encoder(_np(enc))
    tree = {"heads": [tc.convert_mdn_head(_np(h)) for h in heads],
            "encoder": jax_enc["params"], "enc_batch_stats": jax_enc["batch_stats"]}
    cfg = {"architecture": "mdn", "model_name": "enc_res_net", "num_gaussians": 2,
           "img_size": IMG, "data_class": "synth"}
    files = {f"2_gaussians_enc_res_net_stage{i}_synth.pth": h
             for i, h in zip(RESNET_MDN_STAGES, heads)}
    port_run = _both_exports(tmp_path, cfg, tree,
                             {**files, "ResNetEncoder_synth.pth": enc}, dst_dir=True)
    assert sorted(os.listdir(tmp_path / "port_out")) == [
        "2_stage2_synth.pth", "2_stage3_synth.pth", "ResNetEncoder_synth.pth"]
    # a multi-stage run exports into a directory, never one .pth
    assert export_weights.main(["--run", port_run, "--dst", str(tmp_path / "one.pth")]) == 2


def test_export_nf_resnet_equals_jax(tmp_path, fast_jax_resnet_init, monkeypatch):
    _jit_init(monkeypatch, JaxNormalizingFlow)  # the JAX exporter's restore targets
    enc = _port_resnet_state()
    hp = HyperParams(img_size=IMG, hidden_ratio=0.16, flow_steps=2)
    gen = torch.Generator().manual_seed(6)
    flows = [stage_flow(hp, i, gen).state_dict() for i in NF_RESNET_STAGES]
    jax_enc = tc.convert_resnet_encoder(_np(enc))
    tree = {"heads": [tc.convert_nf_head(_np(f), 2)[0] for f in flows],
            "encoder": jax_enc["params"], "enc_batch_stats": jax_enc["batch_stats"]}
    cfg = {"architecture": "nf", "model_name": "enc_res_net", "img_size": IMG,
           "hidden_ratio": 0.16, "flow_steps": 2, "data_class": "synth"}
    files = {f"nf_enc_res_net_stage{i}_synth.pth": f for i, f in zip(NF_RESNET_STAGES, flows)}
    _both_exports(tmp_path, cfg, tree, {**files, "ResNetEncoder_synth.pth": enc}, dst_dir=True)
    assert sorted(os.listdir(tmp_path / "port_out")) == [
        "NormalizingFlow_0_synth.pth", "NormalizingFlow_1_synth.pth",
        "NormalizingFlow_2_synth.pth", "ResNetEncoder_synth.pth"]


@pytest.mark.parametrize("model", ["ae_cnn", "ae_deit", "ae_res_net_small"])
def test_export_recon_equals_jax(model, tmp_path, monkeypatch):
    """The whole auto-encoder: the vanilla CNN AE, a transformer AE (tiny
    DeiT trunk under `encoder.deit.`, zeroed heads, ResNetDecoder) and the
    ResNet AE (its zeroed classifier `fc` emitted, as the JAX exporter
    emits it)."""
    monkeypatch.setitem(registry._BUILDERS, "enc_deit", _tiny_port_encoder)
    ae = registry.get_model(model, IMG, DtypePolicy.f32(),
                            generator=torch.Generator().manual_seed(7)).state_dict()
    if model == "ae_res_net_small":
        assert "encoder.res_net.fc.weight" in ae
    cfg = {"architecture": "reconstruction", "model_name": model, "img_size": IMG,
           "data_class": "widget"}
    _both_exports(tmp_path, cfg, tc.convert_recon_ae(_np(ae), img_size=IMG),
                  {f"{model}_widget.pth": ae})


def test_export_refusals(tmp_path, capsys):
    """Exit code 2, as in the JAX CLI: ae_eff_net, architecture vae, a run
    without checkpoints; a JAX run directory names its own exporter."""
    def run(name, cfg, files=None):
        path = tmp_path / name
        os.makedirs(path)
        with open(path / "config.json", "w") as f:
            json.dump({**cfg, **({"checkpoints": list(files)} if files else {})}, f)
        for n in files or ():
            torch.save({}, path / n)
        return export_weights.main(["--run", str(path), "--dst", str(tmp_path / "x.pth")])

    assert run("effnet", {"architecture": "reconstruction", "model_name": "ae_eff_net"},
               ["ae_eff_net_x.pth"]) == 2
    assert "ae_eff_net" in capsys.readouterr().err
    assert run("vae", {"architecture": "vae", "model_name": "vae"}, ["vae_x.pth"]) == 2
    assert "'vae'" in capsys.readouterr().err
    assert run("none", {"architecture": "mdn", "model_name": "enc_deit"}) == 2
    assert "no checkpoint" in capsys.readouterr().err
    jax_dir = tmp_path / "jax_run"
    (jax_dir / "best_params").mkdir(parents=True)
    (jax_dir / "config.json").write_text(json.dumps({"architecture": "mdn",
                                                     "model_name": "enc_deit"}))
    assert export_weights.main(["--run", str(jax_dir), "--dst", str(tmp_path / "y.pth")]) == 2
    assert "vit_ad_tpu.cli.export_weights" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x.pth") and not os.path.exists(tmp_path / "y.pth")
