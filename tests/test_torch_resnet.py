"""The port's ResNet-50 multi-stage MDN slice against the JAX package, at
32 px in f32: the inference `FusedBatchNorm`, `ResNetEncoder.forward` and
`stage_features` with weights carried across by `resnet_state_dict_from_jax`,
strict loading of `export_resnet_encoder` output, `score_mdn_resnet` with K=2
heads, `train_mdn_resnet` against the JAX trainer on the noiseless path from
the same initial weights, and the `cli.train_mdn -m res_net` → two `.pth` +
encoder → `cli.score` round trip on the CPU.

The JAX ResNet-50 compiles slowly on the CPU: one module-scoped fixture holds
the JAX model, its variables and the jitted stage features."""

import csv
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import pil_decode
from test_torch_vit import jitter
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.config import HyperParams as JaxHyperParams
from vit_ad_tpu.data.loader import DataPipeline as JaxPipeline
from vit_ad_tpu.models.layers import FusedBatchNorm as JaxFusedBatchNorm
from vit_ad_tpu.models.mdn import GaussianMDN as JaxMDN
from vit_ad_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from vit_ad_tpu.ops import gmm as jax_gmm
from vit_ad_tpu.pipeline.eval import score_mdn_resnet as jax_score_mdn_resnet
from vit_ad_tpu.pipeline.train import train_mdn_resnet as jax_train_mdn_resnet
from vit_ad_tpu.utils.torch_convert import export_resnet_encoder
from vit_ad_tpu_torch.cli import score as score_cli
from vit_ad_tpu_torch.cli import train_mdn as train_cli
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.data import synthetic
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.models.layers import FusedBatchNorm
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.models.resnet import STAGE_CHANNELS, ResNetEncoder
from vit_ad_tpu_torch.ops import gmm as port_gmm
from vit_ad_tpu_torch.pipeline import train as train_module
from vit_ad_tpu_torch.pipeline.eval import score_mdn_resnet
from vit_ad_tpu_torch.pipeline.loading import build_pth_resnet_mdn_models, score_models
from vit_ad_tpu_torch.pipeline.train import train_mdn_resnet
from vit_ad_tpu_torch.utils.convert import mdn_state_dict_from_jax, resnet_state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, K, BATCH, STAGES = 32, 2, 6, (2, 3)
# f32 through 53 convolutions and BatchNorms, sums in other orders (JAX at
# "highest" matmul precision, tests/conftest.py): relative to the largest
# entry of each map.
RTOL = 1e-4


def _to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module")
def jax_resnet():
    """The JAX encoder at 32 px with jittered weights and running statistics
    away from (0, 1), and its jitted trunk and stage features."""
    enc = JaxResNetEncoder(img_size=IMG, dtypes=JaxDtypePolicy.f32())
    # jitted: op by op, the init takes twice its compile
    variables = jax.jit(enc.init)(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.default_rng(1)
    params = jitter(variables["params"], rng, 0.02)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (1.0 + 0.3 * rng.random(a.shape) if path[-1].key == "var"
                         else 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        _to_numpy(variables["batch_stats"]))
    variables = {"params": params, "batch_stats": stats}
    stage_features = jax.jit(lambda v, x: enc.apply(v, x, method=JaxResNetEncoder.stage_features))
    forward = jax.jit(lambda v, x: enc.apply(v, x))
    return {"encoder": enc, "variables": variables, "stage_features": stage_features,
            "forward": forward}


def port_resnet(variables) -> ResNetEncoder:
    enc = ResNetEncoder(IMG, DtypePolicy.f32())
    enc.load_state_dict(resnet_state_dict_from_jax(variables["params"],
                                                   variables["batch_stats"]), strict=True)
    return enc


def _images(seed=2, n=2):
    return np.random.default_rng(seed).standard_normal((n, IMG, IMG, 3)).astype(np.float32)


def _close(got, want, rtol=RTOL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_batch_norm_eval_matches_jax(dt):
    """Running statistics away from (0, 1); under bf16 both cast mean, mul and
    bias once and apply them on the bf16 map in the same order: the same bits
    but for the f32 rsqrt (one bf16 ulp, 2^-8 relative)."""
    rng = np.random.default_rng(3)
    c = 24
    x = rng.standard_normal((2, 5, 5, c)).astype(np.float32)
    scale, bias, mean = (rng.standard_normal(c).astype(np.float32) for _ in range(3))
    var = (0.5 + rng.random(c)).astype(np.float32)
    jdt = getattr(jnp, dt)
    policy = JaxDtypePolicy() if dt == "bfloat16" else JaxDtypePolicy.f32()
    want = JaxFusedBatchNorm(use_running_average=True, epsilon=1e-5, dtypes=policy).apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}},
        jnp.asarray(x, jdt))
    bn = FusedBatchNorm(c).eval()
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var),
                        "num_batches_tracked": torch.tensor(0)})
    xt = torch.from_numpy(x).to(getattr(torch, dt)).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = bn(xt).permute(0, 2, 3, 1)
    assert got.dtype == xt.dtype
    _close(got.float().numpy(), want.astype(jnp.float32), 1e-6 if dt == "float32" else 2.0**-7)
    # the cached folded form belongs to the inference path only (a frozen
    # trunk passes it); the training path is tests/test_torch_recon_models.py's
    with pytest.raises(RuntimeError, match="inference"):
        bn.train()(xt, bn.folded(xt.dtype))


def test_encoder_forward_and_stage_features_match_jax(jax_resnet):
    x = _images()
    enc = port_resnet(jax_resnet["variables"])
    want = jax_resnet["forward"](jax_resnet["variables"], jnp.asarray(x))
    want_stages = jax_resnet["stage_features"](jax_resnet["variables"], jnp.asarray(x))
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
        got_stages = enc.stage_features(torch.from_numpy(x))
        got_two = enc.stage_features(torch.from_numpy(x), STAGES)
    assert got.patch_embedding.shape == (2, 1, 2048) and enc.embed_dim == 2048
    assert enc.num_patches == 1
    _close(got.patch_embedding.numpy(), want.patch_embedding, what="patch_embedding")
    _close(got.latent.numpy(), want.latent, what="latent")
    assert [tuple(s.shape) for s in got_stages] == [tuple(s.shape) for s in want_stages]
    for i, (g, w) in enumerate(zip(got_stages, want_stages)):
        _close(g.numpy(), w, what=f"stage {i}")
    for g, i in zip(got_two, STAGES):
        assert torch.equal(g, got_stages[i])


def test_export_resnet_encoder_loads_strict_and_equals_port_conversion(jax_resnet):
    v = jax_resnet["variables"]
    exported = export_resnet_encoder(v)
    ours = resnet_state_dict_from_jax(v["params"], v["batch_stats"])
    assert sorted(exported) == sorted(ours)
    for k, a in exported.items():
        assert np.array_equal(a, ours[k].numpy()), k
    enc = ResNetEncoder(IMG, DtypePolicy.f32())
    enc.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in exported.items()},
                        strict=True)
    assert sorted(enc.state_dict()) == sorted(exported)
    # the converter copies: writing to its output leaves the source alone
    ours["norms.2.weight"].zero_()
    assert np.asarray(v["params"]["norm2_scale"]).any()


def test_only_the_stage_norms_train_and_the_trunk_gets_no_gradient(jax_resnet):
    enc = port_resnet(jax_resnet["variables"])
    trainable = sorted(n for n, p in enc.named_parameters() if p.requires_grad)
    assert trainable == sorted(f"norms.{i}.{k}" for i in range(4) for k in ("weight", "bias"))
    feats = enc.stage_features(torch.from_numpy(_images()), STAGES)
    sum(f.square().sum() for f in feats).backward()
    with_grad = sorted(n for n, p in enc.named_parameters() if p.grad is not None)
    assert with_grad == sorted(f"norms.{i}.{k}" for i in STAGES for k in ("weight", "bias"))
    assert not enc.training and not enc.res_net.bn1.training


def _jax_heads(seed):
    """Two JAX heads (D=1024, 2048; K=2) with jittered weights."""
    mdns, params = [], []
    for n, i in enumerate(STAGES):
        mdn = JaxMDN(features=STAGE_CHANNELS[i], num_gaussians=K)
        p = mdn.init(jax.random.key(seed + n), jnp.zeros((1, 1, STAGE_CHANNELS[i])))
        mdns.append(mdn)
        params.append(jitter(p, np.random.default_rng(seed + 10 + n), 0.01))
    return mdns, params


def _port_heads(params):
    heads = []
    for i, p in zip(STAGES, params):
        head = GaussianMDN(STAGE_CHANNELS[i], K, dtypes=DtypePolicy.f32())
        head.load_state_dict(mdn_state_dict_from_jax(p), strict=True)
        heads.append(head)
    return torch.nn.ModuleList(heads)


@pytest.fixture(scope="module")
def category(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_resnet")
    return synthetic.make_mvtec_category(str(root), "widget", img_size=IMG, n_train=12,
                                         n_test_good=3, n_test_defect=3)


@pytest.fixture(autouse=True)
def _pil_decode(monkeypatch):
    pil_decode(monkeypatch)


def test_score_mdn_resnet_matches_jax(jax_resnet, category):
    """Image scores and maps in [0, 1]; f32 end to end."""
    mdns, head_params = _jax_heads(20)
    mean, std = default_norm_stats()
    jhp = JaxHyperParams(img_size=IMG, batch_size=4, dtypes=JaxDtypePolicy.f32())
    want = jax_score_mdn_resnet(
        jax_resnet["encoder"], jax_resnet["variables"], mdns, head_params,
        JaxPipeline(batch_size=4, base_path=category, data_path="test", img_size=IMG,
                    validation_mode=True), jhp, mean, std)
    hp = HyperParams(img_size=IMG, batch_size=4, dtypes=DtypePolicy.f32())
    got = score_mdn_resnet(port_resnet(jax_resnet["variables"]), _port_heads(head_params),
                           DataPipeline(4, IMG, base_path=category, data_path="test",
                                        validation_mode=True), hp, mean, std)
    assert got.pixel_scores.shape == (6, IMG, IMG)
    np.testing.assert_allclose(got.image_scores, want.image_scores, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.pixel_scores, want.pixel_scores, rtol=0, atol=2e-5)
    assert np.array_equal(got.labels, want.labels)


def test_train_mdn_resnet_matches_jax_train_mdn_resnet(jax_resnet, category, monkeypatch):
    """The joint trainer against the JAX one on the noiseless path (the two
    random streams differ, so both sides' mixture weights ignore their noise
    source): the same trunk, the same head init (the JAX trainer's, converted),
    the same batches. f32, three epochs of Adam: the losses agree to f32
    summation order, which the optimizer steps amplify (the two sides' first
    gradients agree to 1e-5 of their largest entry, and an early Adam step
    moves each of the heads' 12.6 M weights by the learning rate in the
    gradient's sign; at 1e-3 the epoch losses differ by 3e-4 and the
    validation loss rises in epoch 2, at 2e-4 they fall steadily and agree to
    1e-5). Afterwards the trunk is bit-identical and the stage norms the heads
    read have moved."""
    jax_noiseless = jax_gmm.mixture_log_weights
    monkeypatch.setattr(jax_gmm, "mixture_log_weights",
                        lambda logits, rng=None, tau=1.0: jax_noiseless(logits, None, tau))
    port_noiseless = port_gmm.mixture_log_weights
    monkeypatch.setattr(port_gmm, "mixture_log_weights",
                        lambda logits, generator=None, tau=1.0: port_noiseless(logits, None, tau))
    kw = dict(model_name="enc_res_net", architecture="mdn", epochs=3, patience=3,
              learning_rate=2e-4, weight_decay=1e-4, batch_size=BATCH, img_size=IMG,
              num_gaussians=K)
    pipes = lambda cls, **extra: (
        cls(batch_size=BATCH, img_size=IMG, base_path=category, data_path="train/good", **extra),
        cls(batch_size=BATCH, img_size=IMG, base_path=category, data_path="test",
            validation_mode=True, **extra))
    jhp = JaxHyperParams(**kw, dtypes=JaxDtypePolicy.f32())
    variables = jax_resnet["variables"]
    # the trainer donates its parameter buffers: hand it copies
    want = jax_train_mdn_resnet(jhp, *pipes(JaxPipeline), encoder=jax_resnet["encoder"],
                                enc_variables=jax.tree.map(jnp.array, variables))
    # the head inits the JAX trainer drew (train.py:824, :840-842)
    rng, inits = jax.random.key(jhp.seed), []
    for i in STAGES:
        rng, k = jax.random.split(rng)
        mdn = JaxMDN(features=STAGE_CHANNELS[i], num_gaussians=K)
        inits.append(mdn_state_dict_from_jax(mdn.init(k, jnp.zeros((1, 1, STAGE_CHANNELS[i])))))

    def mdn_with_jax_init(features, num_gaussians, **kwargs):
        head = GaussianMDN(features, num_gaussians, **kwargs)
        head.load_state_dict(inits[STAGE_CHANNELS.index(features) - STAGES[0]], strict=True)
        return head

    monkeypatch.setattr(train_module, "GaussianMDN", mdn_with_jax_init)
    enc = port_resnet(variables)
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    got = train_mdn_resnet(HyperParams(**kw, dtypes=DtypePolicy.f32()), *pipes(DataPipeline),
                           encoder=enc, device="cpu")
    assert got.epochs_ran == want.epochs_ran == 3 and got.best_epoch == want.best_epoch
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(got.history[key], want.history[key], rtol=1e-4, err_msg=key)
    assert got.history["train_loss"][-1] < got.history["train_loss"][0]
    np.testing.assert_allclose(got.best_valid_loss, want.best_valid_loss, rtol=1e-4)
    for key in ("image_auroc_score", "pixel_auroc_score"):
        np.testing.assert_allclose(got.metrics[key], want.metrics[key], rtol=0, atol=1e-3,
                                   err_msg=key)
    after = got.encoder.state_dict()
    for k, v in before.items():
        changed = not torch.equal(v, after[k])
        assert changed == k.startswith(("norms.2.", "norms.3.")), k
    assert isinstance(got.head, torch.nn.ModuleList) and len(got.head) == 2
    # the stage norms the JAX trainer ended with
    best = want.head_params["encoder"]
    for i in STAGES:
        _close(after[f"norms.{i}.weight"].numpy(),
               np.transpose(np.asarray(best[f"norm{i}_scale"]), (2, 0, 1)), 1e-4, f"norm {i}")


def test_cli_train_res_net_then_score_round_trip(category, tmp_path):
    out = tmp_path / "run"
    rc = train_cli.main(["-m", "res_net", "-d", category, "-t", "train/good", "-v", "test",
                         "-n", str(K), "-e", "2", "-p", "2", "-b", str(BATCH), "-i", str(IMG),
                         "--device", "cpu", "--out", str(out)])
    assert rc == 0
    hist = json.loads((out / "history.json").read_text())
    assert len(hist["train_loss"]) == 2 and "image_auroc_score" in hist["metrics"]
    # the data class in the names is derived from the category's path
    pths = sorted(out.glob(f"{K}_gaussians_enc_res_net_stage*_*.pth"))
    assert [p.name.split("_")[5] for p in pths] == ["stage2", "stage3"]
    data_class = pths[0].stem.split("stage2_")[1]
    enc_pth = out / f"ResNetEncoder_{data_class}.pth"
    assert enc_pth.exists()
    test_dir = os.path.join(category, "test")
    scored = tmp_path / "scores"
    rc = score_cli.main(["--pth", str(pths[0]), str(pths[1]), "-a", "mdn", "-E", str(enc_pth),
                         "-d", test_dir, "-b", "4", "-i", str(IMG), "-o", str(scored),
                         "--device", "cpu"])
    assert rc == 0
    with open(scored / "scores.csv") as f:
        rows = list(csv.reader(f))[1:]
    imgs = score_cli.list_images(test_dir)
    assert [row[0] for row in rows] == imgs
    # the default policy is bf16 compute on either path
    m = build_pth_resnet_mdn_models([str(p) for p in pths], img_size=IMG,
                                    encoder_ckpt=str(enc_pth))
    assert m.kind == "mdn_resnet" and m.hp.num_gaussians == K
    want = score_models(m, DataPipeline(4, IMG, files=imgs), *default_norm_stats())
    np.testing.assert_allclose([float(row[1]) for row in rows], want.image_scores, rtol=0,
                               atol=1e-6)
    # the run directory lists the same files: `-r` scores as `--pth` does
    by_run = tmp_path / "by_run"
    assert score_cli.main(["-r", str(out), "-d", test_dir, "-b", "4", "-o", str(by_run),
                           "--device", "cpu"]) == 0
    assert (by_run / "scores.csv").read_text() == (scored / "scores.csv").read_text()
    # a torchvision-layout trunk file loads too; the norms then keep their init
    full = torch.load(enc_pth, weights_only=True)
    tv = tmp_path / "resnet50.pth"
    torch.save({k[len("res_net."):]: v for k, v in full.items() if k.startswith("res_net.")
                and not k.startswith("res_net.fc.")}, tv)
    m2 = build_pth_resnet_mdn_models([str(p) for p in pths], img_size=IMG, encoder_ckpt=str(tv))
    sd2 = m2.parts[0].state_dict()
    assert torch.equal(sd2["res_net.layer3.0.conv2.weight"], full["res_net.layer3.0.conv2.weight"])
    assert torch.equal(sd2["norms.2.weight"], torch.ones_like(sd2["norms.2.weight"]))


@pytest.mark.parametrize("args,match", [
    (["--pth", "2_a_w.pth", "2_b_w.pth", "-a", "nf"], "use -a mdn"),
    (["--pth", "2_a_w.pth", "2_b_w.pth", "2_c_w.pth", "-a", "mdn"], "two stage-head files"),
])
def test_score_cli_names_the_two_file_convention(args, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        score_cli.main(args + ["-d", str(tmp_path), "--device", "cpu"])


@pytest.mark.parametrize("module,argv", [
    ("vit_ad_tpu_torch.cli.train_mdn", ["-m", "res_net"]),
    ("vit_ad_tpu_torch.cli.score", ["--pth", "2_gaussians_enc_res_net_stage2_widget.pth",
                                    "2_gaussians_enc_res_net_stage3_widget.pth", "-a", "mdn"]),
])
def test_resnet_clis_without_a_card_name_device_cpu(module, argv, tmp_path):
    p = subprocess.run([sys.executable, "-m", module, *argv, "-d", str(tmp_path)], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert "--device cpu" in p.stderr
