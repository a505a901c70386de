"""The port's NF heads on the ResNet-50 stage maps against the JAX package, at
32 px in f32: `make_nf_resnet_batch_fn` and `score_nf_resnet` with weights
carried across by `nf_resnet_state_dicts_from_jax`, `train_nf_resnet` against
the JAX `train_nf_resnet` from the same initial weights, and the
`cli.train_nf -m res_net` → run directory → `cli.score -r` round trip on the
CPU.

The JAX ResNet-50 builds and compiles slowly on the CPU: one module fixture
holds the JAX encoder and its jittered variables, and one runs the JAX
trainer once (its history, its trained weights and its test metrics)."""

import csv
import json
import os

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
from vit_ad_tpu.models.flow import NormalizingFlow as JaxFlow
from vit_ad_tpu.models.resnet import STAGE_CHANNELS as JAX_STAGE_CHANNELS
from vit_ad_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from vit_ad_tpu.pipeline.eval import make_nf_resnet_batch_fn as jax_make_nf_resnet_batch_fn
from vit_ad_tpu.pipeline.eval import score_nf_resnet as jax_score_nf_resnet
from vit_ad_tpu.pipeline.train import train_nf_resnet as jax_train_nf_resnet
from vit_ad_tpu_torch.cli import score as score_cli
from vit_ad_tpu_torch.cli import train_nf as train_nf_cli
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.data import synthetic
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.models.flow import NormalizingFlow
from vit_ad_tpu_torch.models.resnet import STAGE_CHANNELS, STAGE_SCALES, ResNetEncoder
from vit_ad_tpu_torch.pipeline import train as train_module
from vit_ad_tpu_torch.pipeline.eval import make_nf_resnet_batch_fn, score_nf_resnet
from vit_ad_tpu_torch.pipeline.loading import (
    RunModels,
    compress_params_bf16,
    load_run,
    score_models,
)
from vit_ad_tpu_torch.pipeline.train import NF_RESNET_STAGES, train_nf_resnet
from vit_ad_tpu_torch.utils.convert import nf_resnet_state_dicts_from_jax

IMG, STEPS, RATIO, BATCH, EPOCHS = 32, 2, 0.16, 6, 2
# f32 end to end (53 convolutions and BatchNorms, the stage norms, two flow
# steps, the resize): sums in other orders; scores and maps lie in [0, 1)
ATOL = 2e-5
KW = dict(model_name="enc_res_net", architecture="nf", epochs=EPOCHS, patience=EPOCHS,
          learning_rate=2e-4, weight_decay=1e-5, batch_size=BATCH, img_size=IMG,
          hidden_ratio=RATIO, flow_steps=STEPS)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _jax_flows():
    return [JaxFlow(num_channels=JAX_STAGE_CHANNELS[i], img_size=IMG,
                    num_patches=(IMG // STAGE_SCALES[i]) ** 2, hidden_ratio=RATIO,
                    flow_steps=STEPS, dtypes=JaxDtypePolicy.f32()) for i in NF_RESNET_STAGES]


def _pipes(cls, cat):
    return (cls(batch_size=BATCH, img_size=IMG, base_path=cat, data_path="train/good"),
            cls(batch_size=BATCH, img_size=IMG, base_path=cat, data_path="test",
                validation_mode=True))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A synthetic category; the JAX encoder at 32 px with jittered weights
    and running statistics away from (0, 1), and jittered stage flows; and
    the JAX trainer's run from that encoder: its history, metrics, the flow
    inits it drew and its trained encoder params."""
    mp = pytest.MonkeyPatch()
    pil_decode(mp)
    cat = synthetic.make_mvtec_category(str(tmp_path_factory.mktemp("torch_resnet_nf")),
                                        "widget", img_size=IMG, n_train=12, n_test_good=3,
                                        n_test_defect=3)
    enc = JaxResNetEncoder(img_size=IMG, dtypes=JaxDtypePolicy.f32())
    # jitted: op by op, the init takes twice its compile
    variables = jax.jit(enc.init)(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (1.0 + 0.3 * rng.random(a.shape) if path[-1].key == "var"
                         else 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        _np(variables["batch_stats"]))
    variables = {"params": jitter(variables["params"], rng, 0.02), "batch_stats": stats}
    flows = _jax_flows()
    flow_params = [jitter(jax.jit(f.init)(jax.random.key(5 + n), jnp.zeros((1, s, s, c))),
                          np.random.default_rng(30 + n), 0.05)
                   for n, (f, c, s) in enumerate(
                       (f, STAGE_CHANNELS[i], IMG // STAGE_SCALES[i])
                       for f, i in zip(flows, NF_RESNET_STAGES))]
    jhp = JaxHyperParams(**KW, dtypes=JaxDtypePolicy.f32())
    # the trainer donates its parameter buffers: hand it copies
    trained = jax_train_nf_resnet(jhp, *_pipes(JaxPipeline, cat), encoder=enc,
                                  enc_variables=jax.tree.map(jnp.array, variables))
    # the flow inits the JAX trainer drew (train.py:1285-1308)
    key, inits = jax.random.key(jhp.seed), []
    for f, i in zip(flows, NF_RESNET_STAGES):
        key, k = jax.random.split(key)
        s = IMG // STAGE_SCALES[i]
        inits.append(_np(f.init(k, jnp.zeros((1, s, s, STAGE_CHANNELS[i])))))
    yield {"cat": cat, "encoder": enc, "variables": variables, "flows": flows,
           "flow_params": flow_params, "trained": trained, "inits": inits, "hp": jhp}
    mp.undo()


@pytest.fixture(autouse=True)
def _pil_decode(monkeypatch):
    pil_decode(monkeypatch)


def _port_models(variables, flow_params):
    flow_sds, enc_sd = nf_resnet_state_dicts_from_jax(flow_params, variables, IMG)
    enc = ResNetEncoder(IMG, DtypePolicy.f32())
    enc.load_state_dict(enc_sd, strict=True)
    flows = torch.nn.ModuleList()
    for i, sd in zip(NF_RESNET_STAGES, flow_sds):
        flow = NormalizingFlow(STAGE_CHANNELS[i], IMG, (IMG // STAGE_SCALES[i]) ** 2,
                               hidden_ratio=RATIO, flow_steps=STEPS)
        flow.load_state_dict(sd, strict=True)
        flows.append(flow)
    return enc.eval(), flows.eval()


def test_nf_resnet_batch_fn_stage_maps_match_jax(jax_run):
    """The batch function's stage-mean anomaly map, and each stage flow's map
    on the LayerNorm'd stage map, against the JAX functions."""
    r = jax_run
    mean, std = default_norm_stats()
    images = np.random.default_rng(4).integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    jfn = jax.jit(jax_make_nf_resnet_batch_fn(r["encoder"], r["flows"], r["hp"],
                                              jnp.asarray(mean), jnp.asarray(std),
                                              NF_RESNET_STAGES))
    want = np.asarray(jfn(r["variables"], r["flow_params"], jnp.asarray(images)))
    enc, flows = _port_models(r["variables"], r["flow_params"])
    hp = HyperParams(img_size=IMG, dtypes=DtypePolicy.f32())
    fn = make_nf_resnet_batch_fn(enc, flows, hp, torch.from_numpy(mean), torch.from_numpy(std))
    with torch.no_grad():
        got = fn(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, IMG, IMG)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    x = (images.astype(np.float32) / 255.0 - mean) / std
    # the JAX side jitted: op by op, its ResNet-50 alone takes longer than the
    # compile
    jmaps = jax.jit(lambda v, xx: r["encoder"].apply(
        v, xx, method=JaxResNetEncoder.stage_features))(r["variables"], jnp.asarray(x))
    jflow = jax.jit(lambda n, p, fm: r["flows"][n].apply(p, fm).anomaly_score_map,
                    static_argnums=0)
    with torch.no_grad():
        maps = enc.stage_features(torch.from_numpy(x), NF_RESNET_STAGES)
        for n, (i, m, flow) in enumerate(zip(NF_RESNET_STAGES, maps, flows)):
            stage_want = jflow(n, r["flow_params"][n], jmaps[i])
            np.testing.assert_allclose(flow(m).anomaly_score_map.numpy(),
                                       np.asarray(stage_want), rtol=0, atol=ATOL,
                                       err_msg=f"stage {i}")


def test_score_nf_resnet_matches_jax(jax_run):
    r = jax_run
    mean, std = default_norm_stats()
    test = lambda cls: cls(batch_size=4, img_size=IMG, base_path=r["cat"], data_path="test",
                           validation_mode=True)
    want = jax_score_nf_resnet(r["encoder"], r["variables"], r["flows"], r["flow_params"],
                               test(JaxPipeline), r["hp"], mean, std)
    hp = HyperParams(img_size=IMG, batch_size=4, dtypes=DtypePolicy.f32())
    got = score_nf_resnet(*_port_models(r["variables"], r["flow_params"]), test(DataPipeline),
                          hp, mean, std)
    assert got.pixel_scores.shape == (6, IMG, IMG)
    np.testing.assert_allclose(got.image_scores, want.image_scores, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.pixel_scores, want.pixel_scores, rtol=0, atol=ATOL)
    assert np.array_equal(got.labels, want.labels) and np.array_equal(got.masks, want.masks)


def test_train_nf_resnet_matches_jax_train_nf_resnet(jax_run, monkeypatch):
    """The joint trainer against the JAX one: the same trunk, the same flow
    inits (the JAX trainer's, converted), the same batches; f32, two epochs of
    Adam at lr 2e-4 (as `test_torch_resnet.py` trains the MDN heads: early
    Adam steps move every weight by the learning rate in its gradient's sign,
    so a larger rate amplifies f32 summation order). The losses, the best
    validation loss and the stage norms the flows read (0, 1, 2) end within
    1e-4; the trunk is bit-identical. Stage norm 3 feeds no flow: the port's
    Adam skips it (no gradient), while the JAX optimizer labels every
    non-trunk encoder parameter "train" and moves it by weight decay alone
    (`train.py:791-802`), so it is left out of the comparison; no score reads
    it."""
    r = jax_run
    want = r["trained"]
    inits = [sd for sd, _ in zip(
        nf_resnet_state_dicts_from_jax(r["inits"], r["variables"], IMG)[0], NF_RESNET_STAGES)]

    def flow_with_jax_init(num_channels, **kw):
        flow = NormalizingFlow(num_channels=num_channels, **kw)
        flow.load_state_dict(inits[STAGE_CHANNELS.index(num_channels)], strict=True)
        return flow

    monkeypatch.setattr(train_module, "NormalizingFlow", flow_with_jax_init)
    enc = _port_models(r["variables"], r["flow_params"])[0]
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    got = train_nf_resnet(HyperParams(**KW, dtypes=DtypePolicy.f32()),
                          *_pipes(DataPipeline, r["cat"]), encoder=enc, device="cpu")
    assert got.epochs_ran == want.epochs_ran == EPOCHS and got.best_epoch == want.best_epoch
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(got.history[key], want.history[key], rtol=1e-4, err_msg=key)
    assert got.history["train_loss"][-1] < got.history["train_loss"][0]
    np.testing.assert_allclose(got.best_valid_loss, want.best_valid_loss, rtol=1e-4)
    for key in ("image_auroc_score", "pixel_auroc_score"):
        np.testing.assert_allclose(got.metrics[key], want.metrics[key], rtol=0, atol=1e-3,
                                   err_msg=key)
    after = got.encoder.state_dict()
    moved = sorted(k for k, v in before.items() if not torch.equal(v, after[k]))
    assert moved == sorted(f"norms.{i}.{leaf}" for i in NF_RESNET_STAGES
                           for leaf in ("weight", "bias"))
    best = want.head_params["encoder"]
    for i in NF_RESNET_STAGES:
        for leaf, jleaf in (("weight", "scale"), ("bias", "bias")):
            w = np.transpose(np.asarray(best[f"norm{i}_{jleaf}"]), (2, 0, 1))
            np.testing.assert_allclose(after[f"norms.{i}.{leaf}"].numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(), err_msg=f"norm {i} {leaf}")
    assert isinstance(got.head, torch.nn.ModuleList) and len(got.head) == 3


def test_cli_train_nf_res_net_then_score_run_round_trip(jax_run, tmp_path):
    """`cli.train_nf -m res_net` writes the run directory (the stage flows
    and the encoder as checkpoints, listed in config.json); `cli.score -r`
    on it gives the scores of `score_models` on `load_run`'s models, and
    `--heatmaps 2` two overlays."""
    cat = jax_run["cat"]
    out = tmp_path / "run"
    rc = train_nf_cli.main(["-m", "res_net", "-d", cat, "-t", "train/good", "-v", "test",
                            "-e", "2", "-p", "2", "-b", str(BATCH), "-i", str(IMG), "-f",
                            str(STEPS), "--device", "cpu", "--out", str(out)])
    assert rc == 0
    cfg = json.loads((out / "config.json").read_text())
    data_class = cfg["data_class"]
    assert cfg["checkpoints"] == [f"nf_enc_res_net_stage{i}_{data_class}.pth"
                                  for i in NF_RESNET_STAGES] + [f"ResNetEncoder_{data_class}.pth"]
    for name in ("metrics.jsonl", "metrics.csv", "history.json", "loss_curves.png",
                 "figures/roc_curve.png", *cfg["checkpoints"]):
        assert (out / name).exists(), name
    test_dir = os.path.join(cat, "test")
    scored = tmp_path / "scores"
    assert score_cli.main(["-r", str(out), "-d", test_dir, "-b", "4", "-o", str(scored),
                           "--heatmaps", "2", "--device", "cpu"]) == 0
    with open(scored / "scores.csv") as f:
        rows = list(csv.reader(f))[1:]
    imgs = score_cli.list_images(test_dir)
    assert [row[0] for row in rows] == imgs
    m, _ = load_run(str(out))
    assert m.kind == "nf_resnet"
    m.hp.batch_size = 4
    want = score_models(m, DataPipeline(4, IMG, files=imgs), *default_norm_stats())
    np.testing.assert_allclose([float(row[1]) for row in rows], want.image_scores, rtol=0,
                               atol=1e-6)
    assert len(os.listdir(scored / "heatmaps")) == 2
    hist = json.loads((out / "history.json").read_text())
    assert len(hist["train_loss"]) == 2 and "image_auroc_score" in hist["metrics"]


def test_compress_params_bf16_refolds_the_batch_norms(jax_run):
    """bf16 at rest on the NF-ResNet models after a first forward pass: the
    trunk's folded BatchNorms and cast convolutions (cached, keyed on the
    parameters and the running statistics) are made again from the rounded
    tensors, so the scores equal those of models cast before any forward
    pass, and differ from the f32 weights'."""
    r = jax_run
    mean, std = default_norm_stats()
    hp = HyperParams(img_size=IMG, batch_size=4, dtypes=DtypePolicy.f32())
    files = score_cli.list_images(os.path.join(r["cat"], "test"))
    score = lambda m: score_models(m, DataPipeline(4, IMG, files=files), mean, std).image_scores
    warm = RunModels(kind="nf_resnet", hp=hp, parts=_port_models(r["variables"],
                                                                 r["flow_params"]))
    f32 = score(warm)
    n = compress_params_bf16(warm)
    cold = RunModels(kind="nf_resnet", hp=hp, parts=_port_models(r["variables"],
                                                                 r["flow_params"]))
    assert compress_params_bf16(cold) == n
    got = score(warm)
    np.testing.assert_array_equal(got, score(cold))
    assert np.abs(got - f32).max() > 1e-4
    stats = [t for t in warm.parts[0].buffers() if t.dtype == torch.float32]
    assert stats and all(torch.equal(t, t.to(torch.bfloat16).float()) for t in stats)
