"""The port's trainers on a (data, model) mesh of spawned gloo ranks
(tests/_torch_mesh_ranks.py) at the configurations of
tests/test_mesh_training.py: img 32, the tiny ViT (depth 2, width 32, 4
heads), K=8, batch 8 (the last batch padded). Every trainer runs on a 2x2
mesh (the MDN heads hold 4 of 8 components a model rank, the ResNet heads 2
of 4; the recon and VAE BatchNorms take the global batch's statistics) and
is held against the port's single-process run from the same init, and each
of the six trainers also against the JAX package's single-device run from
the JAX trainer's init (the MDN trainers on the noiseless path, the VAE on
the JAX trainer's ε). Replicated parameters end equal, to the bit, on every
rank; a k-means-seeded head runs k-means once, on the primary.
Two ranks of an explicit cluster (the `VITAD_*` variables) run the CLIs with
`--mesh` (ae_cnn recon on 2x1, MDN on 1x2, `cli.score --mesh 2`) against the
same commands in one process; only the primary writes."""

import csv
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from test_torch_data import pil_decode
from test_torch_recon_train import _jax_trainer_init
from test_torch_vit import jax_encoder, jax_params
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.config import HyperParams as JaxHyperParams
from vit_ad_tpu.data.loader import DataPipeline as JaxPipeline
from vit_ad_tpu.models import autoencoder as jae
from vit_ad_tpu.models.flow import NormalizingFlow as JaxFlow
from vit_ad_tpu.models.mdn import GaussianMDN as JaxMDN
from vit_ad_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from vit_ad_tpu.models.vae import VariationalAutoEncoder as JaxVAE
from vit_ad_tpu.ops import gmm as jax_gmm
from vit_ad_tpu.pipeline.train import train_mdn as jax_train_mdn
from vit_ad_tpu.pipeline.train import train_mdn_resnet as jax_train_mdn_resnet
from vit_ad_tpu.pipeline.train import train_nf as jax_train_nf
from vit_ad_tpu.pipeline.train import train_nf_resnet as jax_train_nf_resnet
from vit_ad_tpu.pipeline.train import train_recon as jax_train_recon
from vit_ad_tpu.pipeline.train import train_vae as jax_train_vae
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.cli import score as score_cli
from vit_ad_tpu_torch.cli import train_mdn as train_mdn_cli
from vit_ad_tpu_torch.cli import train_recon as train_recon_cli
from vit_ad_tpu_torch.data import synthetic
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.models.resnet import STAGE_CHANNELS, STAGE_SCALES
from vit_ad_tpu_torch.parallel.launch import cluster_env, free_port
from vit_ad_tpu_torch.pipeline.train import NF_RESNET_STAGES, RESNET_MDN_STAGES
from vit_ad_tpu_torch.utils.convert import (
    mdn_state_dict_from_jax,
    nf_resnet_state_dicts_from_jax,
    nf_state_dict_from_jax,
    recon_state_dict_from_jax,
    resnet_state_dict_from_jax,
    vae_state_dict_from_jax,
    vit_state_dict_from_jax,
)

JF32 = JaxDtypePolicy.f32()
IMG, BATCH = ranks.IMG, ranks.BATCH
# Histories, mesh against one process and against JAX (rtol): f32 sums in
# other orders, amplified by Adam (tests/test_torch_train.py:322-329). The
# auto-encoders' conv biases in front of a BatchNorm get gradients that are
# f32 noise, which Adam turns into steps of ~0.1·lr whose signs the summation
# order decides (tests/test_torch_recon_train.py:55-65): their train losses
# are held at the JAX package's own mesh tolerance (tests/test_mesh_training.py
# `_assert_parity`, 2e-3) and their validation losses at the recon trainer's
# (5e-3); measured 5.7e-4 and 1.8e-3.
HISTORY_RTOL = {"recon": (2e-3, 5e-3), "vae": (2e-3, 5e-3)}
DEFAULT_RTOL = (1e-4, 1e-4)
METRIC_ATOL = 1e-3
JAX_CASES = ("nf", "mdn_noiseless", "recon", "vae", "mdn_resnet_noiseless", "nf_resnet")
MDN_K = ranks.CASES["mdn"]["num_gaussians"]
RESNET_K = ranks.CASES["mdn_resnet"]["num_gaussians"]
SEED = 24  # ranks.case_hp
# more ε than the VAE trainer's steps take (3 epochs of train and
# validation batches)
VAE_STEPS = 32


@pytest.fixture(scope="module")
def category(tmp_path_factory):
    return synthetic.make_mvtec_category(str(tmp_path_factory.mktemp("mesh_train")), "cat",
                                         img_size=IMG, n_train=24, n_test_good=6,
                                         n_test_defect=6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_vae_start():
    """The variables the JAX `train_vae` starts from and the ε of its steps,
    in order (train.py:1469-1480, :1548-1566: one key split off for each
    train and validation step)."""
    vae = JaxVAE(img_size=IMG, dtypes=JF32)
    rng, k1, k2 = jax.random.split(jax.random.key(SEED), 3)
    variables = jax.jit(lambda a, b: vae.init(a, jnp.zeros((1, IMG, IMG, 3)), b,
                                              train=True))(k1, k2)
    eps = []
    for _ in range(VAE_STEPS):
        rng, k = jax.random.split(rng)
        eps.append(np.asarray(jax.random.normal(k, (BATCH, vae.latent_dim))))
    return vae, _np(variables), np.stack(eps)


def _jax_resnet_heads(resnet_variables):
    """The stage heads the JAX ResNet trainers draw from `hp.seed`
    (train.py:824, :840-842 for the MDN heads, :1285-1308 for the flows), as
    torch state dicts by stage."""
    rng, mdn = jax.random.key(SEED), {}
    for i in RESNET_MDN_STAGES:
        rng, k = jax.random.split(rng)
        head = JaxMDN(features=STAGE_CHANNELS[i], num_gaussians=RESNET_K, dtypes=JF32)
        mdn[i] = mdn_state_dict_from_jax(head.init(k, jnp.zeros((1, 1, STAGE_CHANNELS[i]))))
    rng, flows = jax.random.key(SEED), []
    for i in NF_RESNET_STAGES:
        rng, k = jax.random.split(rng)
        s = IMG // STAGE_SCALES[i]
        flow = JaxFlow(num_channels=STAGE_CHANNELS[i], img_size=IMG, num_patches=s * s,
                       hidden_ratio=ranks.CASES["nf_resnet"]["hidden_ratio"],
                       flow_steps=ranks.CASES["nf_resnet"]["flow_steps"], dtypes=JF32)
        flows.append(_np(flow.init(k, jnp.zeros((1, s, s, STAGE_CHANNELS[i])))))
    nf = nf_resnet_state_dicts_from_jax(flows, resnet_variables, IMG, NF_RESNET_STAGES)[0]
    return mdn, dict(zip(NF_RESNET_STAGES, nf))


@pytest.fixture(scope="module")
def inits(tmp_path_factory):
    """The inits the JAX trainers start from (train.py:137-152, :304-335,
    :485-491, :1469-1480, and the heads of `_jax_resnet_heads`), as torch
    state dicts: the tiny ViT, the MDN and NF heads, ae_cnn, the VAE, the
    ResNet-50 trunk (the JAX encoder's init) and its stage heads; and the
    ε of the JAX VAE trainer's steps."""
    out = str(tmp_path_factory.mktemp("inits"))
    enc_params = jax_params(2, seed=0)
    resnet = JaxResNetEncoder(img_size=IMG, dtypes=JF32)
    resnet_vars = _np(jax.jit(resnet.init)(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3))))
    vae, vae_vars, vae_eps = _jax_vae_start()
    np.save(os.path.join(out, "vae_eps.npy"), vae_eps)
    mdn_resnet, nf_resnet = _jax_resnet_heads(resnet_vars)
    key = jax.random.split(jax.random.key(SEED))[1]
    mdn = JaxMDN(features=ranks.D, num_gaussians=MDN_K, dtypes=JF32)
    flow = JaxFlow(num_channels=ranks.D, img_size=IMG, num_patches=16,
                   hidden_ratio=ranks.CASES["nf"]["hidden_ratio"],
                   flow_steps=ranks.CASES["nf"]["flow_steps"], dtypes=JF32)
    ae = jae.VanillaAutoEncoder(img_size=IMG, dtypes=JF32)
    for name, state in (
            ("encoder", vit_state_dict_from_jax(enc_params)),
            ("mdn", mdn_state_dict_from_jax(jax.jit(mdn.init)(key, jnp.zeros((1, 1, ranks.D))))),
            ("flow", nf_state_dict_from_jax(
                jax.jit(flow.init)(key, jnp.zeros((1, 4, 4, ranks.D))), 16)),
            ("ae_cnn", recon_state_dict_from_jax(_jax_trainer_init(ae, SEED))),
            ("vae", vae_state_dict_from_jax(vae_vars)),
            ("resnet", resnet_state_dict_from_jax(resnet_vars["params"],
                                                  resnet_vars["batch_stats"])),
            ("mdn_resnet", mdn_resnet), ("nf_resnet", nf_resnet)):
        torch.save(state, os.path.join(out, f"{name}.pt"))
    return {"dir": out, "enc_params": enc_params, "ae": ae, "vae": vae,
            "resnet": resnet, "resnet_vars": resnet_vars}


def _jax_runs(category, inits):
    """The JAX package's single-device runs of the JAX cases."""
    pipes = lambda: (JaxPipeline(batch_size=BATCH, img_size=IMG, base_path=category,
                                 data_path="train/good"),
                     JaxPipeline(batch_size=BATCH, img_size=IMG, base_path=category,
                                 data_path="test", validation_mode=True))

    def hp(case):
        h = ranks.case_hp(case)
        kw = {k: getattr(h, k) for k in ("architecture", "epochs", "patience",
                                          "learning_rate", "weight_decay", "batch_size",
                                          "img_size", "seed", "num_gaussians", "hidden_ratio",
                                          "flow_steps", "model_name")}
        return JaxHyperParams(**kw, dtypes=JF32)

    enc = lambda: dict(encoder=jax_encoder(2, JF32),
                       enc_params=jax.tree.map(jnp.array, inits["enc_params"]))
    # the trainers donate their parameter buffers: hand them copies
    resnet = lambda: dict(encoder=inits["resnet"],
                          enc_variables=jax.tree.map(jnp.array, inits["resnet_vars"]))
    out = {"nf": jax_train_nf(hp("nf"), *pipes(), **enc()),
           "recon": jax_train_recon(hp("recon"), *pipes(), model=inits["ae"]),
           "vae": jax_train_vae(hp("vae"), *pipes(), model=inits["vae"]),
           "nf_resnet": jax_train_nf_resnet(hp("nf_resnet"), *pipes(), **resnet())}
    mp = pytest.MonkeyPatch()
    noisy = jax_gmm.mixture_log_weights
    mp.setattr(jax_gmm, "mixture_log_weights",
               lambda logits, rng=None, tau=1.0: noisy(logits, None, tau))
    try:
        out["mdn_noiseless"] = jax_train_mdn(hp("mdn_noiseless"), *pipes(), **enc())
        out["mdn_resnet_noiseless"] = jax_train_mdn_resnet(hp("mdn_resnet_noiseless"),
                                                           *pipes(), **resnet())
    finally:
        mp.undo()
    return out


def _cli_single(category, root):
    """The CLI runs of `ranks.cli_world2` in this process, without --mesh."""
    common = ["-d", category, "-t", "train/good", "-v", "test", "-e", "2", "-p", "2",
              "-b", str(BATCH), "-i", str(IMG), "--device", "cpu"]
    assert train_recon_cli.main(["-m", "ae_cnn", "-l", ranks.CLI_RECON_LR, *common,
                                 "--out", f"{root}/recon"]) == 0
    assert train_mdn_cli.main(["-m", "deit", "-n", "4", *common, "--out", f"{root}/mdn"]) == 0


@pytest.fixture(scope="module")
def runs(category, inits, tmp_path_factory):
    """Every run of the module. The ranks run while this process runs the
    single-process and JAX counterparts."""
    mp = pytest.MonkeyPatch()
    pil_decode(mp)  # PIL decode on every side (the ranks inherit the variable)
    mp.setitem(registry._BUILDERS, "enc_deit", ranks.tiny_vit)
    try:
        mesh = ranks.Ranks(ranks.training_world4, 4, str(tmp_path_factory.mktemp("world4")),
                           category, inits["dir"])
        cli_root = str(tmp_path_factory.mktemp("cli_mesh"))
        coordinator = f"127.0.0.1:{free_port()}"
        cli = ranks.Ranks(ranks.cli_world2, 2, str(tmp_path_factory.mktemp("world2")),
                          category, cli_root,
                          envs=[{**cluster_env(coordinator, 2, r), "VITAD_NO_NATIVE": "1"}
                                for r in range(2)])
        single = {case: ranks.run_case(case, category, inits["dir"]) for case in ranks.CASES}
        jax_runs = _jax_runs(category, inits)
        single_root = str(tmp_path_factory.mktemp("cli_single"))
        _cli_single(category, single_root)
        yield {"mesh": mesh.results(), "single": single, "jax": jax_runs, "cli": cli.results(),
               "cli_root": cli_root, "single_root": single_root}
    finally:
        mp.undo()


def _histories(got, want, rtols, what):
    for key, rtol in zip(("train_loss", "valid_loss"), rtols):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=f"{what} {key}")


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_mesh_run_matches_the_single_process_run(case, runs):
    """Each rank's history, stop epochs and metrics against one process from
    the same init: the global masked mean over a padded last batch (trap 1),
    the single-device noise (trap 2), the sharded heads (3-5), the global
    BatchNorm statistics (6)."""
    want = runs["single"][case]
    for r in runs["mesh"]:
        got = r["cases"][case]
        assert (got["epochs_ran"], got["best_epoch"]) == (want["epochs_ran"], want["best_epoch"])
        rtols = HISTORY_RTOL.get(case, DEFAULT_RTOL)
        _histories(got["history"], want["history"], rtols, case)
        np.testing.assert_allclose(got["best_valid_loss"], want["best_valid_loss"],
                                   rtol=rtols[1])
        assert set(got["metrics"]) == set(want["metrics"])
        for key, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], v, rtol=0, atol=METRIC_ATOL,
                                       err_msg=f"{case} {key}")


@pytest.mark.parametrize("case", JAX_CASES)
def test_mesh_run_matches_the_jax_single_device_run(case, runs):
    want = runs["jax"][case]
    for r in runs["mesh"]:
        got = r["cases"][case]
        assert got["epochs_ran"] == want.epochs_ran and got["best_epoch"] == want.best_epoch
        _histories(got["history"], want.history, HISTORY_RTOL.get(case, DEFAULT_RTOL), case)
        for key in ("image_auroc_score", "pixel_auroc_score", "image_prauc_score"):
            np.testing.assert_allclose(got["metrics"][key], want.metrics[key], rtol=0,
                                       atol=METRIC_ATOL, err_msg=f"{case} {key}")


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_replicated_parameters_stay_equal_on_every_rank(case, runs):
    """After training, what is replicated is equal to the bit on all four
    ranks (the same summed gradient, the same Adam update); an MDN head's
    shard is equal on the two data ranks of its model index and holds half
    the components."""
    mesh = runs["mesh"]
    states = [r["cases"][case]["state"] for r in mesh]
    for part in states[0]:
        sharded = part in ("head", "heads") and case.startswith("mdn")
        for r, state in zip(mesh[1:], states[1:]):
            if sharded and r["model"] != mesh[0]["model"]:
                continue
            for name, v in states[0][part].items():
                assert np.array_equal(state[part][name], v), (case, part, name, r["data"],
                                                              r["model"])
    if case.startswith("mdn"):
        single = runs["single"][case]["state"]
        part = "heads" if "resnet" in case else "head"
        for name, v in single[part].items():
            if name.endswith("pi.weight"):
                assert states[0][part][name].shape[0] * 2 == v.shape[0], name
    assert [r["primary"] for r in mesh] == [True, False, False, False]


def test_kmeans_seeding_runs_once_on_the_primary(runs):
    """A k-means-seeded MDN head: the primary alone runs k-means, on the
    features gathered from every data rank, and broadcasts the head, so the
    mesh run starts where one process starts (held in
    `test_mesh_run_matches_the_single_process_run[mdn_kmeans]`); the heads
    without k-means run none."""
    assert runs["single"]["mdn_kmeans"]["kmeans_runs"] == 1
    assert [r["cases"]["mdn_kmeans"]["kmeans_runs"] for r in runs["mesh"]] == [1, 0, 0, 0]
    for case in ("mdn", "nf"):
        assert [r["cases"][case]["kmeans_runs"] for r in runs["mesh"]] == [0] * 4


def _scores(path):
    with open(path) as f:
        return {row[0]: float(row[1]) for row in list(csv.reader(f))[1:]}


def test_cli_mesh_runs_match_and_only_the_primary_writes(runs, category):
    """`--mesh` through the CLIs on two ranks of an explicit cluster: the
    histories and metrics of ae_cnn recon on 2x1 and the MDN on 1x2 against
    the same commands in one process; the MDN file the mesh run wrote is
    the full layout (strict load of a K=4 head) and `cli.score --mesh 2`
    (each rank 4 rows of a batch of 8) scores it as one process does; rank 1
    opened no file for writing."""
    import json

    root, single_root = runs["cli_root"], runs["single_root"]
    assert [r["rc"] for r in runs["cli"]] == [[0, 0, 0]] * 2
    assert runs["cli"][1]["writes"] == []
    wrote = set(runs["cli"][0]["writes"])
    assert {"recon/history.json", "mdn/history.json", "scores/scores.csv",
            "scores/summary.json"} <= wrote
    for name, rtols in (("recon", HISTORY_RTOL["recon"]), ("mdn", DEFAULT_RTOL)):
        got = json.load(open(f"{root}/{name}/history.json"))
        want = json.load(open(f"{single_root}/{name}/history.json"))
        _histories(got, want, rtols, name)
        for key, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], v, rtol=0, atol=METRIC_ATOL,
                                       err_msg=f"{name} {key}")
    pth = glob.glob(f"{root}/mdn/4_gaussians_enc_deit_*.pth")[0]
    head = GaussianMDN(ranks.D, 4)
    head.load_state_dict(torch.load(pth), strict=True)
    single_pth = glob.glob(f"{single_root}/mdn/4_gaussians_enc_deit_*.pth")[0]
    for name, v in torch.load(single_pth).items():
        np.testing.assert_allclose(head.state_dict()[name].numpy(), v.numpy(), rtol=0,
                                   atol=1e-3 * float(v.abs().max()), err_msg=name)
    out = os.path.join(single_root, "scores_of_mesh_pth")
    mp = pytest.MonkeyPatch()
    pil_decode(mp)
    mp.setitem(registry._BUILDERS, "enc_deit", ranks.tiny_vit)
    try:
        assert score_cli.main(["--pth", pth, "-a", "mdn", "-m", "enc_deit", "-d",
                               os.path.join(category, "test"), "-b", "8", "-i", str(IMG),
                               "--device", "cpu", "-o", out]) == 0
    finally:
        mp.undo()
    got, want = _scores(f"{root}/scores/scores.csv"), _scores(f"{out}/scores.csv")
    assert list(got) == list(want) and len(got) == 12
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-5)
