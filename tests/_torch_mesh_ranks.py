"""Ranks of the port's mesh tests (tests/test_torch_parallel.py,
tests/test_torch_mesh_training.py): spawned processes, each a rank of a gloo
cluster that meets through a file under the test's tmp_path (never a fixed
port: six xdist workers run at once). Each rank runs one body and pickles
what it returns (or its traceback) for the test process, which can do other
work meanwhile. This module imports no JAX, so a rank starts quickly."""

from __future__ import annotations

import multiprocessing
import os
import pickle
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

IMG, PATCH, D, DEPTH, HEADS = 32, 8, 32, 2, 4  # the tiny ViT of tests/test_torch_vit.py


def _rank_main(body: Callable, rank: int, world: int, init: str, out: str, args: tuple,
               env: Dict[str, str]) -> None:
    import torch.distributed as dist

    os.environ.update(env)
    torch.set_num_threads(1)
    try:
        if "VITAD_COORDINATOR" not in env:
            dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        result = ("ok", body(rank, world, *args))
    except BaseException:  # noqa: BLE001 — the test process reports it
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)


class Ranks:
    """`world` spawned ranks running `body(rank, world, *args)`. With `env`
    given per rank (the `VITAD_*` contract) the body joins the cluster itself;
    else the ranks meet through a file under `tmp`."""

    def __init__(self, body: Callable, world: int, tmp: str, *args: Any,
                 envs: Optional[List[Dict[str, str]]] = None) -> None:
        os.makedirs(tmp, exist_ok=True)
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        self.outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(body, r, world, init, self.outs[r], args,
                                        (envs or [{}] * world)[r]))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, timeout: float = 600.0) -> List[Any]:
        end = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(1.0, end - time.monotonic()))
        alive = [p for p in self.procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        if alive:
            raise TimeoutError(f"{len(alive)} ranks still ran after {timeout} s")
        out = []
        for r, path in enumerate(self.outs):
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited with code {self.procs[r].exitcode} "
                                   "and no result")
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            out.append(value)
        return out


def tiny_vit(img_size=IMG, dtypes=None, generator=None, **_):
    """The tiny f32 ViT of the port's tests (the registry's signature)."""
    from vit_ad_tpu_torch.config import DtypePolicy
    from vit_ad_tpu_torch.models.vit import ViTEncoder

    return ViTEncoder(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
                      num_heads=HEADS, num_prefix_tokens=2, dtypes=DtypePolicy.f32(),
                      generator=generator)


def numpy_state(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


# ---- tests/test_torch_parallel.py -------------------------------------------

def mdn_case(mc, k: int, dm: int, batch: int, patches: int,
             torch_gather: bool = False, x_dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """A sharded GaussianMDN (seeded, K components of width dm) on the mesh
    against the unsharded head on the same seeded inputs, Gumbel noise on:
    log-likelihoods, loss and every gradient (the shards' gathered to the
    full layout, the data ranks' summed; dx as f32 numbers). `torch_gather`:
    the merge gathers with torch's autograd all-gather, whose backward sums
    the model ranks' upstream gradients (a mutation). `x_dtype`: the dtype of
    x (bf16: the ResNet stage tokens)."""
    from vit_ad_tpu_torch.config import DtypePolicy
    from vit_ad_tpu_torch.models.mdn import GaussianMDN
    from vit_ad_tpu_torch.parallel.sharding import gather_mdn_state

    def head():
        return GaussianMDN(dm, k, dtypes=DtypePolicy.f32(),
                           generator=torch.Generator().manual_seed(3))

    x = torch.from_numpy(np.random.default_rng(4).normal(size=(batch, patches, dm))
                         .astype(np.float32)).to(x_dtype)
    full = head()
    xf = x.clone().requires_grad_(True)
    ll = full.log_likelihood(xf, torch.Generator().manual_seed(5))
    (-ll.mean()).backward()
    shard = mc.shard_params(head())
    if torch_gather:
        from torch.distributed.nn.functional import all_gather

        mc.gather_own_grad = lambda t, axis="model": torch.stack(
            all_gather(t, group=mc.mesh.host_axes[axis]))
    rows = mc.rows(batch // mc.data_size)
    xs = x[rows].clone().requires_grad_(True)
    lls = shard.log_likelihood(xs, torch.Generator().manual_seed(5))
    count = mc.data_sum(torch.tensor(float(lls.numel())))
    loss_part = -lls.sum() / count
    loss_part.backward()
    mc.sum_gradients(shard.parameters())
    grads = GaussianMDN(dm, k // mc.model_size, dtypes=DtypePolicy.f32())
    with torch.no_grad():
        for name, p in shard.named_parameters():
            grads.get_parameter(name).copy_(p.grad)
    grads.place(mc, shard.components, k)
    return {"ll": lls.detach().numpy(), "ll_ref": ll.detach()[rows].numpy(),
            "loss": float(mc.data_sum(loss_part.detach())), "loss_ref": float(-ll.mean()),
            "grads": {n: v.numpy() for n, v in gather_mdn_state(grads).items()},
            "grads_ref": {n: p.grad.numpy() for n, p in full.named_parameters()},
            "dx": torch.cat(mc.gather_rows(xs.grad.float())).numpy(),
            "dx_ref": xf.grad.float().numpy(),
            "components": (shard.components.start, shard.components.stop),
            "num_gaussians": shard.num_gaussians}


def batch_norm_case(mc) -> Dict[str, Any]:
    """FusedBatchNorm in training on a data-sharded batch against the whole
    batch: output, input and parameter gradients, running statistics."""
    from vit_ad_tpu_torch.models.layers import FusedBatchNorm

    rng = np.random.default_rng(6)
    x = torch.from_numpy((rng.normal(size=(8, 5, 6, 6)) * 3 + 1).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 5, 6, 6)).astype(np.float32))

    def bn():
        m = FusedBatchNorm(5)
        with torch.no_grad():
            m.weight.copy_(torch.linspace(0.5, 1.5, 5))
            m.bias.copy_(torch.linspace(-1, 1, 5))
        return m

    ref, placed = bn(), mc.shard_params(bn())
    xa = x.clone().requires_grad_(True)
    y = ref(xa)
    (y * w).sum().backward()
    rows = mc.rows(8 // mc.data_size)
    xb = x[rows].clone().requires_grad_(True)
    yb = placed(xb)
    (yb * w[rows]).sum().backward()
    mc.sum_gradients(placed.parameters())
    return {"y": yb.detach().numpy(), "y_ref": y.detach()[rows].numpy(),
            "dx": xb.grad.numpy(), "dx_ref": xa.grad[rows].numpy(),
            "dw": placed.weight.grad.numpy(), "dw_ref": ref.weight.grad.numpy(),
            "db": placed.bias.grad.numpy(), "db_ref": ref.bias.grad.numpy(),
            "stats": numpy_state(placed), "stats_ref": numpy_state(ref)}


def parallel_world2(rank: int, world: int) -> Dict[str, Any]:
    """1x2: the sharded head (and the torch all-gather mutation), host
    snapshots; 2x1: the BatchNorm, fetch_global."""
    from vit_ad_tpu_torch.config import HyperParams, MeshConfig
    from vit_ad_tpu_torch.models.mdn import GaussianMDN
    from vit_ad_tpu_torch.parallel.context import MeshContext
    from vit_ad_tpu_torch.parallel.multihost import fetch_global, host_snapshot, is_primary

    ctx = lambda d, m: MeshContext.from_hp(HyperParams(mesh=MeshConfig(d, m)), devices="cpu")
    out: Dict[str, Any] = {"primary": is_primary()}
    m12, m21 = ctx(1, 2), ctx(2, 1)
    out["backend"] = m12.mesh.backend
    out["mdn_1x2"] = mdn_case(m12, 8, 64, 4, 3)
    out["mdn_1x2_torch_gather"] = mdn_case(ctx(1, 2), 8, 64, 4, 3, torch_gather=True)
    out["mdn_1x2_bf16"] = mdn_case(m12, 8, 64, 4, 3, x_dtype=torch.bfloat16)
    heads = torch.nn.ModuleList(GaussianMDN(64, k, generator=torch.Generator().manual_seed(k))
                                for k in (4, 6))
    out["snapshot_ref"] = numpy_state(heads)
    placed = m12.shard_params(heads)
    out["shard_shapes"] = {k: tuple(v.shape) for k, v in placed.state_dict().items()}
    out["snapshot"] = {k: v.numpy() for k, v in host_snapshot(placed).items()}
    out["bn_2x1"] = batch_norm_case(m21)
    local = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 100 * m21.data_index
    out["fetched"] = fetch_global(local, m21)
    out["rows"] = (m21.rows(3).start, m21.rows(3).stop)
    return out


def parallel_world4(rank: int, world: int) -> Dict[str, Any]:
    """2x2: the sharded head against the unsharded one."""
    from vit_ad_tpu_torch.config import HyperParams, MeshConfig
    from vit_ad_tpu_torch.parallel.context import MeshContext

    mc = MeshContext.from_hp(HyperParams(mesh=MeshConfig(2, 2)), devices="cpu")
    return {"mdn_2x2": mdn_case(mc, 8, 64, 4, 3),
            "index": (mc.data_index, mc.model_index)}


# ---- tests/test_torch_mesh_training.py --------------------------------------

# The configurations of tests/test_mesh_training.py (img 32, the tiny ViT,
# K=8, batch 8: the last batch of 19 training images is padded), and the
# ResNet trainers at 32 px with the learning rate of tests/test_torch_resnet.py.
# "_noiseless": the mixture weights ignore their noise (the JAX comparison);
# "mdn_kmeans": the mu bias seeded by k-means of the gathered features.
BATCH = 8
_RESNET_MDN = dict(architecture="mdn", num_gaussians=4, epochs=2, patience=2,
                   learning_rate=2e-4)
CASES = {
    "mdn": dict(architecture="mdn", num_gaussians=8),
    "mdn_noiseless": dict(architecture="mdn", num_gaussians=8),
    "mdn_kmeans": dict(architecture="mdn", num_gaussians=8, kmeans_init=True),
    "nf": dict(architecture="nf", hidden_ratio=1.0, flow_steps=2),
    "recon": dict(architecture="reconstruction", model_name="ae_cnn", epochs=3, patience=3),
    "vae": dict(architecture="reconstruction", epochs=3, patience=3),
    "mdn_resnet": _RESNET_MDN,
    "mdn_resnet_noiseless": _RESNET_MDN,
    "nf_resnet": dict(architecture="nf", hidden_ratio=0.16, flow_steps=2, epochs=2,
                      patience=2, learning_rate=2e-4),
}


def case_hp(case: str, mesh=None):
    from vit_ad_tpu_torch.config import DtypePolicy, HyperParams, MeshConfig

    kw = dict(epochs=4, patience=4, learning_rate=1e-3, weight_decay=1e-5, batch_size=BATCH,
              img_size=IMG, seed=24, dtypes=DtypePolicy.f32())
    kw.update(CASES[case])
    return HyperParams(**kw, mesh=mesh or MeshConfig())


def run_case(case: str, category: str, inits: str, mesh=None) -> Dict[str, Any]:
    """One trainer case on the CPU (a rank of `mesh`, or one process): the
    history, metrics and stop epochs, the state of what trains (a shard's
    for the MDN heads) and the number of k-means runs. `inits` holds the
    JAX trainers' inits (torch state dicts) of the tiny ViT, the MDN and NF
    heads, ae_cnn, the VAE, the ResNet-50 trunk and its stage heads, and the
    ε of the JAX VAE trainer's steps in order (`vae_eps.npy`)."""
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.models import autoencoder
    from vit_ad_tpu_torch.models.mdn import GaussianMDN
    from vit_ad_tpu_torch.models.resnet import STAGE_CHANNELS, ResNetEncoder
    from vit_ad_tpu_torch.models.vae import VariationalAutoEncoder
    from vit_ad_tpu_torch.pipeline import cluster_init
    from vit_ad_tpu_torch.pipeline import train as T

    hp = case_hp(case, mesh)
    data = DataPipeline(BATCH, IMG, base_path=category, data_path="train/good")
    test = DataPipeline(BATCH, IMG, base_path=category, data_path="test", validation_mode=True)
    load = lambda name: torch.load(os.path.join(inits, f"{name}.pt"))

    def encoder():
        enc = tiny_vit()
        enc.load_state_dict(load("encoder"), strict=True)
        return enc

    def loaded(cls, name):
        def make(*args, **kw):
            module = cls(*args, **kw)
            module.load_state_dict(load(name), strict=True)
            return module
        return make

    def loaded_by_width(cls, name, width):
        # the stage heads, told apart by their width
        def make(*args, **kw):
            module = cls(*args, **kw)
            module.load_state_dict(load(name)[STAGE_CHANNELS.index(width(*args, **kw))],
                                   strict=True)
            return module
        return make

    def resnet():
        enc = ResNetEncoder(IMG, hp.dtypes)
        enc.load_state_dict(load("resnet"), strict=True)
        return enc

    def vae_noise(vae_loss):
        # the JAX trainer's ε of each step, this rank's rows
        eps = iter(torch.from_numpy(np.load(os.path.join(inits, "vae_eps.npy"))))

        def loss(model, images_u8, valid, mean, std, generator=None, eps_=None, mc=None):
            e = next(eps)
            return vae_loss(model, images_u8, valid, mean, std, None,
                            e if mc is None else e[mc.rows(images_u8.shape[0])], mc)
        return loss

    kmeans_runs = []
    saved = (T.GaussianMDN, T.NormalizingFlow, GaussianMDN.log_pi, T.vae_loss,
             cluster_init.kmeans_cluster_centers)
    cluster_init.kmeans_cluster_centers = lambda *a, **kw: kmeans_runs.append(1) or saved[4](
        *a, **kw)
    if case.endswith("_noiseless"):
        # both trainers' random streams differ: the JAX comparison is on the
        # noiseless path
        GaussianMDN.log_pi = lambda self, x, generator=None, tau=1.0: saved[2](self, x, None,
                                                                               tau)
    try:
        if case in ("mdn", "mdn_noiseless", "mdn_kmeans"):
            T.GaussianMDN = loaded(GaussianMDN, "mdn")
            r = T.train_mdn(hp, data, test, encoder=encoder(), device="cpu")
            trained = {"head": r.head}
        elif case == "nf":
            T.NormalizingFlow = loaded(T.NormalizingFlow, "flow")
            r = T.train_nf(hp, data, test, encoder=encoder(), device="cpu")
            trained = {"head": r.head}
        elif case == "recon":
            model = autoencoder.VanillaAutoEncoder(IMG, hp.dtypes)
            model.load_state_dict(load("ae_cnn"), strict=True)
            r = T.train_recon(hp, data, test, model=model, device="cpu")
            trained = {"head": r.head}
        elif case == "vae":
            T.vae_loss = vae_noise(saved[3])
            r = T.train_vae(hp, data, test, model=loaded(VariationalAutoEncoder, "vae")(
                IMG, dtypes=hp.dtypes), device="cpu")
            trained = {"head": r.head}
        elif case.startswith("mdn_resnet"):
            T.GaussianMDN = loaded_by_width(GaussianMDN, "mdn_resnet",
                                            lambda features, *a, **kw: features)
            r = T.train_mdn_resnet(hp, data, test, encoder=resnet(), device="cpu")
            trained = {"heads": r.head, "norms": r.encoder.norms}
        else:
            T.NormalizingFlow = loaded_by_width(T.NormalizingFlow, "nf_resnet",
                                                lambda num_channels, **kw: num_channels)
            r = T.train_nf_resnet(hp, data, test, encoder=resnet(), device="cpu")
            trained = {"flows": r.head, "norms": r.encoder.norms}
    finally:
        (T.GaussianMDN, T.NormalizingFlow, GaussianMDN.log_pi, T.vae_loss,
         cluster_init.kmeans_cluster_centers) = saved
    return {"history": {k: r.history[k] for k in ("train_loss", "valid_loss")},
            "metrics": r.metrics, "epochs_ran": r.epochs_ran, "best_epoch": r.best_epoch,
            "best_valid_loss": r.best_valid_loss, "kmeans_runs": len(kmeans_runs),
            "state": {k: numpy_state(m) for k, m in trained.items()}}


def training_world4(rank: int, world: int, category: str, inits: str) -> Dict[str, Any]:
    """Every case on the 2x2 mesh; this rank's place in it."""
    from vit_ad_tpu_torch.config import MeshConfig
    from vit_ad_tpu_torch.parallel.multihost import is_primary

    out = {case: run_case(case, category, inits, MeshConfig(2, 2)) for case in CASES}
    return {"cases": out, "data": rank // 2, "model": rank % 2, "primary": is_primary()}


# the learning rate of the recon CLI runs: the recon trainer's parity setting
# (tests/test_torch_recon_train.py `_ae_cnn_run`); at the CLI's 1e-3 the
# ae_cnn validation loss rises in the second epoch, and two summation orders
# part by 1.4e-2 there
CLI_RECON_LR = "3e-4"


def cli_world2(rank: int, world: int, category: str, root: str) -> Dict[str, Any]:
    """Two ranks of an explicit cluster (the `VITAD_*` variables) run the
    CLIs with --mesh: ae_cnn recon on 2x1, the tiny DeiT MDN on 1x2, then
    `cli.score --mesh 2` on the MDN file. Returns the files this rank opened
    for writing under `root`."""
    import builtins
    import glob

    from vit_ad_tpu_torch import registry
    from vit_ad_tpu_torch.cli import score, train_mdn, train_recon

    registry._BUILDERS["enc_deit"] = tiny_vit
    writes: List[str] = []
    real_open = builtins.open

    def spy(file, mode="r", *args, **kw):
        if any(c in mode for c in "wax+") and str(file).startswith(root):
            writes.append(os.path.relpath(str(file), root))
        return real_open(file, mode, *args, **kw)

    builtins.open = spy
    try:
        common = ["-d", category, "-t", "train/good", "-v", "test", "-e", "2", "-p", "2",
                  "-b", str(BATCH), "-i", str(IMG), "--device", "cpu"]
        rc = [train_recon.main(["-m", "ae_cnn", "-l", CLI_RECON_LR, *common,
                                "--out", f"{root}/recon", "--mesh", "2x1"]),
              train_mdn.main(["-m", "deit", "-n", "4", *common, "--out", f"{root}/mdn",
                              "--mesh", "1x2"])]
        pth = glob.glob(f"{root}/mdn/4_gaussians_enc_deit_*.pth")[0]
        rc.append(score.main(["--pth", pth, "-a", "mdn", "-m", "enc_deit", "-d",
                              os.path.join(category, "test"), "-b", "8", "-i", str(IMG),
                              "--device", "cpu", "--mesh", "2", "-o", f"{root}/scores"]))
    finally:
        builtins.open = real_open
    return {"rc": rc, "writes": writes}
