"""The port's mesh layer (`vit_ad_tpu_torch/parallel/`) on the CPU: the mesh
configuration against the JAX package's, the mesh's checks and rank layout,
the backend rule, the cluster contract, the K-shard layout of the MDN heads,
and, on spawned gloo ranks (tests/_torch_mesh_ranks.py), a sharded head
against the unsharded one (1x2 and 2x2, Gumbel noise on), a BatchNorm's
global statistics (2x1), `host_snapshot` and `fetch_global`; and the primary
gating of a run's writes."""

import os

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from vit_ad_tpu.config import MeshConfig as JaxMeshConfig
from vit_ad_tpu_torch.cli import common
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams, MeshConfig
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.parallel import launch, mesh as port_mesh, multihost
from vit_ad_tpu_torch.parallel.sharding import (
    MODEL_ROWS,
    MODEL_STRIDED,
    REPLICATED,
    components,
    param_shardings,
    shard_state,
    unshard_state,
)

# The sharded head against the unsharded one: f32 sums in other orders (the
# softmax from a max and a sum over two ranks, the logsumexp merge, the data
# ranks' gradient sums), relative to each tensor's largest entry.
RTOL = 1e-5


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=what)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return ranks.Ranks(ranks.parallel_world2, 2, str(tmp_path_factory.mktemp("world2")))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return ranks.Ranks(ranks.parallel_world4, 4, str(tmp_path_factory.mktemp("world4")))


@pytest.fixture(scope="module")
def results2(world2):
    return world2.results()


@pytest.fixture(scope="module")
def results4(world4):
    return world4.results()


@pytest.mark.parametrize("spec", ["4x2", "1x2", "2X1", " 8 ", "auto", "all", "1", "1x1"])
def test_mesh_config_parse_matches_jax(spec):
    got, want = MeshConfig.parse(spec), JaxMeshConfig.parse(spec)
    assert (got.data, got.model, tuple(got.axis_names)) == \
        (want.data, want.model, tuple(want.axis_names))
    assert got.requested == want.requested


def test_create_mesh_checks_and_layout():
    """The JAX checks and messages (`vit_ad_tpu/parallel/mesh.py:24-40`); rank
    r at (r // M, r % M), the JAX mesh's row-major reshape of its devices."""
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        port_mesh.create_mesh(2, 1, devices="cpu")
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        port_mesh.create_mesh(-1, 2, devices="cpu")
    with pytest.raises(ValueError, match="2 devices for 1 ranks"):
        port_mesh.create_mesh(1, 1, devices=["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="VITAD_COORDINATOR"):
        port_mesh.create_mesh(1, 1, devices="cpu")
    layout = port_mesh.rank_layout(4, 2)
    assert layout.tolist() == np.asarray(range(8)).reshape(4, 2).tolist()
    assert [(r // 2, r % 2) for r in range(8)] == \
        [tuple(int(i) for i in np.argwhere(layout == r)[0]) for r in range(8)]


@pytest.mark.parametrize("ids,backend", [
    (["GPU-a", "GPU-b"], "nccl"), (["GPU-a", "GPU-a"], "gloo"), (["cpu", "cpu"], "gloo"),
    (["GPU-a", "cpu"], "gloo")])
def test_backend_rule(ids, backend, monkeypatch):
    """NCCL only when every rank has a card of its own (NCCL refuses two ranks
    on one card); decided from the ranks' card UUIDs, not by trying."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: len(ids))
    monkeypatch.setattr(dist, "all_gather_object",
                        lambda out, obj, group=None: out.__setitem__(slice(None), ids))
    assert port_mesh.device_backend(torch.device("cpu"), None)[0] == backend


def test_cluster_contract(monkeypatch):
    """The JAX package's environment contract (`parallel/multihost.py:50-90`):
    all three variables or an exit naming them; TPU-pod auto-detection is
    refused by name; no variable, no cluster."""
    for var in (*multihost.CLUSTER_VARIABLES, "VITAD_MULTIHOST"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.maybe_initialize_distributed() is False
    assert not multihost.in_cluster() and multihost.is_primary()
    monkeypatch.setenv("VITAD_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(SystemExit, match="all three are required"):
        multihost.maybe_initialize_distributed()
    monkeypatch.delenv("VITAD_COORDINATOR")
    monkeypatch.setenv("VITAD_MULTIHOST", "1")
    with pytest.raises(SystemExit, match="VITAD_COORDINATOR, VITAD_NUM_PROCESSES, "
                                         "VITAD_PROCESS_ID"):
        multihost.maybe_initialize_distributed()


@pytest.mark.parametrize("spec,cards,match", [
    ("2x1", 1, r"--mesh 2x1 needs 2 cards, one a rank; torch.cuda.device_count\(\) is 1"),
    ("1x2", 0, r"--mesh 1x2 needs 2 cards"),
    ("auto", 0, r"needs 1 cards.*device_count\(\) is 0")])
def test_launcher_refuses_too_few_cards(spec, cards, match, monkeypatch):
    """A bare `--mesh` spawns one process a card and refuses, before spawning,
    when the cards are too few (the count in the message)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(SystemExit, match=match):
        launch.mesh_size(MeshConfig.parse(spec), on_card=True)


def test_launcher_sizes():
    assert launch.mesh_size(MeshConfig(2, 2), on_card=False) == 4
    with pytest.raises(SystemExit, match="on the CPU give its sizes"):
        launch.mesh_size(MeshConfig.parse("auto"), on_card=False)


def _head(k=6, d=64, seed=0):
    return GaussianMDN(d, k, dtypes=DtypePolicy.f32(), generator=torch.Generator().manual_seed(seed))


def test_k_shard_layout_round_trips_byte_for_byte():
    """Scatter then gather of a seeded head's state dict is the input, byte
    for byte; a shard holds the rows e*K + k of its components, re-laid out
    as a K/M head's, and loads strictly into one."""
    head = _head()
    state = head.state_dict()
    k, m = 6, 3
    parts = [shard_state(state, k, components(k, m, i)) for i in range(m)]
    back = unshard_state(parts, k)
    assert set(back) == set(state)
    for name, t in state.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t), name
    d = 64
    w = state["sigma.weight"]
    for i, part in enumerate(parts):
        comps = list(range(i * 2, i * 2 + 2))
        rows = [e * k + c for e in range(d) for c in comps]
        assert torch.equal(part["sigma.weight"], w[rows])
        assert torch.equal(part["mu.bias"], state["mu.bias"][rows])
        assert torch.equal(part["pi.weight"], state["pi.weight"][comps])
        small = GaussianMDN(d, 2, dtypes=DtypePolicy.f32())
        small.load_state_dict(part, strict=True)


def test_k_that_the_model_axis_does_not_divide_is_refused():
    """As in the JAX package, whose sharding of a K=5 head over two model
    devices raises "should be divisible by 2, but it is equal to 5"."""
    with pytest.raises(ValueError, match="should be divisible by 2, but it is equal to 5"):
        components(5, 2, 0)
    assert components(150, 2, 1) == slice(75, 150)


def test_param_shardings_rules():
    """The MDN heads' components over "model"; the trunk (and everything
    else) replicated: its tensor-parallel rules are not applied."""
    from _torch_mesh_ranks import tiny_vit

    module = torch.nn.ModuleDict({"trunk": tiny_vit(), "heads": torch.nn.ModuleList([_head()])})
    specs = param_shardings(module)
    assert specs["heads.0.pi.weight"] == specs["heads.0.pi.bias"] == MODEL_ROWS
    assert specs["heads.0.sigma.weight"] == specs["heads.0.mu.bias"] == MODEL_STRIDED
    trunk = [v for k, v in specs.items() if k.startswith("trunk.")]
    assert trunk and set(trunk) == {REPLICATED}
    assert any("qkv" in k for k in specs) and any("fc1" in k for k in specs)


@pytest.mark.parametrize("case", ["mdn_1x2", "mdn_2x2"])
def test_sharded_mdn_matches_the_unsharded_head(case, results2, results4):
    """Log-likelihood, loss and the gradient of every parameter and of x
    within RTOL of the unsharded head, Gumbel noise on: the global draw (trap
    2), the strided K-shard (3), the global softmax (4) and the own-slice
    merge with the summed dx (5)."""
    rs = results2 if case == "mdn_1x2" else results4
    for rank, r in enumerate(rs):
        c = r[case]
        assert c["num_gaussians"] == 4
        _close(c["ll"], c["ll_ref"], f"rank {rank} ll")
        np.testing.assert_allclose(c["loss"], c["loss_ref"], rtol=RTOL)
        for name, g in c["grads_ref"].items():
            _close(c["grads"][name], g, f"rank {rank} d{name}")
        _close(c["dx"], c["dx_ref"], f"rank {rank} dx")
    assert sorted(r["index"] for r in results4) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [tuple(r[case]["components"]) for r in rs] == [(0, 4), (4, 8)] * (len(rs) // 2)


def test_torch_all_gather_would_scale_the_gradients(results2):
    """The same case with torch's autograd all-gather in the merge: its
    backward sums the two model ranks' identical upstream gradients, so the
    head's gradients come out twice too large; the forward is the same."""
    c = results2[0]["mdn_1x2_torch_gather"]
    _close(c["ll"], c["ll_ref"], "ll")
    for name in ("sigma.weight", "mu.weight"):
        ratio = np.abs(c["grads"][name]).max() / np.abs(c["grads_ref"][name]).max()
        assert abs(ratio - 2.0) < 1e-3, (name, ratio)
    with pytest.raises(AssertionError):
        _close(c["grads"]["mu.weight"], c["grads_ref"]["mu.weight"], "mu.weight")


def test_sharded_head_sums_the_f32_dx_before_the_bf16_cast(results2):
    """A bf16 x (the ResNet stage tokens, whose norms train): the shards'
    f32 dx are summed over the model axis, and cast to bf16 once, as one
    process sums its components' dx before the cast. The bf16 dx then equal
    the unsharded head's but at rounding ties. Summing the shards'
    bf16-rounded partials instead moves a large share of them by an ulp."""
    for r in results2:
        c = r["mdn_1x2_bf16"]
        differ = float(np.mean(c["dx"] != c["dx_ref"]))
        assert differ < 0.01, differ
        _close(c["ll"], c["ll_ref"], "ll")


def test_host_snapshot_copies_on_the_cpu():
    """The snapshot of a CPU module is a copy: a later step leaves it as it
    was taken."""
    m = torch.nn.Linear(3, 2)
    snap = multihost.host_snapshot(m)
    before = snap["weight"].clone()
    with torch.no_grad():
        m.weight.add_(1.0)
    assert torch.equal(snap["weight"], before)


def test_batch_norm_takes_global_statistics(results2):
    """2x1: output, gradients and running statistics of the whole batch (the
    JAX guard is tests/test_mesh_training.py:101-117); the running
    statistics are the same on both ranks and count one step."""
    for r in results2:
        c = r["bn_2x1"]
        for key in ("y", "dx", "dw", "db"):
            _close(c[key], c[f"{key}_ref"], key)
        for name, v in c["stats_ref"].items():
            _close(c["stats"][name], v, name)
        assert int(c["stats"]["num_batches_tracked"]) == 1
    a, b = (r["bn_2x1"]["stats"] for r in results2)
    assert all(np.array_equal(a[n], b[n]) for n in a)


def test_host_snapshot_and_fetch_global(results2):
    """`host_snapshot` of two K-sharded heads is the full state dict, byte for
    byte, on both ranks; `fetch_global` gives every rank the data ranks'
    rows in order; one primary; gloo between CPU ranks."""
    for r in results2:
        assert set(r["snapshot"]) == set(r["snapshot_ref"])
        for name, v in r["snapshot_ref"].items():
            assert r["shard_shapes"][name][0] * 2 == v.shape[0], name  # a rank held half
            assert np.array_equal(r["snapshot"][name], v), name
        want = np.concatenate([np.arange(6, dtype=np.float32).reshape(3, 2) + 100 * d
                               for d in range(2)])
        assert np.array_equal(r["fetched"], want)
        assert r["backend"] == "gloo"
    assert [r["primary"] for r in results2] == [True, False]
    assert [r["rows"] for r in results2] == [(0, 3), (3, 6)]


def test_checkpoint_writes_are_primary_gated(tmp_path, monkeypatch):
    """The port's counterpart of tests/test_multihost.py:121-136: every rank
    trains and gathers the checkpoints; a rank that is not the primary
    writes nothing (no run directory, no checkpoint), the primary writes
    them."""
    from types import SimpleNamespace

    calls = []

    def trainer(hp, data, test, **kw):
        calls.append(kw["log"])
        return SimpleNamespace(head=torch.nn.Linear(2, 2), history={"train_loss": [1.0]},
                               metrics={}, epochs_ran=1, best_epoch=0, best_valid_loss=1.0)

    monkeypatch.setattr(common, "build_pipelines", lambda *a: (None, None))
    monkeypatch.setattr("vit_ad_tpu_torch.pipeline.train.default_encoder", lambda hp: None)
    hp = HyperParams(model_name="enc_cnn", architecture="nf", data_class="cat")
    parsed = (hp, "data", "train/good", "test", "cpu", str(tmp_path / "run"))
    monkeypatch.setattr(common, "is_primary", lambda: False)
    assert common.run_trainer(parsed, trainer, "b", "r", "p") == 0
    assert calls == [None] and not os.path.exists(tmp_path / "run")
    monkeypatch.setattr(common, "is_primary", lambda: True)
    assert common.run_trainer(parsed, trainer, "b", "r", "p") == 0
    assert calls[-1] is not None
    assert sorted(os.listdir(tmp_path / "run")) == sorted(
        ["config.json", "history.json", "loss_curves.png", "metrics.jsonl", "p_cat.pth"])
