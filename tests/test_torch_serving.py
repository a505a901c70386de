"""The port's serving bundle (`vit_ad_tpu_torch/serving/aot.py`,
`cli/export_serving.py`) on the CPU at small size: a bundle of each of the
five kinds scores as the live evaluator; baked weights equal external ones
(a bf16 parameter included); the scores-only payload equals the host tail;
the baked MDN normalizer; the input guards; a serving site that imports no
model code; the gate registry against the wrappers' launches and the ops'
fake implementations; the CLI from `-r` and from `--pth`; and one check
against the JAX package's own bundle."""

import csv
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from test_torch_vit import D, DEPTH, HEADS, IMG, PATCH, jax_encoder, jax_params, jitter
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.cli import export_serving as export_cli
from vit_ad_tpu_torch.cli import score as score_cli
from vit_ad_tpu_torch.cli import train_nf as train_nf_cli
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.data.synthetic import make_mvtec_category
from vit_ad_tpu_torch.models.flow import NormalizingFlow
from vit_ad_tpu_torch.models.layers import bake_compute_weights
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.models.resnet import ResNetEncoder
from vit_ad_tpu_torch.models.vit import ViTEncoder
from vit_ad_tpu_torch.ops import gates
from vit_ad_tpu_torch.ops.cuda import build
from vit_ad_tpu_torch.ops.cuda import gmm as cgmm
from vit_ad_tpu_torch.ops.cuda import layer_norm as cln
from vit_ad_tpu_torch.ops.cuda import mlp as cmlp
from vit_ad_tpu_torch.ops.cuda import window_attention as cwa
from vit_ad_tpu_torch.ops.window_attention import (
    window_attention_core_reference,
    window_attention_reference,
)
from vit_ad_tpu_torch.pipeline.loading import RunModels, score_models
from vit_ad_tpu_torch.pipeline.train import stage_flow
from vit_ad_tpu_torch.scoring import payload_ref_max_ll, payload_to_scores, scores_tail
from vit_ad_tpu_torch.serving import aot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
F32 = DtypePolicy.f32()


def _tiny_deit(img_size=IMG, dtypes=None, generator=None):
    return ViTEncoder(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH, num_heads=HEADS,
                      num_prefix_tokens=2, dtypes=F32, generator=generator)


def _hp(model, arch, **kw):
    return HyperParams(img_size=IMG, batch_size=BATCH, model_name=model, architecture=arch,
                       dtypes=F32, **kw)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serving")
    cat = make_mvtec_category(str(root), "widget", img_size=40, n_train=6, n_test_good=3,
                              n_test_defect=4)
    files = score_cli.list_images(os.path.join(cat, "test"))
    mean, std = default_norm_stats()
    return {"root": root, "cat": cat, "files": files, "images": aot.decode_files(files, IMG),
            "mean": mean, "std": std}


@pytest.fixture(scope="module")
def kinds():
    """RunModels of each kind from seeded weights: the tiny DeiT (through the
    registry) with an NF-2 and a K=2 MDN head, ae_cnn at 32 px, and one
    ResNet-50 at 32 px with two K=2 MDN heads on stage maps 2-3 and three
    NF-2 flows on stage maps 0-2."""
    g = torch.Generator().manual_seed(0)
    mp = pytest.MonkeyPatch()
    mp.setitem(registry._BUILDERS, "enc_deit", _tiny_deit)
    deit = registry.get_model("enc_deit", IMG, F32, generator=g).eval()
    mp.undo()
    resnet = ResNetEncoder(IMG, F32, generator=g).eval()
    hp_nf = _hp("enc_res_net", "nf", flow_steps=2)
    return {
        "nf": RunModels("nf", _hp("enc_deit", "nf"), (
            deit, NormalizingFlow(D, IMG, (IMG // PATCH) ** 2, hidden_ratio=0.5, flow_steps=2,
                                  generator=g).eval())),
        "mdn": RunModels("mdn", _hp("enc_deit", "mdn"),
                         (deit, GaussianMDN(D, 2, dtypes=F32, generator=g).eval())),
        "recon": RunModels("recon", _hp("ae_cnn", "reconstruction"),
                           (registry.get_model("ae_cnn", IMG, F32, generator=g).eval(),)),
        "mdn_resnet": RunModels("mdn_resnet", _hp("enc_res_net", "mdn"), (
            resnet, torch.nn.ModuleList(GaussianMDN(c, 2, dtypes=F32, generator=g)
                                        for c in (1024, 2048)).eval())),
        "nf_resnet": RunModels("nf_resnet", hp_nf, (resnet, torch.nn.ModuleList(
            stage_flow(hp_nf, i, g) for i in (0, 1, 2)).eval())),
    }


def _export(m, data, path, **kw):
    kw.setdefault("batch", BATCH)
    return aot.export_bundle(m, str(path), mean=data["mean"], std=data["std"], **kw)


@pytest.fixture(scope="module")
def exported(kinds, data, tmp_path_factory):
    """`exported(kind, name=kind, **options)` → (bundle dir, manifest, the
    bundle loaded on the CPU): the bundles several tests read, each exported
    and loaded once (portable, batch 4)."""
    root, done = tmp_path_factory.mktemp("torch_serving_bundles"), {}

    def get(kind, name="", **options):
        name = name or kind
        if name not in done:
            man = _export(kinds[kind], data, root / name, **options)
            done[name] = (root / name, man, aot.load_bundle(str(root / name), device="cpu"))
        return done[name]

    return get


@pytest.mark.parametrize("kind", ["nf", "mdn", "recon", "mdn_resnet", "nf_resnet"])
def test_bundle_scores_equal_the_live_evaluator(kinds, data, exported, kind):
    m = kinds[kind]
    live = score_models(m, DataPipeline(BATCH, IMG, files=data["files"]), data["mean"],
                        data["std"])
    path, manifest, bundle = exported(kind)
    assert manifest["kind"] == kind and manifest["portable"] and manifest["kernel_ops"] == 0
    assert manifest["platforms"] == ["cpu"] and manifest["exported_on"] == "cpu"
    assert sorted(os.listdir(path)) == ["manifest.json", "scorer.pt2"]
    scores, maps = bundle.score_files(data["files"])  # 7 images: the tail chunk is padded
    np.testing.assert_array_equal(scores, live.image_scores)
    np.testing.assert_array_equal(maps, live.pixel_scores)
    # the in-graph scores tail equals the host tail on the same payloads
    payload = bundle.payloads(data["images"])
    ref = payload_ref_max_ll(kind, payload) if kind.startswith("mdn") else None
    dev = (tuple(torch.from_numpy(p) for p in payload) if isinstance(payload, tuple)
           else torch.from_numpy(payload))
    np.testing.assert_allclose(scores_tail(kind, IMG, ref)(dev).numpy(),
                               payload_to_scores(kind, payload, IMG, ref_max_ll=ref)[0],
                               rtol=0, atol=1e-6)  # torch's f32 exp against numpy's


def _targets(program):
    return [str(n.target) for gm in program.modules() if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes]


def test_portable_graph_holds_no_kernel_op_and_reads_baked_weights(kinds, data, exported):
    program = exported("nf")[2]._program
    assert aot._ops_in(program) == []
    assert not any(gates.NAMESPACE in t for t in _targets(program))
    # the ResNet's folded BatchNorms and cast convolution weights are buffers
    # of the program, made once at export from a copy of the models (which
    # gain no buffer), and the parameters only they read are left out
    program = exported("mdn_resnet")[2]._program
    baked = [n for n, _ in program.named_buffers() if "._baked_" in n]
    assert len(baked) >= 3 * 53
    assert not any("_baked_" in n for n, _ in kinds["mdn_resnet"].parts[0].named_buffers())
    assert not any(n.endswith("running_var") for n, _ in program.named_buffers())
    rsqrt = [t for t in _targets(program) if "rsqrt" in t]
    assert len(rsqrt) == 2, rsqrt  # the two heads' stage norms only


def test_baked_compute_weights_equal_the_cached_ones():
    """`layers.bake_compute_weights` under the bf16 policy: `get` returns the
    values the cache holds, the casts are non-persistent buffers (the state
    dict is unchanged), a tensor that needs no cast stays the parameter
    itself, and the MDN head's kernel operands are left alone off the card."""
    g = torch.Generator().manual_seed(5)
    enc = ViTEncoder(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH, num_heads=HEADS,
                     num_prefix_tokens=2, dtypes=DtypePolicy(), generator=g).eval()
    mdn = GaussianMDN(D, 2, dtypes=DtypePolicy(), generator=g).eval()
    with torch.no_grad():
        cached = {k: v for k, v in enc.compute_weights().items() if k != "blocks"}
    keys = set(enc.state_dict())
    bake_compute_weights(enc)
    bake_compute_weights(mdn)
    baked = enc.compute_weights()
    assert set(enc.state_dict()) == keys and any("_baked_" in n for n, _ in enc.named_buffers())
    for k, v in cached.items():
        assert torch.equal(baked[k], v) and baked[k].dtype == torch.bfloat16, k
    assert not any("_baked_" in n for n, _ in mdn.named_buffers())
    f32 = _tiny_deit(generator=g)
    bake_compute_weights(f32)
    assert f32.compute_weights()["blocks"][0]["qkv_w"] is f32.blocks[0].attn.qkv.weight


def test_external_weights_equal_baked_with_a_bf16_parameter(data, tmp_path):
    g = torch.Generator().manual_seed(3)
    deit = _tiny_deit(generator=g)
    blk = deit.blocks[0].attn.qkv
    blk.weight = torch.nn.Parameter(blk.weight.detach().to(torch.bfloat16))  # cast per call
    flow = NormalizingFlow(D, IMG, (IMG // PATCH) ** 2, hidden_ratio=0.5, flow_steps=2,
                           generator=g)
    m = RunModels("nf", _hp("enc_deit", "nf"), (deit.eval(), flow.eval()))
    out = {}
    for weights in ("baked", "external"):
        manifest = _export(m, data, tmp_path / weights, weights=weights)
        out[weights] = aot.load_bundle(str(tmp_path / weights), device="cpu").score(
            data["images"])
    assert "bfloat16" in manifest["weight_dtypes"]
    npz = np.load(tmp_path / "external" / aot.WEIGHTS_NAME)
    i = manifest["weight_dtypes"].index("bfloat16")
    assert npz[f"w{i:05d}"].dtype == np.uint16
    assert torch.equal(aot._from_numpy(npz[f"w{i:05d}"], "bfloat16", "cpu"), blk.weight.detach())
    # the external program holds no weight: it is about the size of the graph alone
    assert os.path.getsize(tmp_path / "external" / aot.SCORER_NAME) < \
        os.path.getsize(tmp_path / "baked" / aot.SCORER_NAME)
    for a, b in zip(out["baked"], out["external"]):
        np.testing.assert_array_equal(a, b)
    live = score_models(m, DataPipeline(BATCH, IMG, files=data["files"]), data["mean"],
                        data["std"])
    np.testing.assert_array_equal(out["baked"][0], live.image_scores)


def _mdn_with_ref(exported, data):
    """The MDN bundle with the normalizer of the first 5 images baked in."""
    return exported("mdn", "mdn_ref", ref_images=data["images"][:5])


@pytest.mark.parametrize("kind", ["nf", "mdn"])
def test_scores_payload_equals_the_full_payloads_host_tail(kinds, data, exported, tmp_path,
                                                           kind):
    m, ims = kinds[kind], data["images"]
    ref = ims[:5] if kind == "mdn" else None
    full = _mdn_with_ref(exported, data)[2] if kind == "mdn" else exported("nf")[2]
    man = _export(m, data, tmp_path / "scores", ref_images=ref, payload="scores")
    assert man["payload"] == "scores" and ("ref_max_loglik" in man) == (kind == "mdn")
    s_full, _ = full.score(ims)
    s_only, maps = aot.load_bundle(str(tmp_path / "scores"), device="cpu").score(ims)
    assert maps is None and s_only.shape == (len(ims),)
    np.testing.assert_allclose(s_only, s_full, rtol=0, atol=1e-6)


def test_mdn_baked_normalizer(kinds, data, exported, tmp_path):
    m, ims = kinds["mdn"], data["images"]
    with pytest.raises(ValueError, match="ref_images"):
        _export(m, data, tmp_path / "no_ref", payload="scores")
    _, man, bundle = _mdn_with_ref(exported, data)
    assert man["ref_max_loglik"] == payload_ref_max_ll("mdn", bundle.payloads(ims[:5]))
    s_all, p_all = bundle.score(ims)
    s_one, p_one = bundle.score(ims[2:3])
    # the baked normalizer: an image scores the same alone and in its wave
    np.testing.assert_array_equal(s_one[0], s_all[2])
    np.testing.assert_array_equal(p_one[0], p_all[2])
    # per-call normalization ("call") is the evaluators' own and moves with the wave
    s_call, _ = bundle.score(ims, normalizer="call")
    live = score_models(m, DataPipeline(BATCH, IMG, files=data["files"]), data["mean"],
                        data["std"])
    np.testing.assert_array_equal(s_call, live.image_scores)
    assert not np.array_equal(bundle.score(ims[2:3], normalizer="call")[0][0], s_call[2])
    with pytest.raises(ValueError, match="normalizer"):
        bundle.score(ims, normalizer="max")


def test_input_and_export_guards(kinds, data, exported, tmp_path):
    path, _, bundle = exported("nf")
    shutil.copytree(path, tmp_path, dirs_exist_ok=True)
    with pytest.raises(ValueError, match="expects"):
        bundle.score(np.zeros((2, IMG + 8, IMG + 8, 3), np.uint8))
    with pytest.raises(ValueError, match="expects"):
        bundle.score(np.zeros((2, IMG, IMG, 3), np.float32))
    with pytest.raises(ValueError, match="no images"):
        bundle.score(np.zeros((0, IMG, IMG, 3), np.uint8))
    with pytest.raises(ValueError, match="native bundle"):
        _export(kinds["nf"], data, tmp_path / "n", portable=False)
    with pytest.raises(ValueError, match="platforms"):
        _export(kinds["nf"], data, tmp_path / "p", platforms=["tpu"])
    for bad in (dict(batch=0), dict(weights="inline"), dict(payload="maps")):
        with pytest.raises(ValueError):
            _export(kinds["nf"], data, tmp_path / "b", **bad)
    with pytest.raises(ValueError, match="for \\['cpu'\\]"):
        aot.load_bundle(str(tmp_path), device="cuda")
    if not torch.cuda.is_available():  # a bundle for both, on a host without a card
        man = json.loads((tmp_path / aot.MANIFEST_NAME).read_text())
        (tmp_path / aot.MANIFEST_NAME).write_text(json.dumps({**man,
                                                              "platforms": ["cpu", "cuda"]}))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            aot.load_bundle(str(tmp_path), device="cuda")


def test_serving_site_imports_no_model_code(data, exported, tmp_path):
    """A fresh process serves a portable bundle with torch, numpy and the
    serving module: no jax, no model zoo, no pipeline."""
    path, _, bundle = exported("nf")
    np.save(tmp_path / "ims.npy", data["images"])
    code = (
        "import sys, json, numpy as np\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from vit_ad_tpu_torch.serving.aot import load_bundle\n"
        f"b = load_bundle({str(path)!r}, device='cpu')\n"
        f"s, _ = b.score(np.load({str(tmp_path / 'ims.npy')!r}))\n"
        "mods = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', "
        "'vit_ad_tpu.', 'vit_ad_tpu_torch.models', 'vit_ad_tpu_torch.pipeline', "
        "'vit_ad_tpu_torch.registry'))]\n"
        "print(json.dumps({'scores': s.tolist(), 'mods': mods}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["mods"] == []
    want, _ = bundle.score(data["images"])
    np.testing.assert_array_equal(np.asarray(got["scores"], np.float32), want)


def _launched_entries():
    """Every C entry point of `build.ENTRY_POINTS` that `ops/cuda/*.py` calls."""
    found = set()
    for name in os.listdir(os.path.join(REPO, "vit_ad_tpu_torch", "ops", "cuda")):
        if name.endswith(".py") and name != "build.py":
            with open(os.path.join(REPO, "vit_ad_tpu_torch", "ops", "cuda", name)) as f:
                found |= set(re.findall(r"\.(\w+)\(", f.read())) & set(build.ENTRY_POINTS)
    return found


def test_every_launched_entry_point_has_a_gate():
    launched = _launched_entries()
    gated = {e for g in gates.GATES.values() for e in g.entries}
    assert launched == gated == set(build.ENTRY_POINTS)
    # only the backward kernels have no op: a bundle never holds a backward
    assert {k for k, g in gates.GATES.items() if not g.ops} == {"B3", "B4"}


def _op_cases():
    """(op, inputs, the plain version's output) at kernel-valid small shapes."""
    gen = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(*s, generator=gen).to(dt)  # noqa: E731
    bf = torch.bfloat16
    x, s, b = r(3, 5, 64, dt=bf), r(64), r(64)
    qkv = r(2, 9, 3 * 64, dt=bf)
    win, bias, mask = r(4, 16, 3 * 64, dt=bf), r(2, 16, 16), r(2, 16, 16)
    q, k, v = (r(4, 16, 2, 32, dt=bf) for _ in range(3))
    xm, nw, nb, w1, b1, w2, b2 = r(6, 128, dt=bf), r(128), r(128), r(256, 128, dt=bf), r(256), \
        r(128, 256, dt=bf), r(128)
    a, w, gb = r(4, 128, dt=bf), r(256, 128, dt=bf), r(256)
    rows, d, kk = 10, 64, 3
    gx, glp, ws, bs, wm, bm = r(rows, d), r(rows, kk), r(d * kk, d), r(d * kk), r(d * kk, d), \
        r(d * kk)
    ops = cgmm.kernel_operands(ws, bs, wm, bm, torch.float32)
    return {
        "layer_norm": ((x, s, b, 1e-6), cln.layer_norm_reference(x, s, b)),
        "vit_attention_qkv": ((qkv, 2), cwa.vit_attention_qkv_reference(qkv, 2)),
        "swin_window_attention": ((win, bias, mask, 2),
                                  window_attention_reference(win, bias, mask, 2)),
        "split_window_attention": ((q, k, v, bias, mask),
                                   window_attention_core_reference(q, k, v, bias, mask)),
        "mlp_block": ((xm, nw, nb, w1, b1, w2, b2, 1e-6),
                      cmlp.mlp_block_reference(xm, nw, nb, w1, b1, w2, b2, 1e-6)),
        "mlp_gemm": ((a, w, gb, cmlp.EPILOGUE_GELU, None),
                     torch.nn.functional.gelu(a.float() @ w.float().t() + gb,
                                              approximate="tanh").to(bf)),
        "gmm_forward": ((gx, None, cgmm.component_major(glp), ops["w_mu"], ops["w_sigma"],
                         ops["b_mu_t"], ops["b_sigma_t"]),
                        cgmm.gmm_log_likelihood_reference(gx[None], glp[None], ws, bs, wm,
                                                          bm)[0]),
    }


@pytest.mark.parametrize("op", [op for g in gates.GATES.values() for op in g.ops])
def test_each_op_has_a_fake_that_states_the_plain_versions_output(op):
    import vit_ad_tpu_torch.ops.cuda.library  # noqa: F401  (registers every op)

    args, want = _op_cases()[op]
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) if isinstance(t, torch.Tensor) else t for t in args]
        got = getattr(torch.ops.vit_ad_tpu_torch, op)(*fake)
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype


@pytest.fixture(scope="module")
def trained_run(data, tmp_path_factory):
    """An NF-2 head on the tiny DeiT trained one epoch by `cli.train_nf`, and
    `cli.score -r`'s scores of the test folder."""
    mp = pytest.MonkeyPatch()
    mp.setitem(registry._BUILDERS, "enc_deit", _tiny_deit)
    root = tmp_path_factory.mktemp("torch_serving_run")
    run = str(root / "run")
    assert train_nf_cli.main(["-m", "deit", "-r", "0.5", "-f", "2", "-d", data["cat"], "-t",
                              "train/good", "-v", "test", "-e", "1", "-p", "1", "-b", str(BATCH),
                              "-i", str(IMG), "--device", "cpu", "--out", run]) == 0
    test_dir = os.path.join(data["cat"], "test")
    assert score_cli.main(["-r", run, "-d", test_dir, "-o", str(root / "scores"),
                           "--device", "cpu"]) == 0
    with open(root / "scores" / "scores.csv") as f:
        rows = list(csv.reader(f))[1:]
    yield {"run": run, "test_dir": test_dir, "files": [r[0] for r in rows],
           "scores": np.asarray([float(r[1]) for r in rows], np.float32)}
    mp.undo()


@pytest.mark.parametrize("source", ["run", "pth"])
def test_cli_export_serving_round_trip(trained_run, tmp_path, monkeypatch, source):
    monkeypatch.setitem(registry._BUILDERS, "enc_deit", _tiny_deit)
    run = trained_run["run"]
    if source == "run":
        src = ["-r", run]
    else:
        head = [f for f in os.listdir(run) if f.startswith("nf_") and f.endswith(".pth")]
        src = ["--pth", os.path.join(run, head[0]), "-a", "nf", "--model", "enc_deit",
               "--img-size", str(IMG), "--hidden-ratio", "0.5", "--flow-steps", "2"]
    out = tmp_path / "bundle"
    assert export_cli.main([*src, "-o", str(out), "-b", "3", "--device", "cpu",
                            "--weights", "external"]) == 0
    man = json.loads((out / aot.MANIFEST_NAME).read_text())
    assert man["batch"] == 3 and man["source"] == src[1] and man["weights"] == "external"
    scores, _ = aot.load_bundle(str(out), device="cpu").score_files(trained_run["files"])
    np.testing.assert_array_equal(scores, trained_run["scores"])


def test_cli_export_serving_needs_a_card_unless_told_cpu(trained_run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only on a host without CUDA")
    with pytest.raises(SystemExit, match="--device cpu"):
        export_cli.main(["-r", trained_run["run"], "-o", str(tmp_path / "b")])


def test_portable_nf_bundle_agrees_with_the_jax_bundle(data, tmp_path):
    """The JAX package's portable NF bundle (CPU) and the port's, on the same
    tiny weights (converted) and the same uint8 images, within the NF parity
    tests' tolerance (f32 sums in other orders)."""
    import jax
    import jax.numpy as jnp

    from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
    from vit_ad_tpu.config import HyperParams as JaxHyperParams
    from vit_ad_tpu.models.flow import NormalizingFlow as JaxFlow
    from vit_ad_tpu.pipeline.loading import RunModels as JaxRunModels
    from vit_ad_tpu.serving import aot as jax_aot
    from vit_ad_tpu_torch.utils.convert import nf_state_dict_from_jax, vit_state_dict_from_jax

    enc_params = jax_params(2, seed=11)
    patches = (IMG // PATCH) ** 2
    flow = JaxFlow(num_channels=D, img_size=IMG, num_patches=patches, hidden_ratio=0.16,
                   flow_steps=4, dtypes=JaxDtypePolicy.f32())
    flow_params = jitter(jax.jit(flow.init)(jax.random.key(0), jnp.zeros((1, 4, 4, D))),
                         np.random.default_rng(12), 0.1)
    jm = JaxRunModels(kind="nf", hp=JaxHyperParams(img_size=IMG, batch_size=BATCH,
                                                   dtypes=JaxDtypePolicy.f32()),
                      parts=(jax_encoder(2, JaxDtypePolicy.f32()), enc_params, flow, flow_params))
    jax_aot.export_bundle(jm, str(tmp_path / "jax"), batch=BATCH, mean=data["mean"],
                          std=data["std"])
    want_s, want_maps = jax_aot.load_bundle(str(tmp_path / "jax")).score(data["images"])

    enc = _tiny_deit()
    enc.load_state_dict(vit_state_dict_from_jax(enc_params), strict=True)
    port_flow = NormalizingFlow(D, IMG, patches, hidden_ratio=0.16, flow_steps=4)
    port_flow.load_state_dict(nf_state_dict_from_jax(flow_params, patches), strict=True)
    m = RunModels("nf", _hp("enc_deit", "nf"), (enc.eval(), port_flow.eval()))
    _export(m, data, tmp_path / "port")
    got_s, got_maps = aot.load_bundle(str(tmp_path / "port"), device="cpu").score(data["images"])
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=2e-5)
