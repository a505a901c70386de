"""The serving options of the port's `cli.score` on a run directory, ported
from the JAX CLI's tests (`tests/test_score_cli.py`: the incremental
`--watch`, the corrupt file isolated and then a NaN row after three waves,
the resume with a torn row and another spelling of the folder, and
`--weights-dtype bf16`), plus what the port adds: a failure of the models
under `--watch` ends the CLI and is not counted as a strike, `--heatmaps`
writes the top-N overlays, and `compress_params_bf16` rounds every f32
tensor, is read by the cached weights after a first forward pass, and holds
to JAX `score_models(compress_params_bf16(...))`. CPU, tiny f32 DeiT + NF."""

import csv
import dataclasses
import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import pil_decode
from test_torch_score import _tiny_port_encoder
from test_torch_vit import D, IMG, PATCH, jax_encoder, jax_params, jitter
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.config import HyperParams as JaxHyperParams
from vit_ad_tpu.data.loader import DataPipeline as JaxPipeline
from vit_ad_tpu.models.flow import NormalizingFlow as JaxFlow
from vit_ad_tpu.pipeline import loading as jax_loading
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.cli import score as score_cli
from vit_ad_tpu_torch.cli import train_nf as train_nf_cli
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.data import synthetic
from vit_ad_tpu_torch.data.dataset import default_norm_stats
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.models.flow import NormalizingFlow
from vit_ad_tpu_torch.pipeline import loading
from vit_ad_tpu_torch.pipeline.loading import RunModels, compress_params_bf16, score_models
from vit_ad_tpu_torch.utils.convert import nf_state_dict_from_jax, vit_state_dict_from_jax

STEPS, RATIO, BATCH = 2, 0.5, 4
# f32 compute on the same bf16-rounded weights (round to nearest even on
# both sides): sums in other orders only, as `test_torch_score.py`
ATOL = 2e-5
# bf16 at rest, port vs JAX as it stands: JAX's flow computes its global
# affine scale 0.2·softplus(0.5·p) and log(scale) in bf16 (its elementwise
# ops follow the compressed parameter's dtype), the port in f32 from the same
# rounded p: up to 2^-9 relative per step in the scale, twice that in z²,
# through 2 steps, so up to ~1.1% of the mean of z² (~1.4 here) and
# 0.5·exp(-0.7)·1.1%·1.4 ≈ 4e-3 in a score of ~0.5. With that one op in f32
# on the JAX side too (its rounded p upcast), the two agree to ATOL.
BF16_FLOW_ATOL = 4e-3


@pytest.fixture(scope="module")
def nf_run(tmp_path_factory):
    """An NF-2 head on the tiny DeiT trained for one epoch by `cli.train_nf`."""
    mp = pytest.MonkeyPatch()
    pil_decode(mp)
    mp.setitem(registry._BUILDERS, "enc_deit", _tiny_port_encoder)
    root = tmp_path_factory.mktemp("torch_watch")
    cat = synthetic.make_mvtec_category(str(root), "widget", img_size=IMG, n_train=8,
                                        n_test_good=3, n_test_defect=3)
    run = root / "run"
    assert train_nf_cli.main(["-m", "deit", "-r", str(RATIO), "-f", str(STEPS), "-d", cat, "-t",
                              "train/good", "-v", "test", "-e", "1", "-p", "1", "-b", str(BATCH),
                              "-i", str(IMG), "--device", "cpu", "--out", str(run)]) == 0
    yield str(run), cat
    mp.undo()


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    pil_decode(monkeypatch)
    monkeypatch.setitem(registry._BUILDERS, "enc_deit", _tiny_port_encoder)


def _pool(cat):
    return sorted(glob.glob(f"{cat}/test/good/*")) + sorted(glob.glob(f"{cat}/test/crack/*"))


def _watch(run, src, out, waves, *extra):
    return score_cli.main(["-r", run, "-d", str(src), "-o", str(out), "--watch", "0.01",
                           "--watch-waves", str(waves), "--device", "cpu", *extra])


def test_score_watch_incremental(nf_run, tmp_path):
    """A first watch scores what is there; images arriving later are scored
    without scoring (or rewriting) earlier rows again, resuming from the
    existing scores.csv like a restarted server; the rows are the one-shot
    scores of the same images."""
    run, cat = nf_run
    src = tmp_path / "incoming"
    src.mkdir()
    pool = _pool(cat)
    for i, f in enumerate(pool[:3]):
        shutil.copy(f, src / f"frame_{i:03d}.png")
    out = tmp_path / "watch_out"
    assert _watch(run, src, out, 1) == 0
    first = (out / "scores.csv").read_text().splitlines()
    assert len(first) == 1 + 3
    for i, f in enumerate(pool[3:5], start=3):
        shutil.copy(f, src / f"frame_{i:03d}.png")
    assert _watch(run, src, out, 2) == 0
    lines = (out / "scores.csv").read_text().splitlines()
    assert lines[:4] == first
    assert len(lines) == 1 + 5
    summary = json.loads((out / "summary.json").read_text())
    assert (summary["images"], summary["waves"], summary["last_wave"]["n"]) == (5, 2, 2)
    assert score_cli.main(["-r", run, "-d", str(src), "-o", str(tmp_path / "oneshot"),
                           "--device", "cpu"]) == 0
    assert (tmp_path / "oneshot" / "scores.csv").read_text().splitlines() == lines


def test_score_watch_corrupt_file_isolated(nf_run, tmp_path):
    """A mid-copy or corrupt image cannot drop its wave: the good files of
    the wave are scored, the bad one retries, and after 3 failed waves it
    gets a NaN row so the watcher moves on."""
    run, cat = nf_run
    src = tmp_path / "incoming"
    src.mkdir()
    for i, f in enumerate(_pool(cat)[:2]):
        shutil.copy(f, src / f"frame_{i:03d}.png")
    (src / "frame_torn.png").write_bytes((src / "frame_000.png").read_bytes()[:40])
    out = tmp_path / "watch_out"
    assert _watch(run, src, out, 2) == 0
    with open(out / "scores.csv") as f:
        assert sorted(os.path.basename(r["path"]) for r in csv.DictReader(f)) == \
            ["frame_000.png", "frame_001.png"]  # two strikes: not given up yet
    assert _watch(run, src, out, 3) == 0  # a restart forgets the strikes
    with open(out / "scores.csv") as f:
        by_path = {os.path.basename(r["path"]): float(r["image_score"])
                   for r in csv.DictReader(f)}
    assert len(by_path) == 3
    assert np.isfinite(by_path["frame_000.png"]) and np.isfinite(by_path["frame_001.png"])
    assert np.isnan(by_path["frame_torn.png"])


def test_score_watch_resume_validates_rows_and_realpaths(nf_run, tmp_path, monkeypatch):
    """A torn final CSV row is scored again (not trusted), and dedup keys on
    the real path, so a restart with another spelling of -d does not score
    the images again."""
    run, cat = nf_run
    src = tmp_path / "incoming"
    src.mkdir()
    for i, f in enumerate(_pool(cat)[:2]):
        shutil.copy(f, src / f"frame_{i:03d}.png")
    out = tmp_path / "watch_out"
    assert _watch(run, src, out, 1) == 0
    lines = (out / "scores.csv").read_text().splitlines()
    assert len(lines) == 3
    (out / "scores.csv").write_text("\n".join(lines[:2] + [str(src / "frame_001.png")]) + "\n")
    monkeypatch.chdir(tmp_path)
    assert _watch(run, "incoming", out, 1) == 0
    with open(out / "scores.csv") as f:
        rows = list(csv.reader(f))[1:]
    assert sorted(os.path.basename(r[0]) for r in rows) == ["frame_000.png", "frame_001.png"]
    assert rows[0] == lines[1].split(",")
    assert all(np.isfinite(float(r[1])) for r in rows)


def test_score_watch_model_failure_ends_the_cli_without_a_strike(nf_run, tmp_path, monkeypatch):
    """What the models (or the card) raise is not a bad file: the watch ends
    with the error, records nothing of that wave and counts no strike; the
    next run scores the file."""
    run, cat = nf_run
    src = tmp_path / "incoming"
    src.mkdir()
    shutil.copy(_pool(cat)[0], src / "frame_000.png")
    out = tmp_path / "watch_out"
    assert _watch(run, src, out, 1) == 0
    shutil.copy(_pool(cat)[1], src / "frame_001.png")

    def launch_failure(*args, **kwargs):
        raise RuntimeError("CUDA error: unspecified launch failure")

    with monkeypatch.context() as mp:
        mp.setattr(loading, "score_models", launch_failure)
        for _ in range(3):
            with pytest.raises(RuntimeError, match="launch failure"):
                _watch(run, src, out, 1)
    assert len((out / "scores.csv").read_text().splitlines()) == 1 + 1
    assert _watch(run, src, out, 1) == 0
    with open(out / "scores.csv") as f:
        scores = [float(r["image_score"]) for r in csv.DictReader(f)]
    assert len(scores) == 2 and np.all(np.isfinite(scores))


def test_score_heatmaps_writes_the_top_n_overlays(nf_run, tmp_path):
    """`--heatmaps 2`: the overlays of the two highest scores, ranked, named
    after their images; without `--watch` only."""
    run, cat = nf_run
    out = tmp_path / "out"
    assert score_cli.main(["-r", run, "-d", f"{cat}/test", "-o", str(out), "--heatmaps", "2",
                           "--device", "cpu"]) == 0
    with open(out / "scores.csv") as f:
        rows = list(csv.DictReader(f))
    top = sorted(rows, key=lambda r: -float(r["image_score"]))[:2]
    want = [f"{k:03d}_{os.path.splitext(os.path.basename(r['path']))[0]}.png"
            for k, r in enumerate(top)]
    assert sorted(os.listdir(out / "heatmaps")) == want


def test_score_weights_dtype_bf16(nf_run, tmp_path):
    """`--weights-dtype bf16` (ported from the JAX CLI's test): the same rows,
    finite, within the JAX test's tolerance of the f32 weights' scores; the
    default 'auto' casts nothing."""
    run, cat = nf_run
    outs = {}
    for dtype in ("auto", "bf16"):
        out = tmp_path / dtype
        assert score_cli.main(["-r", run, "-d", f"{cat}/test", "-o", str(out), "--device",
                               "cpu", "--weights-dtype", dtype]) == 0
        with open(out / "scores.csv") as f:
            rows = list(csv.DictReader(f))
        outs[dtype] = ([r["path"] for r in rows],
                       np.array([float(r["image_score"]) for r in rows]))
    assert outs["auto"][0] == outs["bf16"][0]
    s32, s16 = outs["auto"][1], outs["bf16"][1]
    assert np.all(np.isfinite(s16)) and not np.array_equal(s16, s32)
    np.testing.assert_allclose(s16, s32, rtol=0.05, atol=0.02)


@pytest.fixture(scope="module")
def jax_weights():
    enc_params = jax_params(2, seed=11)
    flow = JaxFlow(num_channels=D, img_size=IMG, num_patches=(IMG // PATCH) ** 2,
                   hidden_ratio=RATIO, flow_steps=STEPS, dtypes=JaxDtypePolicy.f32())
    flow_params = jitter(jax.jit(flow.init)(jax.random.key(0), jnp.zeros((1, 4, 4, D))),
                         np.random.default_rng(12), 0.1)
    return enc_params, flow, flow_params


def _port_nf(enc_params, flow_params):
    enc = _tiny_port_encoder()
    enc.load_state_dict(vit_state_dict_from_jax(enc_params), strict=True)
    flow = NormalizingFlow(D, IMG, (IMG // PATCH) ** 2, hidden_ratio=RATIO, flow_steps=STEPS)
    flow.load_state_dict(nf_state_dict_from_jax(flow_params, (IMG // PATCH) ** 2), strict=True)
    return RunModels(kind="nf", hp=HyperParams(img_size=IMG, batch_size=BATCH,
                                               dtypes=DtypePolicy.f32()),
                     parts=(enc.eval(), flow.eval()))


def test_compress_params_bf16_matches_jax_and_is_read_after_a_forward(nf_run, jax_weights):
    """bf16 at rest against JAX `score_models(compress_params_bf16(...))`
    within ATOL; every f32 parameter and buffer is rounded (counted once);
    models cast after a first forward pass (the encoder's compute-dtype
    weights cached) score as models cast before any: the cached copies are
    made again from the rounded tensors."""
    enc_params, jflow, flow_params = jax_weights
    files = _pool(nf_run[1])
    mean, std = default_norm_stats()
    jm = jax_loading.RunModels(kind="nf", hp=JaxHyperParams(img_size=IMG, batch_size=BATCH,
                                                              dtypes=JaxDtypePolicy.f32()),
                               parts=(jax_encoder(2, JaxDtypePolicy.f32()), enc_params, jflow,
                                      flow_params))
    jc = jax_loading.compress_params_bf16(jm)
    jpipe = lambda: JaxPipeline(batch_size=BATCH, img_size=IMG, files=files)
    want = jax_loading.score_models(jc, jpipe(), mean, std)
    f32_scale = jax.tree_util.tree_map_with_path(
        lambda path, a: a.astype(jnp.float32) if "global_scale" in str(path[-1]) else a,
        jc.parts[3])
    exact = jax_loading.score_models(
        dataclasses.replace(jc, parts=(*jc.parts[:3], f32_scale)), jpipe(), mean, std)
    pipe = lambda: DataPipeline(BATCH, IMG, files=files)
    warm = _port_nf(enc_params, flow_params)
    f32 = score_models(warm, pipe(), mean, std)  # fills the cached weights
    tensors = {id(t): t for part in warm.parts
               for t in (*part.parameters(), *part.buffers()) if t.dtype == torch.float32}
    assert compress_params_bf16(warm) == len(tensors)
    for t in tensors.values():
        assert torch.equal(t, t.to(torch.bfloat16).float())
    got = score_models(warm, pipe(), mean, std)
    cold = _port_nf(enc_params, flow_params)
    compress_params_bf16(cold)
    np.testing.assert_array_equal(got.image_scores, score_models(cold, pipe(), mean,
                                                                 std).image_scores)
    np.testing.assert_allclose(got.image_scores, exact.image_scores, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.pixel_scores, exact.pixel_scores, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.image_scores, want.image_scores, rtol=0, atol=BF16_FLOW_ATOL)
    # the cast moved the scores (by 1.6e-3 on the CPU) far beyond ATOL
    assert np.abs(got.image_scores - f32.image_scores).max() > 10 * ATOL


def test_compress_params_bf16_raises_when_nothing_is_cast():
    flow = NormalizingFlow(4, IMG, 16, hidden_ratio=RATIO, flow_steps=STEPS).to(torch.bfloat16)
    with pytest.raises(ValueError, match="nothing was cast"):
        compress_params_bf16(RunModels(kind="nf", hp=HyperParams(), parts=(flow,)))
