"""Port sweep engine (`vit_ad_tpu_torch/pipeline/sweep.py`) and its CLI
(`cli/trainings_loop.py`) against the JAX package's: the cases of
tests/test_drivers.py ported (the CLI main, parallel = sequential with
spawned CPU workers, a re-run after an hp change, the stamp, the pinning of
the workers, a mesh), and the same fake trainer results through both
packages' engines give byte-identical `results.csv` files and equal
`done.json` rows (the `_hp` stamp aside: each package stamps its own
`HyperParams`)."""

import csv
import dataclasses
import json
import multiprocessing
import os
import types

import numpy as np
import pytest
import torch

from test_torch_score import _tiny_port_encoder
import chip_smoke
from vit_ad_tpu.config import HyperParams as JaxHyperParams
from vit_ad_tpu.pipeline import metrics as jax_metrics_module
from vit_ad_tpu.pipeline.metrics import calc_all_metrics as jax_calc_all_metrics
from vit_ad_tpu.pipeline import sweep as jax_sweep
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.cli import trainings_loop
from vit_ad_tpu_torch.config import DtypePolicy, HyperParams, MeshConfig
from vit_ad_tpu_torch.data.synthetic import make_mvtec_category
from vit_ad_tpu_torch.pipeline import sweep
from vit_ad_tpu_torch.pipeline.sweep import (
    SweepRun,
    _effective_hp,
    _hp_stamp,
    resolve_trainer,
    run_sweep,
    run_sweep_parallel,
)


def _categories(root, cats, img=32, n_train=8):
    for cat in cats:
        make_mvtec_category(str(root), cat, img_size=img, n_train=n_train, n_test_good=2,
                            n_test_defect=2)
    return str(root)


def _tiny_nf_hp(**kw):
    # enc_cnn at 32 px is tiny: the parallel workers are real processes, so
    # the registry cannot be patched for them
    return HyperParams(model_name="enc_cnn", architecture="nf", epochs=2, patience=2,
                       batch_size=4, img_size=32, hidden_ratio=0.25, flow_steps=2,
                       dtypes=DtypePolicy.f32(), **kw)


def test_trainings_loop_main(tmp_path, monkeypatch, capsys):
    root = _categories(tmp_path / "data", ("bottle", "cable"), n_train=10)
    monkeypatch.setitem(registry._BUILDERS, "enc_deit", _tiny_port_encoder)
    monkeypatch.chdir(tmp_path)
    rc = trainings_loop.main(["-a", "mdn", "-d", root, "-o", "out", "-c", "bottle,cable",
                              "-e", "2", "-p", "2", "-n", "2", "-i", "32", "-b", "8",
                              "--device", "cpu"])
    assert rc == 0
    with open(tmp_path / "out" / "results.csv") as f:
        rows = list(csv.DictReader(f))
    assert {r["dataclass"] for r in rows} == {"bottle", "cable"}
    assert all(r["image_auroc_score"] and "error" not in r for r in rows)
    # the columns of the JAX engine for these rows, which chip_smoke.py holds
    # the card's sweep to
    jax_metrics = jax_calc_all_metrics(jax_metrics_module.EvalResult(
        image_scores=np.array([0.1, 0.9]), image_labels=np.array([0.0, 1.0]),
        pixel_scores=np.random.default_rng(0).random((2, 8, 8)),
        pixel_labels=np.arange(128).reshape(2, 8, 8) % 2.0))
    want = ["Name", "dataclass", "model", "epochs_ran", "best_valid_loss", *jax_metrics]
    assert list(rows[0]) == want == chip_smoke.SWEEP_COLUMNS
    assert (tmp_path / "out" / "dataset_distribution.png").exists()
    assert "mean image AUROC over 2 categories" in capsys.readouterr().out


def test_parallel_sweep_matches_sequential(tmp_path, monkeypatch):
    """Two spawned CPU workers train two categories as the sequential sweep
    does (both at two torch threads: the same CPU kernels); then a
    sequential resume over the parallel output retrains nothing. (How the
    runs split over workers: `test_sweep_parallel_pins_cards`.)"""
    cats = ("bottle", "cable")
    root = _categories(tmp_path / "data", cats)
    hp = _tiny_nf_hp()
    runs = [SweepRun(category=c, data_root=root) for c in cats]
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        seq = run_sweep(resolve_trainer("nf"), hp, runs, str(tmp_path / "seq"), device="cpu")
    finally:
        torch.set_num_threads(threads)
    par = run_sweep_parallel("nf", hp, runs, str(tmp_path / "par"), num_workers=2,
                             platform="cpu")
    assert [r["dataclass"] for r in par] == list(cats)
    for s, p in zip(seq, par):
        assert "error" not in p, p
        assert p["image_auroc_score"] == pytest.approx(s["image_auroc_score"], abs=1e-9)
        assert p["best_valid_loss"] == pytest.approx(s["best_valid_loss"], rel=1e-6)

    def never(*a, **k):
        raise AssertionError("a finished run was trained again")

    again = run_sweep(never, hp, runs, str(tmp_path / "par"), device="cpu")
    assert again == par
    with open(tmp_path / "par" / "results.csv") as f:
        assert len(list(csv.DictReader(f))) == len(cats)


def test_sweep_resume_reruns_on_hp_change(tmp_path):
    root = _categories(tmp_path / "data", ("bottle",))
    hp = _tiny_nf_hp()
    hp.epochs = 1
    runs = [SweepRun(category="bottle", data_root=root)]
    out = str(tmp_path / "out")
    trainer = resolve_trainer("nf")
    r1 = run_sweep(trainer, hp, runs, out, device="cpu")
    assert r1[0]["epochs_ran"] == 1
    assert run_sweep(trainer, hp, runs, out, device="cpu") == r1
    r3 = run_sweep(trainer, dataclasses.replace(hp, epochs=2), runs, out, device="cpu")
    assert r3[0]["epochs_ran"] == 2


def test_sweep_stamp_covers_dtypes_and_data_root():
    hp = HyperParams(dtypes=DtypePolicy.f32())
    run = SweepRun(category="bottle", data_root="/data/a")
    s0 = _hp_stamp(_effective_hp(hp, run), run)
    assert _hp_stamp(_effective_hp(dataclasses.replace(hp, dtypes=DtypePolicy()), run),
                     run) != s0
    run_b = SweepRun(category="bottle", data_root="/data/b")
    assert _hp_stamp(_effective_hp(hp, run_b), run_b) != s0
    run_pref = SweepRun(category="bottle", data_root="/data/a", train_pref="train/ok")
    assert _hp_stamp(_effective_hp(hp, run_pref), run_pref) != s0
    assert _hp_stamp(_effective_hp(hp, run), run) == s0


class _FakeCtx:
    """A multiprocessing context whose Process records the environment it
    was made in (what a spawned worker would see) and never runs."""

    def __init__(self):
        self.made = []
        ctx = self

        class Process:
            def __init__(self, target=None, args=()):
                ctx.made.append((dict(os.environ), args))
                self.exitcode = 0

            def start(self):
                pass

            def join(self):
                pass

        self.Process = Process


def test_sweep_parallel_pins_cards(tmp_path, monkeypatch):
    """Each worker sees its own card through CUDA_VISIBLE_DEVICES (mapped
    through the parent's own pinning), trains on `cuda`, and the parent's
    environment is restored; "cpu" hides every card; more workers than
    cards are refused before anything is spawned."""
    runs = [SweepRun(category=c, data_root=str(tmp_path)) for c in ("bottle", "cable", "grid")]
    ctx = _FakeCtx()
    monkeypatch.setattr(multiprocessing, "get_context", lambda kind: ctx)
    # a host with two cards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert run_sweep_parallel("nf", HyperParams(), runs, str(tmp_path / "out"),
                              num_workers=2) == []
    assert [env["CUDA_VISIBLE_DEVICES"] for env, _ in ctx.made] == ["0", "1"]
    assert [args[-1] for _, args in ctx.made] == ["cuda", "cuda"]
    assert [[r.category for r in args[2]] for _, args in ctx.made] == \
        [["bottle", "grid"], ["cable"]]
    assert "CUDA_VISIBLE_DEVICES" not in os.environ

    ctx.made.clear()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,7")
    run_sweep_parallel("nf", HyperParams(), runs, str(tmp_path / "out"), num_workers=2)
    assert [env["CUDA_VISIBLE_DEVICES"] for env, _ in ctx.made] == ["5", "7"]
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "5,7"

    ctx.made.clear()
    run_sweep_parallel("nf", HyperParams(), runs, str(tmp_path / "out"), num_workers=2,
                       platform="cpu")
    assert [(env["CUDA_VISIBLE_DEVICES"], args[-1]) for env, args in ctx.made] == \
        [("", "cpu"), ("", "cpu")]

    ctx.made.clear()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError,
                       match=r"2 sweep workers .* torch.cuda.device_count\(\) is 1"):
        run_sweep_parallel("nf", HyperParams(), runs, str(tmp_path / "out"), num_workers=2)
    assert ctx.made == []


def test_sweep_refuses_a_mesh_and_a_missing_card(tmp_path, monkeypatch):
    runs = [SweepRun(category="bottle", data_root=str(tmp_path))]
    meshed = HyperParams(mesh=MeshConfig(data=2, model=1))
    # the JAX message for "all devices" in a fanned-out sweep
    with pytest.raises(ValueError, match=r"sweep workers need explicit mesh sizes \(DxM\); -1 "
                                         r"\('all devices'\) is ambiguous"):
        run_sweep_parallel("nf", HyperParams(mesh=MeshConfig(data=-1, model=1)), runs,
                           str(tmp_path / "a"), num_workers=2, platform="cpu")
    # a worker of a 2x1 mesh takes two cards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"1 sweep workers need 2 cards each; "
                                         r"torch.cuda.device_count\(\) is 1"):
        run_sweep_parallel("nf", meshed, runs, str(tmp_path / "b"), num_workers=2)
    with pytest.raises(SystemExit, match=r"--mesh 2x1 needs 2 cards, one a rank"):
        trainings_loop.main(["--mesh", "2x1"])
    with pytest.raises(SystemExit, match="on the CPU give its sizes"):
        trainings_loop.main(["--mesh", "auto", "--device", "cpu"])
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        run_sweep(resolve_trainer("nf"), HyperParams(), runs, str(tmp_path / "c"))
    with pytest.raises(SystemExit, match="no CUDA device"):
        run_sweep_parallel("nf", HyperParams(), runs, str(tmp_path / "d"), num_workers=1)
    with pytest.raises(SystemExit, match="--device cpu"):
        trainings_loop.main(["-a", "mdn", "-d", str(tmp_path), "-c", "bottle"])
    assert set(sweep.TRAINERS) == set(jax_sweep.TRAINERS)
    assert all(callable(resolve_trainer(a)) for a in sweep.TRAINERS)


def test_fake_results_give_the_jax_csv_and_rows(tmp_path):
    """One fake trainer through both engines: a finished run and a crashed
    one. results.csv byte for byte, done.json rows equal (the stamp aside),
    the error row's file byte for byte (it has no stamp), traceback.txt
    written, and the port passes `device=` to the trainer."""
    cats = ("bottle", "cable")
    root = _categories(tmp_path / "data", cats, img=16, n_train=4)
    seen = []

    def fake(hp, data, test, **kw):
        seen.append(kw)
        if hp.data_class == "cable":
            raise RuntimeError("the card fell over")
        return types.SimpleNamespace(
            epochs_ran=3, best_valid_loss=0.1 + 0.2,
            metrics={"image_auroc_score": 0.75, "pixel_auroc_score": 1 / 3,
                     "image_prauc_score": np.float64(0.5), "pro_score_0.3fp": 0.125})

    jax_rows = jax_sweep.run_sweep(
        fake, JaxHyperParams(model_name="enc_deit"),
        [jax_sweep.SweepRun(category=c, data_root=root) for c in cats], str(tmp_path / "jax"))
    port_rows = run_sweep(fake, HyperParams(model_name="enc_deit"),
                          [SweepRun(category=c, data_root=root) for c in cats],
                          str(tmp_path / "port"), device="cpu")
    assert seen[0] == {} and seen[2:] == [{"device": "cpu"}] * 2
    read = lambda *p: open(os.path.join(tmp_path, *p), "rb").read()
    assert read("port", "results.csv") == read("jax", "results.csv")
    strip = lambda row: {k: v for k, v in row.items() if k != "_hp"}
    assert [strip(r) for r in port_rows] == [strip(r) for r in jax_rows]
    for side in ("jax", "port"):
        done = json.loads(read(side, "bottle", "done.json"))
        assert "_hp" in done and strip(done) == strip(port_rows[0])
    assert read("port", "cable", "done.json") == read("jax", "cable", "done.json")
    assert port_rows[1]["error"] == "RuntimeError: the card fell over"
    assert "the card fell over" in read("port", "cable", "traceback.txt").decode()
