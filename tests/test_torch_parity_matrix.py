"""The port's quality-parity harness (`vit_ad_tpu_torch/cli/parity_matrix.py`,
`cli/compare_results.py`) against the JAX tools (`tools/parity_matrix.py`,
`tools/compare_results.py`): the same matrix, the same gate and output on
the same CSVs, the same rehearsal folders byte for byte and the same
rehearsal plan; a cross-package rehearsal (one tiny entry per head family,
one category each, f32, the port starting from the JAX trainers' initial
weights) whose port rows pass the port's 0.5-pt gate against the JAX rows;
and the failures: a stand-in 0.01 above ours exits 1, a rehearsal without a
card exits instead of training on the CPU, and the real-data mode without
`--data-root` errors as the JAX tool's does."""

import csv
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import compare_results as jax_compare  # noqa: E402
import parity_matrix as jax_parity  # noqa: E402

from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy  # noqa: E402
from vit_ad_tpu.config import HyperParams as JaxHyperParams  # noqa: E402
from vit_ad_tpu.models.flow import NormalizingFlow as JaxFlow  # noqa: E402
from vit_ad_tpu.models.mdn import GaussianMDN as JaxMDN  # noqa: E402
from vit_ad_tpu.pipeline.train import default_encoder_params  # noqa: E402
from vit_ad_tpu.registry import get_model as jax_get_model  # noqa: E402
from vit_ad_tpu_torch.cli import compare_results as port_compare  # noqa: E402
from vit_ad_tpu_torch.cli import parity_matrix as port_parity  # noqa: E402
from vit_ad_tpu_torch.config import DtypePolicy  # noqa: E402
from vit_ad_tpu_torch.pipeline import train as train_module  # noqa: E402
from vit_ad_tpu_torch.utils.convert import (  # noqa: E402
    mdn_state_dict_from_jax,
    nf_state_dict_from_jax,
    recon_state_dict_from_jax,
    vanilla_encoder_state_dict_from_jax,
)

METRICS = ["image_auroc_score", "pixel_auroc_score"]
GATED = ["image_auroc_score"]  # the tool's default --metrics
# one tiny entry per head family, both datasets covered (as
# tests/test_parity_matrix.py's rehearsal), one category each
CROSS_ENTRIES = {"nf_mvtec_lastblock": "bottle", "gmm_btad_100_gaussians": "01",
                 "recon_mvtec_smalldecod": "bottle"}
# image AUROC of the port's rows against the JAX rows: the same initial
# weights, batches and f32 math, summed in other orders
AUROC_ATOL = 1e-3
# best validation loss of the flow and the AE, which draw no noise: the NF
# agrees to ~2e-5; the AE's conv biases before each BatchNorm get noise-size
# gradients that Adam turns into ±lr steps, ~1e-3 after two epochs
LOSS_RTOL = 5e-3


def test_matrix_equals_the_jax_tool():
    assert port_parity.MATRIX == jax_parity.MATRIX
    assert (port_parity.MVTEC_DIR, port_parity.BTAD_DIR) == \
        (jax_parity.MVTEC_DIR, jax_parity.BTAD_DIR)


def _write_csv(path, fields, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
    return str(path)


def _ours(path, values):
    return _write_csv(path, ["dataclass", "error"] + METRICS, [
        {"dataclass": c, "error": "", "image_auroc_score": i, "pixel_auroc_score": p}
        for c, (i, p) in values.items()])


def _ref(path, values, encoder=""):
    rows = [{"Name": f"Eval-{c}", "dataclass": c, "architecture": enc,
             "image_auroc_score": i, "pixel_auroc_score": p}
            for enc, table in ([(encoder, values)] if isinstance(values, dict) else values)
            for c, (i, p) in table.items()]
    return _write_csv(path, ["Name", "dataclass", "architecture"] + METRICS, rows)


REF = {"bottle": (0.990, 0.985), "cable": (0.900, 0.940)}
# a backbone sweep: an EsViT and a DeiT eval row per category, DeiT last
BACKBONES = [("EsVit", {"bottle": (0.95, 0.96), "cable": (0.91, 0.92)}),
             ("Deit", {"bottle": (0.99, 0.99), "cable": (0.97, 0.98)})]


@pytest.mark.parametrize("ours,ref,flags,rc", [
    ({"bottle": (0.996, 0.990), "cable": (0.896, 0.940)}, REF, [], 0),
    ({"bottle": (0.996, 0.990), "cable": (0.894, 0.940)}, REF, [], 1),
    ({"bottle": (0.996, 0.990)}, {**REF, "zipper": (0.95, 0.95)}, [], 0),
    ({"bottle": (0.95, 0.96), "cable": (0.91, 0.92)}, BACKBONES, ["--encoder", "EsVit"], 0),
    ({"bottle": (0.95, 0.96), "cable": (0.91, 0.92)}, BACKBONES, [], 1),
    ({"bottle": (0.95, 0.96)}, BACKBONES, ["--encoder", "Nest"], 2),
], ids=["within_tolerance", "one_category_0.006_off", "missing_from_ours",
        "backbone_encoder_filter", "backbone_last_row_wins", "no_usable_reference_rows"])
def test_compare_results_main_matches_jax(tmp_path, capsys, ours, ref, flags, rc):
    argv = ["--ours", _ours(tmp_path / "results.csv", ours), "--ref",
            _ref(tmp_path / "ref.csv", ref), *flags]
    got_rc = port_compare.main(argv)
    got = capsys.readouterr().out
    want_rc = jax_compare.main(argv)
    want = capsys.readouterr().out
    assert (got_rc, got) == (want_rc, want)
    assert got_rc == rc


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_rehearsal_data_equals_the_jax_tree(tmp_path):
    port_parity._make_rehearsal_data(str(tmp_path / "port"), port_parity.MATRIX)
    jax_parity._make_rehearsal_data(str(tmp_path / "jax"), jax_parity.MATRIX)
    port, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert len(port) == 4 * (12 + 6 + 3) and sorted(port) == sorted(want)
    assert all(port[k] == want[k] for k in want)


def _recording_run_entry(calls):
    def run_entry(entry, data_root, out_dir, hp_overrides, categories=None, *device):
        cats, _ = port_parity._dataset_cats_and_root(entry["dataset"], data_root)
        calls.append((entry, os.path.relpath(data_root, out_dir), dict(hp_overrides),
                      categories))
        path = os.path.join(out_dir, entry["name"] + ".csv")
        rows = [{"dataclass": c, "image_auroc_score": 1.0} for c in cats[:2]]
        os.makedirs(out_dir, exist_ok=True)
        _write_csv(path, ["dataclass", "image_auroc_score"], rows)
        return path, rows

    return run_entry


@pytest.mark.parametrize("flags", [[], ["--epochs", "3", "--img-size", "48", "--categories",
                                        "cable,02", "--entries", "nf_btad,gmm_mvtec_100_gaussians"]],
                         ids=["defaults", "flags"])
def test_rehearsal_plan_equals_the_jax_tool(tmp_path, monkeypatch, capsys, flags):
    """Both tools' `--rehearse` hand run_entry the same entries (model swap
    applied), hyper-parameter overrides and categories, and print the same
    report; run_entry is recorded, not run."""
    monkeypatch.setenv("VITAD_PLATFORM", "cpu")  # the JAX tool's setdefault leaves it so
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(port_parity, "run_entry", _recording_run_entry(calls["port"]))
    monkeypatch.setattr(jax_parity, "run_entry", _recording_run_entry(calls["jax"]))
    out = {}
    for who, mod, extra in (("port", port_parity, ["--device", "cpu"]), ("jax", jax_parity, [])):
        assert mod.main(["--rehearse", "--out", str(tmp_path / who), *flags, *extra]) == 0
        out[who] = capsys.readouterr().out.replace(str(tmp_path / who), "<out>")
    assert calls["port"] == calls["jax"] and len(calls["port"]) == (2 if flags else 6)
    assert out["port"] == out["jax"]
    assert _tree(tmp_path / "port" / "synthetic_data") == \
        _tree(tmp_path / "jax" / "synthetic_data")


@pytest.fixture(scope="module")
def rehearsal_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parity_data"))
    entries = [e for e in port_parity.MATRIX if e["name"] in CROSS_ENTRIES]
    port_parity._make_rehearsal_data(root, entries)
    return root, port_parity.rehearsal_matrix(entries)


def _jax_key_after_encoder(seed):
    """The key the JAX `train_nf` / `train_mdn` draw their head's init from
    when they initialise the encoder themselves (train.py:129-155, :304-335)."""
    rng = jax.random.key(seed)
    rng, _ = jax.random.split(rng)
    return jax.random.split(rng)[1]


def _port_starts_from_jax(monkeypatch, seed):
    """Patch the port's trainers to build their trunk, AE and head with the
    JAX trainers' initial weights for `seed` (JAX inits jitted: op by op
    they take several times their compile)."""
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    key = _jax_key_after_encoder(seed)
    real_default_encoder = train_module.default_encoder
    real_flow, real_mdn = train_module.NormalizingFlow, train_module.GaussianMDN

    def default_encoder(hp_):
        model = real_default_encoder(hp_)
        jmodel = jax_get_model(hp_.model_name, hp_.img_size, JaxDtypePolicy.f32())
        zeros = jnp.zeros((1, hp_.img_size, hp_.img_size, 3), jnp.float32)
        if hp_.model_name == "enc_cnn":
            jhp = JaxHyperParams(img_size=hp_.img_size, seed=hp_.seed)
            v = to_np(jax.jit(lambda: default_encoder_params(jmodel, jhp))())
            sd = vanilla_encoder_state_dict_from_jax(v["params"], v["batch_stats"])
        else:  # the recon trainer's init (train.py:483-491)
            k = jax.random.split(jax.random.key(hp_.seed))[1]
            sd = recon_state_dict_from_jax(to_np(jax.jit(
                lambda k_, x: jmodel.init(k_, x, train=True))(k, zeros)))
        model.load_state_dict(sd, strict=True)
        return model

    def flow(num_channels, img_size, num_patches, **kw):
        side = int(round(np.sqrt(num_patches)))
        jflow = JaxFlow(num_channels=num_channels, img_size=img_size, num_patches=num_patches,
                        hidden_ratio=kw["hidden_ratio"], flow_steps=kw["flow_steps"],
                        dtypes=JaxDtypePolicy.f32())
        params = jflow.init(key, jnp.zeros((1, side, side, num_channels)))
        f = real_flow(num_channels, img_size, num_patches, **kw)
        f.load_state_dict(nf_state_dict_from_jax(to_np(params), num_patches), strict=True)
        return f

    def mdn(features, num_gaussians, **kw):
        params = JaxMDN(features=features, num_gaussians=num_gaussians).init(
            key, jnp.zeros((1, 1, features)))
        m = real_mdn(features, num_gaussians, **kw)
        m.load_state_dict(mdn_state_dict_from_jax(to_np(params)), strict=True)
        return m

    monkeypatch.setattr(train_module, "default_encoder", default_encoder)
    monkeypatch.setattr(train_module, "NormalizingFlow", flow)
    monkeypatch.setattr(train_module, "GaussianMDN", mdn)


@pytest.mark.parametrize("name", list(CROSS_ENTRIES))
def test_cross_package_rehearsal(rehearsal_data, tmp_path, monkeypatch, name):
    """One rehearsal entry through both tools' run_entry on the same folders,
    f32: the JAX rows written as a stand-in reference gate the port's
    results.csv at 0.5 pt, and image AUROC agrees within AUROC_ATOL."""
    root, matrix = rehearsal_data
    (entry,) = [e for e in matrix if e["name"] == name]
    cats = [CROSS_ENTRIES[name]]
    want_csv, want = jax_parity.run_entry(entry, root, str(tmp_path / "jax"),
                                          {**port_parity.REHEARSAL_HP,
                                           "dtypes": JaxDtypePolicy.f32()}, cats)
    hp_overrides = {**port_parity.REHEARSAL_HP, "dtypes": DtypePolicy.f32()}
    _port_starts_from_jax(monkeypatch, JaxHyperParams().seed)
    got_csv, got = port_parity.run_entry(entry, root, str(tmp_path / "port"), hp_overrides, cats,
                                         device="cpu")
    assert [r["dataclass"] for r in got] == cats and not any("error" in r for r in got + want)
    stand_in = str(tmp_path / "stand_in" / f"{name}.csv")
    port_parity._write_stand_in_reference(want, stand_in, GATED)
    ok, lines = port_parity.compare_entry(got_csv, stand_in, 0.005, GATED)
    assert ok, "\n".join(lines)
    for g, w in zip(got, want):
        assert g["epochs_ran"] == w["epochs_ran"]
        if entry["arch"] != "mdn":  # the MDN's Gumbel noise: JAX's and torch's streams differ
            np.testing.assert_allclose(g["best_valid_loss"], w["best_valid_loss"],
                                       rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["image_auroc_score"], w["image_auroc_score"], rtol=0,
                                   atol=AUROC_ATOL)
    with open(got_csv) as f, open(want_csv) as f2:
        assert next(csv.reader(f)) == next(csv.reader(f2))


def test_stand_in_above_ours_fails_with_exit_1(tmp_path, monkeypatch, capsys):
    """A stand-in reference 0.01 above our rows fails the 0.5-pt gate: the
    entry reads FAIL, the summary is not ok, the tool exits 1."""
    real = port_parity._write_stand_in_reference

    def raised(rows, path, metrics):
        real([{**r, **{m: r[m] + 0.01 for m in metrics}} for r in rows], path, metrics)

    monkeypatch.setattr(port_parity, "_write_stand_in_reference", raised)
    out = tmp_path / "out"
    rc = port_parity.main(["--rehearse", "--device", "cpu", "--out", str(out), "--entries",
                           "nf_mvtec_lastblock", "--categories", "bottle"])
    text = capsys.readouterr().out
    assert rc == 1 and "== nf_mvtec_lastblock: FAIL" in text
    assert json.loads(text.strip().splitlines()[-1]) == {"parity_matrix_ok": False, "entries": 1}
    summary = json.loads((out / "parity_summary.json").read_text())
    assert summary["ok"] is False and summary["entries"][0]["ok"] is False


def test_rehearsal_without_a_card_exits(tmp_path, monkeypatch):
    """--device defaults to cuda: without a card the tool exits through
    `config.check_device` before it writes or trains anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cuda: no CUDA device is available"):
        port_parity.main(["--rehearse", "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_real_data_mode_needs_data_root(tmp_path, capsys):
    errors = []
    for mod in (port_parity, jax_parity):
        with pytest.raises(SystemExit) as e:
            mod.main(["--out", str(tmp_path / "out")])
        errors.append((e.value.code, capsys.readouterr().err.strip().splitlines()[-1]
                       .split(": ", 1)[1]))
    assert errors[0] == errors[1] == (2, "error: --data-root is required (or use --rehearse)")


@pytest.mark.slow
def test_parity_matrix_rehearsal_on_the_cpu(tmp_path):
    """The whole six-entry rehearsal on the CPU, as
    tests/test_parity_matrix.py runs the JAX tool's."""
    out = tmp_path / "parity"
    assert port_parity.main(["--rehearse", "--device", "cpu", "--out", str(out)]) == 0
    summary = json.loads((out / "parity_summary.json").read_text())
    assert summary["ok"] is True and len(summary["entries"]) == 6
    for e in summary["entries"]:
        assert e["ok"], e
        with open(e["ours"]) as f:
            header = f.readline()
        assert "image_auroc_score" in header and "dataclass" in header
