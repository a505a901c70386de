"""BENCHMARK.json, the configuration, traffic and limits files parse, meet
the benchmark's rules, and the harness finds each file by the name an entry
gives it, a new one included: a cell, or a configuration of a trunk family
that only its own file under `trunks/` defines."""

from __future__ import annotations

import json
import re
import shutil

import pytest
from conftest import BENCH_DIR, ROOT

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= allowed[section], e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_cells_and_metrics_fit_together():
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert {w["config"] for w in cells.values()} == configs
    assert all(w["chips"] == 1 for w in cells.values())
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
    for name in cells:
        cell = spec.load_cell(name, ROOT)
        assert {m["name"] for m in cell.end_to_end} > {"setup_s"}
        assert cell.per_layer, name


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = spec.load_cell(cell, ROOT)
    assert c.kind in ("score", "train")
    assert c.limits and all(v > 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)


# What a configuration may cut from its published model: depth, the one cut
# of the sizing rules that applies while no trunk is shared over chips.
MAY_CUT = {"depth"}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_files(config):
    import torch

    from harness import port
    from vit_ad_tpu_torch.registry import get_model

    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == config and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    # the published widths, from the trunk family's file: kept but for the cuts listed
    assert set(cfg["reduced"]) <= MAY_CUT
    family = spec.trunk(cfg)
    published = family.PUBLISHED[cfg["model_name"]]
    kept = {k: v for k, v in published.items() if k not in cfg["reduced"]}
    assert {k: cfg[k] for k in kept} == kept
    assert cfg["assumed"]
    # the trunk family's file, and the port's registry model at its widths
    hp = port.hyper_params(cfg)
    with torch.device("meta"):
        encoder = get_model(hp.model_name, hp.img_size, hp.dtypes, generator=None,
                            fused_mlp=hp.fused_mlp)
    family.check_widths(encoder, cfg)


def test_a_new_cell_is_found_by_name(tmp_path, monkeypatch):
    """A later change adds a traffic mix, a limits file, a metric reader and
    the entries; the harness finds them with no edit."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic = json.loads((bench / "traffic" / "score_b128.json").read_text())
    traffic["batch"] = 16
    (bench / "traffic" / "score_b16.json").write_text(json.dumps(traffic))
    (bench / "limits" / "deit_nf.score_b16.json").write_text('{"score_gap": 1e-3}')
    (bench / "metrics" / "batches.score.py").write_text("def read(r):\n    return r.units\n")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "deit_nf.score_b16", "config": "deit_base_nf20",
                           "traffic": "score_b16", "chips": 1, "why": "small batches"})
    for m in b["end_to_end"]:
        if "score_img_per_s" == m["name"]:
            m["workloads"].append("deit_nf.score_b16")
    b["per_layer"].append({"name": "batches.score", "unit": "1", "better": "higher",
                           "source": "host_clock", "layer": "scoring entry",
                           "moves": "score_img_per_s", "workloads": ["deit_nf.score_b16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(spec, "BENCH_DIR", bench)
    cell = spec.load_cell("deit_nf.score_b16", tmp_path)
    assert cell.traffic["batch"] == 16 and cell.limits == {"score_gap": 1e-3}
    assert [m["name"] for m in cell.per_layer] == ["batches.score"]
    assert spec.metric_reader("batches.score").read(type("R", (), {"units": 3})) == 3


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        spec.load_cell("no.such_cell", ROOT)


TOY_TRUNK = '''"""A trunk family of its own name: DeiT's functions, each call marked in
`toy.calls` beside this file."""
from pathlib import Path

from harness import spec

DEIT = spec.load_module(Path(__file__).with_name("deit.py"), "toy_deit")


def _mark(name):
    with open(Path(__file__).with_name("toy.calls"), "a") as f:
        f.write(name + "\\n")


def state(cfg, gen, device):
    _mark("state")
    return DEIT.state(cfg, gen, device)


def check_widths(encoder, cfg):
    _mark("check_widths")
    DEIT.check_widths(encoder, cfg)


def reference(sd, cfg, control=False):
    _mark("reference")
    return DEIT.reference(sd, cfg, control)


def forward_work(cfg):
    _mark("forward_work")
    return DEIT.forward_work(cfg)
'''


def test_a_new_trunk_family_is_found_by_name(tmp_path, monkeypatch):
    """A later change adds a trunk family's file, a configuration that names
    it, its cells' limits and the entries; scoring (traced: the mfu reader
    counts the trunk's work) and training run through it with no edit to the
    harness, and stay correct."""
    from conftest import run_tiny, tiny_cell

    from harness import flops

    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "trunks" / "toy.py").write_text(TOY_TRUNK)
    cfg = json.loads((bench / "configs" / "deit_base_mdn150.json").read_text())
    cfg.update(name="toy_mdn150", trunk="toy")
    (bench / "configs" / "toy_mdn150.json").write_text(json.dumps(cfg))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "toy_mdn150", "source": cfg["source"],
                         "file": "benchmark/configs/toy_mdn150.json", "reduced": [],
                         "why": "a trunk family that only its own file defines"})
    for cell, like in (("toy.score_b128", "deit_mdn.score_b128"),
                       ("toy.train_b64", "deit_mdn.train_b64")):
        shutil.copy(bench / "limits" / f"{like}.json", bench / "limits" / f"{cell}.json")
        w = next(w for w in b["workloads"] if w["name"] == like)
        b["workloads"].append({**w, "name": cell, "config": "toy_mdn150"})
        for m in b["end_to_end"] + b["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(spec, "BENCH_DIR", bench)
    calls = bench / "trunks" / "toy.calls"

    score = tiny_cell("toy.score_b128", root=tmp_path)
    res = run_tiny(score, seconds=0.6, trace=True)
    assert res["correct"], res["checks"]
    assert set(calls.read_text().split()) == {"state", "check_widths", "reference",
                                              "forward_work"}
    assert flops.per_image(score.config, "score")[:2] == spec.trunk(
        {**score.config, "trunk": "deit"}).forward_work(score.config)
    calls.unlink()
    res = run_tiny(tiny_cell("toy.train_b64", root=tmp_path))
    assert res["correct"], res["checks"]
    assert set(calls.read_text().split()) == {"state", "check_widths", "reference"}
