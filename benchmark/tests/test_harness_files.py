"""BENCHMARK.json, the configuration, traffic and limits files parse, meet
the benchmark's rules, and the harness finds each file by the name an entry
gives it, a new one included."""

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


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == config and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    # published widths: DeiT-base/16 at 224 px
    assert (cfg["embed_dim"], cfg["depth"], cfg["num_heads"], cfg["mlp_ratio"],
            cfg["patch_size"], cfg["img_size"]) == (768, 12, 12, 4.0, 16, 224)
    assert cfg["assumed"]


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
