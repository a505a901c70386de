"""Finds what a cell needs by the names in `BENCHMARK.json`: the cell, its
configuration file, the trunk family it names (`trunks/<trunk>.py`), its
traffic mix (`traffic/<name>.json`), its limits (`limits/<cell>.json`), the
readers of its per-layer metrics (`metrics/<metric>.py`) and the kernel
counts (`kernels/<id>.py`). A new cell, configuration, trunk, mix, metric or
kernel is a new file and a new entry; nothing here names one."""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `<root>/BENCHMARK.json` with its files, and the
    metrics it reports: end-to-end metrics whose `workloads` list it (or
    that have none), per-layer metrics likewise, restricted to those whose
    `moves` metric the cell reports."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    trunk_file(config)
    traffic = _load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(BENCH_DIR / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name) and m["moves"] in reported]
    return Cell(name=name, config=config, traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, chips=int(w["chips"]))


def metric_reader(name: str) -> ModuleType:
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", f"bench_metric_{name}")


def kernel_count(kernel: str) -> ModuleType:
    return load_module(BENCH_DIR / "kernels" / f"{kernel}.py", f"bench_kernel_{kernel}")


def kernel_names() -> List[str]:
    """Every kernel count's id (`kernels/<id>.py`), sorted."""
    return sorted(p.stem for p in (BENCH_DIR / "kernels").glob("*.py"))


def trunk_file(cfg: dict) -> Path:
    """`trunks/<trunk>.py` of the trunk family the configuration names;
    stops the run where the configuration names none or the file is not
    there."""
    name = cfg.get("trunk")
    if name is None:
        raise SystemExit(f"configuration {cfg.get('name')!r} names no trunk family: it needs a "
                         f'key "trunk" that names a file benchmark/trunks/<trunk>.py')
    path = BENCH_DIR / "trunks" / f"{name}.py"
    if not re.fullmatch(r"[A-Za-z0-9_]+", str(name)) or not path.is_file():
        raise SystemExit(f"configuration {cfg.get('name')!r} names trunk {name!r}, but there is "
                         f"no file benchmark/trunks/{name}.py")
    return path


def trunk(cfg: dict) -> ModuleType:
    """The configuration's trunk family: `state(cfg, gen, device)` (the
    seeded state dict in the upstream layout), `check_widths(encoder, cfg)`,
    `reference(sd, cfg, control)` (the plain trunk, with
    `patch_features(images_u8, mean, std)` → [N, P, D] float32),
    `forward_work(cfg)` (one image's products as (FLOP, precision)) and
    `PUBLISHED` (each registry model's published widths, by `model_name`,
    which the tests hold every configuration to). Each
    file is loaded once, as a module is imported once."""
    return _trunk_module(trunk_file(cfg))


@functools.lru_cache(maxsize=None)
def _trunk_module(path: Path) -> ModuleType:
    return load_module(path, f"bench_trunk_{path.stem}")
