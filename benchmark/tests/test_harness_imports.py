"""What a run loads and when it refuses to run: no module whose top-level
name, compared whole, is JAX's or the JAX package's (`vit_ad_tpu`; the
port's `vit_ad_tpu_torch` begins with it); no result without a card; no
result in a directory that holds only the benchmark."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "vit_ad_tpu"}

_RUN_AND_LIST = f"""
import sys, time, json
sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}, {str(BENCH_DIR / 'tests')!r}]
from conftest import run_tiny, tiny_cell
res = run_tiny(tiny_cell("deit_mdn.score_b128"), trace=True, seconds=0.4)
run_tiny(tiny_cell("deit_mdn.train_b64"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_a_run_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", _RUN_AND_LIST], capture_output=True,
                         text=True, cwd=ROOT, env=_env(), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "vit_ad_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        return  # the refusal is for machines without a card
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "deit_nf.score_b128",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=300)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


def test_benchmark_alone_is_refused(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "deit_nf.score_b128",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, env=_env(), timeout=300)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
