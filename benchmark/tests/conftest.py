"""Tests of the benchmark harness. Run from the repository root:

    python -m pytest benchmark/tests -q

Those marked `card` need a CUDA card and skip without one; run them on the
card with `python -m pytest benchmark/tests -q -m card`."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def tiny_cell(name: str, root: Path = ROOT, **config):
    """Cell `name` of `<root>/BENCHMARK.json` at a size the CPU holds: 32-px
    images (the published widths, 4 patches at patch 16), K=4, batches of 4,
    two pool batches, 12 training images. `config` overrides configuration
    keys."""
    from harness import spec

    cell = copy.deepcopy(spec.load_cell(name, root))
    cell.config.update({"img_size": 32, "num_gaussians": 4, **config})
    if cell.kind == "score":
        cell.traffic.update(batch=4, pool_batches=2, trace_seconds=0.3)
    else:
        cell.traffic.update(batch=4, train_images=12, extract_batch=4, trace_seconds=0.3)
    return cell


def run_tiny(cell, seed: int = 2**31 + 7, seconds: float = 0.5, trace: bool = False):
    import torch

    from harness import runner

    return runner.run(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                      log=lambda s: None)
