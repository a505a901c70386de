"""F1's count (`kernels/F1.py`) against a hand count at a small shape and
against its bound at the cell's shape (the H100's 3.35 TB/s: the launch is
bound by bytes), and its name pattern."""

from __future__ import annotations

import re
from types import SimpleNamespace

import pytest
from conftest import ROOT

from harness import spec

NF = spec.load_cell("deit_nf.score_b128", ROOT).config


def test_f1_hand_count():
    f1 = spec.kernel_count("F1")
    # 2 images, C = 5 (c1 3, c2 2), 4 pixels: x1, x2, a (2·c2) in, C out; the
    # global scale and offset (f32) and perm (int64) of 5 channels; 2 logdets
    flop, nbytes = f1.flop_bytes(2, 5, 4)
    assert flop == 2 * 4 * (20 * 2 + 2 * 3)
    assert nbytes == 2 * 4 * 4 * (3 + 2 + 4 + 5) + 5 * (4 + 4 + 8) + 2 * 4


def test_f1_bound_at_the_cell_shape():
    f1 = spec.kernel_count("F1")
    assert f1.shapes(NF, 128) == (128, 768, 196)
    flop, nbytes = f1.flop_bytes(*f1.shapes(NF, 128))
    assert nbytes / 1e6 == pytest.approx(231.2, abs=0.1)
    assert flop / 67e12 < nbytes / 3.35e12  # bound by bytes
    assert 1e3 * nbytes / 3.35e12 == pytest.approx(0.069, abs=5e-4)
    shape = SimpleNamespace(cfg=NF, batch=128, units=1)
    assert 1e3 * f1.least_seconds(20, shape) == pytest.approx(20 * 0.0690, rel=2e-3)


@pytest.mark.parametrize("name,hit", [
    ("void (anonymous namespace)::flow_coupling_kernel<4>((anonymous namespace)::Args)", True),
    ("void (anonymous namespace)::flow_coupling_kernel<1>((anonymous namespace)::Args)", True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     False),
])
def test_f1_name_pattern(name, hit):
    assert bool(re.search(spec.kernel_count("F1").PATTERN, name)) is hit
