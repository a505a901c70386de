"""Each kernel count (`kernels/B*.py`) against a hand count at a small shape
and against PERF.md's bound at the cell's shape (the H100's 989 TFLOP/s
bf16 and 3.35 TB/s), the whole-step FLOP of the mfu metrics, and the kernel
files' launch counters on the launch line."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from conftest import BENCH_DIR, ROOT

from harness import flops, spec

NF = spec.load_cell("deit_nf.score_b128", ROOT).config
MDN = spec.load_cell("deit_mdn.score_b128", ROOT).config


def bound_ms(flop, nbytes):
    return 1e3 * max(flop / 989e12, nbytes / 3.35e12)


def test_b1_hand_count_and_bound():
    b1 = spec.kernel_count("B1")
    # 1 image, 4 tokens, D=8 over 2 heads (hd 4): q·kᵀ and p·v 2·4·4·4 each a head
    assert b1.flop_bytes(1, 4, 8, 2) == (2 * 2 * (2 * 4 * 4 * 4), 4 * 4 * 8 * 2)
    assert b1.shapes(NF, 128) == (128, 198, 768, 12)
    assert bound_ms(*b1.flop_bytes(*b1.shapes(NF, 128))) == pytest.approx(0.0465, abs=5e-5)
    shape = SimpleNamespace(cfg=NF, batch=128, units=1)
    assert 1e3 * b1.least_seconds(12, shape) == pytest.approx(12 * 0.0465, rel=2e-3)


def test_b6_hand_count_and_bound():
    b6 = spec.kernel_count("B6")
    (f1, by1), (f2, by2) = b6.flop_bytes(2, 3, 5)  # rows 2, D 3, H 5
    assert f1 == f2 == 2 * 2 * 3 * 5
    assert by1 == (2 * 3 + 3 * 5 + 2 * 5) * 2 + 5 * 4
    assert by2 == (2 * 5 + 5 * 3 + 2 * 2 * 3) * 2 + 3 * 4
    pair = sum(bound_ms(f, b) for f, b in b6.flop_bytes(*b6.shapes(NF, 128)))
    assert b6.shapes(NF, 128) == (25344, 768, 3072)
    assert pair == pytest.approx(0.242, abs=1e-3)  # PERF.md §6: B6 0.242 ms, operations


def test_b7_hand_count_and_bound():
    b7 = spec.kernel_count("B7")
    assert b7.flop_bytes(2, 3) == (48.0, 2 * 2 * 3 * 2 + 2 * 3 * 4)
    assert bound_ms(*b7.flop_bytes(*b7.shapes(NF, 128))) == pytest.approx(0.0232, abs=1e-4)


def test_b2_b3_hand_count_and_bound():
    b2, b3 = spec.kernel_count("B2"), spec.kernel_count("B3")
    f2, _ = b2.flop_bytes(1, 2, 3)  # one token, D 2, K 3: two heads of 2·2·6
    assert f2 == 2 * (2 * 1 * 2 * 2 * 3)
    f3, _ = b3.flop_bytes(1, 2, 3)
    assert f3 == 2 * f2  # the recomputed products and the weight gradients
    assert b2.shapes(MDN, 128) == (25088, 768, 150)
    assert bound_ms(*b2.flop_bytes(*b2.shapes(MDN, 128))) == pytest.approx(8.98, abs=0.01)
    assert bound_ms(*b3.flop_bytes(*b3.shapes(MDN, 64))) == pytest.approx(8.98, abs=0.01)
    shape = SimpleNamespace(cfg=MDN, batch=64, units=5)
    assert 1e3 * b3.least_seconds(60, shape) == pytest.approx(5 * 8.98, abs=0.05)


@pytest.mark.parametrize("kernel,name,hit", [
    ("B1", "void (anonymous namespace)::attention_one_pass_kernel<64>(unsigned short const*)", True),
    ("B1", "void window_attention_bf16_kernel(unsigned short const*)", False),
    ("B6", "void (anonymous namespace)::gemm::gemm_bf16_kernel<0>(CUtensorMap_st)", True),
    ("B7", "void vitad_layer_norm::layer_norm_rows_kernel<32, 3>(unsigned short const*)", True),
    ("B2", "void (anonymous namespace)::wg::gmm_forward_wgmma_kernel<true>(CUtensorMap_st)", True),
    ("B3", "void (anonymous namespace)::wg::gmm_terms_wgmma_kernel<true, false>(CUtensorMap_st)",
     True),
    ("B3", "(anonymous namespace)::gemm::gmm_wgrad_wgmma_kernel(CUtensorMap_st)", True),
    ("B3", "void (anonymous namespace)::wg::gmm_forward_wgmma_kernel<true>(CUtensorMap_st)", False),
])
def test_kernel_name_patterns(kernel, name, hit):
    import re

    assert bool(re.search(spec.kernel_count(kernel).PATTERN, name)) is hit


def test_whole_step_flop():
    trunk = sum(f for f, _ in spec.trunk(NF).forward_work(NF))
    block = 2 * 198 * 768 * 2304 + 4 * 198 * 198 * 768 + 2 * 198 * 768 * 768 \
        + 4 * 198 * 768 * 3072
    assert trunk == 2 * 196 * 768 * 768 + 12 * block  # ~35.3 GFLOP an image
    assert trunk / 1e9 == pytest.approx(35.31, abs=0.01)
    flow = sum(f for f, _ in flops.flow_forward(NF))
    assert flow / 1e9 == pytest.approx(2.754, abs=0.001)
    mdn = sum(f for f, _ in flops.mdn_forward(MDN))
    assert mdn == 196 * (2 * 768 * 150 + 4 * 768 * 768 * 150)
    assert sum(f for f, _ in flops.mdn_train(MDN)) == 2 * mdn
    # least time an image: bf16 trunk at 989 TFLOP/s, f32 flow at 67
    assert flops.least_seconds(flops.per_image(NF, "score")) == pytest.approx(
        trunk / 989e12 + flow / 67e12)


# `flops.per_image` of each configuration and kind, as the harness counted
# them while the DeiT trunk's count sat in `harness/flops.py`
PER_IMAGE = {
    ("deit_nf.score_b128", "score"): [(231211008.0, "bfloat16"), (35079340032.0, "bfloat16"),
                                      (2754662400.0, "float32")],
    ("deit_nf.score_b128", "train"): [(8181347328.0, "float32")],
    ("deit_mdn.score_b128", "score"): [(231211008.0, "bfloat16"), (35079340032.0, "bfloat16"),
                                       (45158400.0, "float32"), (69363302400.0, "bfloat16")],
    ("deit_mdn.score_b128", "train"): [(90316800.0, "float32"), (138726604800.0, "bfloat16")],
}


@pytest.mark.parametrize("cell,kind", sorted(PER_IMAGE))
def test_per_image_work_is_unchanged(cell, kind):
    cfg = spec.load_cell(cell, ROOT).config
    assert flops.per_image(cfg, kind) == PER_IMAGE[cell, kind]


def test_kernel_files_put_their_counters_on_the_launch_line(tmp_path, monkeypatch):
    """The launch line's counters are those that kernel files name, sorted
    by label: F1's among them, and a new kernel file's with no edit to the
    harness."""
    import shutil

    from harness import runner
    from vit_ad_tpu_torch.ops.cuda import flow, gmm

    labels = ["B1", "B2", "B3", "B4", "B6", "B6_wgmma", "B7", "F1"]
    counters = runner.launch_counters()
    assert list(counters) == labels
    assert counters["F1"] == (flow, "launches") and counters["B4"] == (gmm, "bwd_x_launches")
    assert runner.launch_counts(counters)["F1"] == flow.launches
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "kernels" / "Z9.py").write_text(
        'COUNTERS = {"Z9": "vit_ad_tpu_torch.ops.cuda.gmm.fwd_wgmma_launches"}\n')
    monkeypatch.setattr(spec, "BENCH_DIR", bench)
    assert list(runner.launch_counters()) == labels + ["Z9"]
