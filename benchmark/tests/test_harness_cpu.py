"""Each cell's path at a size the CPU holds, through the port's plain
versions of its kernels, against the reference; the check's faults, planted
under the timed path, and the lower-precision control must come out as not
correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import run_tiny, tiny_cell

from harness import check, runner

SCORE = ["deit_nf.score_b128", "deit_mdn.score_b128"]
TRAIN = ["deit_mdn.train_b64"]


def _nf_train():
    """The NF head on the training path (no cell of its own yet): the MDN
    training traffic with the NF configuration and its training settings."""
    cell = tiny_cell("deit_mdn.train_b64")
    nf = tiny_cell("deit_nf.score_b128")
    cell.config = nf.config
    cell.traffic["noise"] = False
    cell.limits = {"loss_gap": 0.01, "grad_gap": 0.025, "change_gap": 0.15}  # this size's own
    return cell


@pytest.mark.parametrize("name", SCORE + TRAIN + ["nf_train"])
def test_tiny_run_matches_reference(name):
    cell = _nf_train() if name == "nf_train" else tiny_cell(name)
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(cell.limits)
    e2e = {m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) == e2e
    assert res["device"]["platform"] == "cpu"  # never written as a device reading


def test_traced_tiny_run_prints_per_layer_metrics():
    cell = tiny_cell("deit_mdn.score_b128")
    res = run_tiny(cell, seconds=0.6, trace=True)
    assert res["correct"]
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "enqueue_ms.score" in res["metrics"]  # the CPU has no device events
    assert "batch_p95_ms.score" in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res


@pytest.mark.parametrize("name", SCORE + TRAIN)
def test_batch_p95_reads_the_untraced_latencies(name):
    """`batch_p95_ms.score` is the end-to-end p95's statistic over the
    untraced batches, and nothing in a training cell or without batches."""
    from harness import spec
    from harness.reading import Reading

    cell = tiny_cell(name)
    latency = [0.030 + 0.001 * (i % 17) for i in range(200)]
    read = spec.metric_reader("batch_p95_ms.score").read
    r = Reading(cell=cell, trace=None, units=0, images=0, enqueue_s=[], latency_s=latency)
    if cell.kind == "score":
        assert read(r) == pytest.approx(1e3 * np.percentile(latency, 95))
    else:
        assert read(r) is None
    assert read(Reading(cell=cell, trace=None, units=0, images=0, enqueue_s=[])) is None


def test_same_seed_same_inputs():
    from harness import images, weights

    a = images.make_pool(2, 3, 32, 0.5, 123, torch.device("cpu"))
    b = images.make_pool(2, 3, 32, 0.5, 123, torch.device("cpu"))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    cfg = tiny_cell("deit_mdn.score_b128").config
    s1, s2 = weights.make_states(cfg, 2**31 + 5, "cpu"), weights.make_states(cfg, 2**31 + 5,
                                                                                 "cpu")
    assert all(torch.equal(s1[1][k], s2[1][k]) for k in s1[1])


def test_fault_answer_altered(monkeypatch):
    """A score altered where it is produced."""
    import vit_ad_tpu_torch.scoring as scoring

    real = scoring.scores_tail

    def bent(*args, **kwargs):
        tail = real(*args, **kwargs)
        return lambda payload: tail(payload) + torch.tensor([0.01, 0, 0, 0])

    monkeypatch.setattr(scoring, "scores_tail", bent)
    res = run_tiny(tiny_cell("deit_nf.score_b128"))
    assert not res["correct"] and res["checks"]["score_gap"]["value"] > 0.009


def test_fault_payload_altered(monkeypatch):
    """One patch's log-likelihood altered where the MDN head produces it."""
    from vit_ad_tpu_torch.models.mdn import GaussianMDN

    real = GaussianMDN.log_likelihood

    def bent(self, x, generator=None, tau=1.0):
        ll = real(self, x, generator, tau).clone()
        ll[0, 0] += 0.5  # one patch of one image
        return ll

    monkeypatch.setattr(GaussianMDN, "log_likelihood", bent)
    res = run_tiny(tiny_cell("deit_mdn.score_b128"))
    assert not res["correct"] and res["checks"]["payload_gap"]["value"] > 0.06, res["checks"]


@pytest.mark.parametrize("name", TRAIN + ["nf_train"])
def test_fault_state_unchanged(name, monkeypatch):
    """A step that returns its state unchanged: the optimizer never steps."""
    from vit_ad_tpu_torch.pipeline import train as T

    def no_step(opt, loss, mc=None):
        opt.zero_grad(set_to_none=True)
        out = loss()
        out.backward()
        return out.detach()

    monkeypatch.setattr(T, "optimizer_step", no_step)
    cell = _nf_train() if name == "nf_train" else tiny_cell(name)
    res = run_tiny(cell)
    assert not res["correct"] and res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN + ["nf_train"])
def test_fault_half_batch(name, monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from vit_ad_tpu_torch.pipeline import train as T

    real = T._masked_mean

    def half(per_example, valid, mc=None):
        h = per_example.shape[0] // 2
        return real(per_example[:h], valid[:h], mc)

    monkeypatch.setattr(T, "_masked_mean", half)
    cell = _nf_train() if name == "nf_train" else tiny_cell(name)
    res = run_tiny(cell)
    assert not res["correct"], res["checks"]


def test_fault_pi_head_unmoved(monkeypatch):
    """The MDN's pi head left out of the update: its gradient dropped
    before the optimizer steps, so Adam leaves its two small leaves as they
    are. Judged leaf by leaf on each leaf's own norm, it reads 1."""
    from vit_ad_tpu_torch.pipeline import train as T

    def drop_pi(opt, loss, mc=None):
        opt.zero_grad(set_to_none=True)
        out = loss()
        out.backward()
        for group in opt.param_groups:
            for p in group["params"]:
                if p.shape[0] == 4:  # pi.weight [K, D], pi.bias [K] at K=4
                    p.grad = None
        opt.step()
        return out.detach()

    monkeypatch.setattr(T, "optimizer_step", drop_pi)
    res = run_tiny(tiny_cell("deit_mdn.train_b64"))
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert res["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_fault_gumbel_noise_left_out(monkeypatch):
    """The Gumbel noise left out of the MDN's pi logits while training."""
    from vit_ad_tpu_torch.pipeline import train as T

    real = T.train_step

    def no_noise(loss_fn, head, opt, feats, valid, generator, mc=None):
        return real(loss_fn, head, opt, feats, valid, None, mc)

    monkeypatch.setattr(T, "train_step", no_noise)
    res = run_tiny(tiny_cell("deit_mdn.train_b64"))
    assert not res["correct"], res["checks"]


def test_a_reader_that_loads_jax_stops_the_run(tmp_path, monkeypatch):
    """A per-layer metric's reader, loaded after the window, that imports a
    module named `jax` (a stub): the run ends with no result."""
    import shutil
    import sys

    from harness import spec

    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    (tmp_path / "bench" / "metrics").mkdir(parents=True)
    for files in ("trunks", "kernels"):  # the cell's trunk family and the launch line's
        shutil.copytree(spec.BENCH_DIR / files, tmp_path / "bench" / files)
    (tmp_path / "bench" / "metrics" / "planted.score.py").write_text(
        "import jax  # noqa: F401\n\n\ndef read(r):\n    return None\n")
    cell = tiny_cell("deit_mdn.score_b128")
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path / "bench")
    cell.per_layer = [{"name": "planted.score", "unit": "ms", "better": "lower",
                       "source": "device_trace", "layer": "MDN head",
                       "moves": "score_img_per_s"}]
    assert "jax" not in sys.modules
    try:
        with pytest.raises(SystemExit, match="jax"):
            run_tiny(cell, seconds=0.4, trace=True)
        assert sys.modules["jax"].__file__.startswith(str(tmp_path))
    finally:
        sys.modules.pop("jax", None)


@pytest.mark.parametrize("name", SCORE + TRAIN)
def test_control_fails_the_check(name):
    """The reference one precision below the configuration, in the
    program's place, reads above the cell's limits (the chip's readings on
    three seeds at the cell's size are in PERF.md)."""
    cell = tiny_cell(name)
    for seed in (11, 12, 13):
        cells = runner.KINDS[cell.kind](cell, seed, torch.device("cpu"), program=False)
        out = cells.control()
        if cell.kind == "train":
            for fault in ("control", "half_batch", "pi_unmoved", "gumbel_off"):
                correct, _ = check.verdict(out[fault], cell.limits)
                assert not correct, (fault, out[fault])
            continue
        correct, _ = check.verdict(out, cell.limits)
        assert not correct, out


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    assert "vit_ad_tpu_torch" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vit_ad_tpu.scoring", types.ModuleType("x"))
    assert runner.forbidden_modules() == ["vit_ad_tpu"]
