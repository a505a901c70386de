#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vit_ad_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths on a full-width DeiT-base/16 trunk, bf16
compute, through the port's CLIs, after building and checking the
hand-written kernels: the flagship serving path (score a folder with an NF-20
head) and the MDN path (train a K=150 GMM head on cached features, save it,
score a folder with it). Phases:

  1. device   card name and power limit (nvidia-smi)
  2. build    compile the kernels from vit_ad_tpu_torch/csrc (nvcc, sm_90a)
  3. kernels  each kernel against its plain PyTorch version on the card:
              attention (B1), GMM forward (B2), its parameter and feature
              backwards (B3, B4)
  4. NF path  40 synthetic 224-px PNGs scored by `cli.score.main` with seeded
              random full-width weights; launch counts; CUDA-vs-CPU f32 scores
  5. MDN path a synthetic category: `cli.train_mdn.main` (K=150, a few
              epochs), then `cli.score.main -a mdn` on its .pth; launch
              counts per step and batch; CUDA-vs-CPU f32 scores
  6. times    kernels vs plain (B3 and B4 also checked at 64 x 196 rows);
              flagship NF and MDN uint8→scores img/s at batch 128; the MDN
              train step and its peak memory
  7. result   a kernels JSON line, the nvidia-smi line, and last the
              {"ok": true, "device": ...} line

Every phase raises on failure, so the script exits non-zero and prints no
result. Without a CUDA device it stops at once; there is no CPU fallback.
Imports nothing of JAX.
"""

from __future__ import annotations

import csv
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# Tolerances of the kernel-vs-plain comparisons (max abs difference).
# bf16: the kernel and the plain version sum scores and PV in other orders and
# round probabilities and outputs to bf16 (8 bits of mantissa); 2e-2 is ~2.5
# bf16 ulps of an output of magnitude 1, for unit-normal inputs.
# f32: summation order and expf only.
TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# Image scores of the f32 policy, card vs CPU, relative: f32 sums in other
# orders (cuBLAS/cuDNN vs CPU BLAS) through 12 blocks and 20 flow steps.
SCORE_RTOL_F32 = 1e-3
KERNEL_CASES = [  # (B, N, C, heads, dtype name)
    (4, 198, 768, 12, "bfloat16"), (3, 197, 768, 12, "bfloat16"),
    (4, 198, 768, 12, "float32"), (3, 197, 768, 12, "float32"),
    (2, 65, 128, 4, "bfloat16"), (2, 65, 128, 4, "float32"),  # hd = 32
    (16, 198, 768, 12, "bfloat16"),  # the main path's shape at -b 16
]
N_IMAGES, SMOKE_BATCH, FLAGSHIP_BATCH, TIMED_RUNS = 40, 16, 128, 20
# GMM kernels vs their plain version. ll: both sum exact products (bf16 x
# bf16, or f32) in f32 in other orders; an error of ~1e-6 in mu or pre is
# amplified by z/sigma (sigma down to ~0.05 for these heads), so
# |kernel - plain| <= LL_ATOL + LL_RTOL |plain|. Gradients, relative to the
# largest entry: f32 summation order only; under bf16 the kernels also round
# dmu/dpre to bf16 before the weight-gradient products, as the TPU kernel
# does, where the plain autograd keeps them f32 (2^-9 relative each).
LL_ATOL, LL_RTOL = 2e-3, 1e-5
GRAD_RTOL = {"bfloat16": 1e-2, "float32": 1e-4}
GMM_FWD_CASES = [  # (rows, D, K, dtype): the DeiT shape, the tiled widths, K=1
    (392, 768, 150, "bfloat16"), (392, 768, 150, "float32"),
    (200, 1024, 8, "bfloat16"), (200, 1024, 8, "float32"),
    (200, 2048, 4, "bfloat16"), (200, 2048, 4, "float32"),
    (392, 768, 1, "bfloat16"), (392, 768, 1, "float32"),
]
# backward: one chunk of components at 392 and 200 rows; the train step's
# 16 x 196 rows take 2 chunks under bf16 and 3 under f32 (ops/cuda/gmm.py
# `backward_chunk`), which run k0 > 0 and carry the dx sum across chunks
GMM_BWD_CASES = [(392, 768, 150, "bfloat16"), (392, 768, 150, "float32"),
                 (200, 1024, 8, "bfloat16"), (200, 2048, 4, "float32"),
                 (3136, 768, 150, "bfloat16"), (3136, 768, 150, "float32")]
# the MDN main path: K=150 (startTraining_mdn.py:33) on DeiT-base, D=768
MDN_K, MDN_TRAIN, MDN_TEST, MDN_EPOCHS, MDN_BATCH, MDN_SCORE_BATCH = 150, 32, 4, 3, 16, 4
MDN_TIMED_RUNS = 3


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0]


def median_ms(fn, torch, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median over `runs` of one call timed with CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gmm_inputs(rows: int, d: int, k: int, gen, dev):
    """Seeded GMM inputs on the card: x [1, rows, D], log_pi [1, rows, K] and
    Linear-layout heads scaled so mu and pre have std ~0.5 (sigma spans
    ~0.1..3, the density is far from flat)."""
    import torch

    r = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
    s = 0.5 / math.sqrt(d)
    x = r(1, rows, d)
    log_pi = torch.log(torch.softmax(r(1, rows, k), -1) + 1e-15)
    return [x, log_pi, r(d * k, d) * s, r(d * k) * 0.1, r(d * k, d) * s, r(d * k) * 0.1]


def check_gmm_forward(rows: int, d: int, k: int, dt: str, gen, dev) -> float:
    """B2 against the plain version on the same inputs; returns max |diff|."""
    import torch
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

    dtype = getattr(torch, dt)
    args = gmm_inputs(rows, d, k, gen, dev)
    before = cgmm.fwd_launches
    with torch.no_grad():
        got = cgmm.gmm_log_likelihood(*args, matmul_dtype=dtype)
        want = cgmm.gmm_log_likelihood_reference(*args, matmul_dtype=dtype)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = diff.max().item()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= LL_ATOL + LL_RTOL * want.abs()).all())
    print(f"gmm forward (B2) rows={rows} D={d} K={k} {dt}: max|kernel-plain| {err:.3e} "
          f"(tol {LL_ATOL:.0e} + {LL_RTOL:.0e}|plain|), |plain| <= {want.abs().max().item():.2f}, "
          f"launches +{cgmm.fwd_launches - before}")
    if not ok or cgmm.fwd_launches != before + 1:
        raise AssertionError(f"GMM forward kernel disagrees with its plain version: {err}")
    return err


def check_gmm_backward(rows: int, d: int, k: int, dt: str, gen, dev) -> float:
    """B3 (log_pi, weight and bias gradients) and B4 (dx, x requiring grad)
    against autograd of the plain version; returns the largest relative
    error."""
    import torch
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

    dtype = getattr(torch, dt)
    chunks = -(-k // cgmm.backward_chunk(rows, d, k, dtype))
    args = [t.requires_grad_(True) for t in gmm_inputs(rows, d, k, gen, dev)]
    c = torch.randn(1, rows, d, device=dev, generator=gen)
    names = ("x", "log_pi", "w_sigma", "b_sigma", "w_mu", "b_mu")
    before = (cgmm.bwd_params_launches, cgmm.bwd_x_launches)
    got = torch.autograd.grad((cgmm.gmm_log_likelihood(*args, matmul_dtype=dtype) * c).sum(),
                              args)
    launched = (cgmm.bwd_params_launches - before[0], cgmm.bwd_x_launches - before[1])
    want = torch.autograd.grad(
        (cgmm.gmm_log_likelihood_reference(*args, matmul_dtype=dtype) * c).sum(), args)
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, w in zip(names, got, want):
        rel = ((g - w).abs().max() / w.abs().max()).item()
        worst = max(worst, rel)
        print(f"  gmm backward {'B4' if name == 'x' else 'B3'} d{name} rows={rows} D={d} K={k} "
              f"{dt} ({chunks} chunks): max|kernel-plain|/max|plain| {rel:.3e} "
              f"(tol {GRAD_RTOL[dt]:.0e})")
        if not (math.isfinite(rel) and rel <= GRAD_RTOL[dt]):
            raise AssertionError(f"GMM backward kernel disagrees on d{name}: {rel}")
    # per chunk: B3's terms and weights kernels, B4's dx kernel
    if launched != (2 * chunks, chunks):
        raise AssertionError(f"GMM backward launched (B3, B4) {launched}, expected "
                             f"{(2 * chunks, chunks)}")
    return worst


def plain_mdn_loss(mdn, feats, valid, generator):
    """`pipeline.train.masked_mdn_loss` through the plain version of the GMM
    kernels (for timing the step against the kernels)."""
    import torch
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

    ll = cgmm.gmm_log_likelihood_reference(feats, mdn.log_pi(feats, generator),
                                           mdn.sigma.weight, mdn.sigma.bias, mdn.mu.weight,
                                           mdn.mu.bias, mdn.dtypes.compute_dtype)
    per_example = -torch.mean(ll, dim=(1, 2))
    return torch.sum(per_example * valid) / torch.clamp(torch.sum(valid), min=1.0)


def alternate(kern, plain, runs: int, warmup: int):
    """Median ms of kernel and plain in the order plain, kernel, kernel,
    plain; returns (kernel list, plain list)."""
    import torch

    plain_ms = [median_ms(plain, torch, runs, warmup)]
    kern_ms = [median_ms(kern, torch, runs, warmup), median_ms(kern, torch, runs, warmup)]
    plain_ms.append(median_ms(plain, torch, runs, warmup))
    return kern_ms, plain_ms


def reset_launches() -> None:
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    wa.launches = cgmm.fwd_launches = cgmm.bwd_params_launches = cgmm.bwd_x_launches = 0


def read_launches() -> dict:
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    return {"B1": wa.launches, "B2": cgmm.fwd_launches, "B3": cgmm.bwd_params_launches,
            "B4": cgmm.bwd_x_launches}


def mdn_main_path(tmp: str) -> dict:
    """Phase 5: train a K=150 MDN head on a synthetic 224-px category with
    `cli.train_mdn`, score its test folder with `cli.score -a mdn`, and check
    the launch counts of both runs and the f32 scores against the CPU."""
    import glob

    import numpy as np
    import torch
    from vit_ad_tpu_torch.cli import score as score_cli
    from vit_ad_tpu_torch.cli import train_mdn as train_cli
    from vit_ad_tpu_torch.config import DtypePolicy
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.data.synthetic import make_mvtec_category
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models, score_models

    cat = make_mvtec_category(tmp, "widget", img_size=224, n_train=MDN_TRAIN,
                              n_test_good=MDN_TEST, n_test_defect=MDN_TEST)
    test_dir = os.path.join(cat, "test")
    run = os.path.join(tmp, "mdn_run")
    split = DataPipeline(MDN_BATCH, 224, base_path=cat, data_path="train/good")
    n_batches = lambda n, b: -(-n // b)
    n_tr = n_batches(len(split.train_files), MDN_BATCH)
    n_va = n_batches(len(split.valid_files), MDN_BATCH)
    n_te = n_batches(2 * MDN_TEST, MDN_BATCH)

    reset_launches()
    t0 = time.perf_counter()
    rc = train_cli.main(["-d", cat, "-t", "train/good", "-v", "test", "-n", str(MDN_K),
                         "-e", str(MDN_EPOCHS), "-p", str(MDN_EPOCHS), "-b", str(MDN_BATCH),
                         "-i", "224", "--device", "cuda", "--out", run])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train = read_launches()
    with open(os.path.join(run, "history.json")) as f:
        hist = json.load(f)
    ep = hist["epochs_ran"]
    # every train step: one forward and a parameter backward of two kernels
    # per chunk of components (padded batches: always MDN_BATCH x 196 rows);
    # the noiseless validation loss and the final evaluation: forwards only;
    # frozen trunk: no feature gradient
    chunks = -(-MDN_K // cgmm.backward_chunk(MDN_BATCH * 196, 768, MDN_K,
                                             DtypePolicy().compute_dtype))
    expect = {"B1": 12 * (n_tr + n_va + n_te), "B2": ep * (n_tr + n_va) + n_te,
              "B3": ep * n_tr * 2 * chunks, "B4": 0}
    print(f"cli.train_mdn.main rc={rc} in {wall:.2f} s ({ep} epochs x {n_tr} train + {n_va} "
          f"valid batches of {MDN_BATCH}, {n_te} test batch; {chunks} backward chunks): "
          f"launches {train}, expected {expect}")
    if rc != 0 or train != expect:
        raise AssertionError("the MDN training path did not launch B2 and B3 on every step "
                             "(and B4 on none)")
    metrics = hist["metrics"]
    if not all(math.isfinite(v) for v in hist["train_loss"] + hist["valid_loss"]) or \
            not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite losses or metrics: {hist}")
    print(f"train loss {hist['train_loss']}, valid loss {hist['valid_loss']}, "
          f"metrics {metrics} (random trunk and head: information only)")
    (pth,) = glob.glob(os.path.join(run, f"{MDN_K}_gaussians_enc_deit_*.pth"))

    out_dir = os.path.join(tmp, "mdn_scores")
    reset_launches()
    t0 = time.perf_counter()
    rc = score_cli.main(["--pth", pth, "-a", "mdn", "-m", "enc_deit", "-d", test_dir,
                         "-b", str(MDN_SCORE_BATCH), "-o", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    score = read_launches()
    nb = n_batches(2 * MDN_TEST, MDN_SCORE_BATCH)
    expect = {"B1": 12 * nb, "B2": nb, "B3": 0, "B4": 0}
    print(f"cli.score.main -a mdn rc={rc} in {wall:.2f} s: launches {score}, expected {expect}")
    if rc != 0 or score != expect:
        raise AssertionError("MDN scoring did not launch B2 once per batch")
    files = score_cli.list_images(test_dir)
    with open(os.path.join(out_dir, "scores.csv")) as f:
        rows = list(csv.reader(f))[1:]
    scores = np.array([float(r[1]) for r in rows])
    if [r[0] for r in rows] != files or not np.all(np.isfinite(scores)):
        raise AssertionError("MDN scores.csv does not hold one finite row per image")
    print(f"scores.csv: {len(rows)} rows, all finite, min {scores.min():.6f} "
          f"max {scores.max():.6f}")

    mean, std = default_norm_stats()
    two = files[:2]
    got = {}
    for device, dtypes in (("cuda", DtypePolicy.f32()), ("cpu", DtypePolicy.f32()),
                           ("cuda bf16", DtypePolicy())):
        m = build_pth_models(pth, "enc_deit", "mdn", dtypes=dtypes, device=device.split()[0])
        got[device] = score_models(m, DataPipeline(2, 224, files=two), mean, std).image_scores
    rel = np.abs(got["cuda"] - got["cpu"]) / np.abs(got["cpu"])
    print(f"MDN f32 image scores cuda {got['cuda'].tolist()} cpu {got['cpu'].tolist()}: "
          f"max rel diff {rel.max():.3e} (rtol {SCORE_RTOL_F32:.0e})")
    if not rel.max() <= SCORE_RTOL_F32:
        raise AssertionError("CUDA f32 MDN scores disagree with the CPU path")
    bf16_rel = np.abs(got["cuda bf16"] - got["cpu"]) / np.abs(got["cpu"])
    print(f"MDN bf16 card scores vs f32 CPU scores (same 2 images): max rel diff "
          f"{bf16_rel.max():.3e} (information: bf16 policy drift)")
    launches = {k: train[k] + score[k] for k in train}
    return {"launches": launches, "pth": pth}


def mdn_times(mdn: dict, images, card: str, gen) -> dict:
    """Phase 6, MDN part: B2 at batch 128, the train step (B2 + B3) at 32
    and 64 with its peak memory, B3 and B4 alone by difference, MDN
    uint8→scores img/s. Returns the kernels' JSON numbers; raises if B3 or
    B4 disagrees with the plain version at B=64 (6 chunks of components)."""
    import numpy as np
    import torch
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm
    from vit_ad_tpu_torch.pipeline.eval import make_mdn_batch_fn
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models
    from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
    from vit_ad_tpu_torch.pipeline.train import mdn_train_step
    from vit_ad_tpu_torch.scoring import payload_to_scores

    dev, bf16, d = torch.device("cuda"), torch.bfloat16, 768
    runs = MDN_TIMED_RUNS
    out = {}
    rows = FLAGSHIP_BATCH * 196
    for k in (100, MDN_K):
        args = gmm_inputs(rows, d, k, gen, dev)
        kern = lambda: cgmm.gmm_log_likelihood(*args, matmul_dtype=bf16)
        plain = lambda: cgmm.gmm_log_likelihood_reference(*args, matmul_dtype=bf16)
        with torch.no_grad():
            err = (kern() - plain()).abs().max().item()
            kern_ms, plain_ms = alternate(kern, plain, runs, 1)
        tflop = 4 * rows * d * d * k / 1e12
        print(f"[{card}] gmm forward (B2) B={FLAGSHIP_BATCH} rows={rows} D={d} K={k} bf16: "
              f"kernel {kern_ms} ms ({tflop / statistics.mean(kern_ms) * 1e3:.1f} TFLOP/s), "
              f"plain {plain_ms} ms (order plain, kernel, kernel, plain); "
              f"max|kernel-plain| {err:.3e}")
        out["B2"] = {"max_abs_err": err, "ms": statistics.mean(kern_ms),
                     "plain_ms": statistics.mean(plain_ms)}
        del args

    m = build_pth_models(mdn["pth"], "enc_deit", "mdn", device=dev)
    encoder, head = m.parts
    for b in (32, 64):
        feats = torch.randn(b, 196, d, device=dev, generator=gen)
        valid = torch.ones(b, device=dev)
        opt = torch_adam(head.parameters(), 7e-4, 7e-4)
        noise = torch.Generator(device=dev).manual_seed(0)
        kern = lambda: mdn_train_step(head, opt, feats, valid, noise)

        def plain():
            opt.zero_grad(set_to_none=True)
            plain_mdn_loss(head, feats, valid, noise).backward()
            opt.step()

        peaks = []
        for fn in (kern, plain):
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        kern_ms, plain_ms = alternate(kern, plain, runs, 1)
        print(f"[{card}] MDN train step (B2 + B3 + pi head + Adam) B={b} D={d} K={MDN_K} "
              f"bf16: kernel {kern_ms} ms = {b / statistics.mean(kern_ms) * 1e3:.1f} img/s, "
              f"plain {plain_ms} ms = {b / statistics.mean(plain_ms) * 1e3:.1f} img/s; peak "
              f"memory kernel {peaks[0]:.2f} GiB, plain {peaks[1]:.2f} GiB")

    # B3 and B4 alone, by difference of forward, forward + backward and
    # forward + backward with dx, at B=64 (6.4 TFLOP per product set)
    b = 64
    x = torch.randn(1, b * 196, d, device=dev, generator=gen)
    log_pi = torch.log(torch.softmax(torch.randn(1, b * 196, MDN_K, device=dev, generator=gen),
                                     -1) + 1e-15).requires_grad_(True)
    c = torch.randn(1, b * 196, d, device=dev, generator=gen)
    params = [log_pi, head.sigma.weight, head.sigma.bias, head.mu.weight, head.mu.bias]
    xg = x.clone().requires_grad_(True)
    grads = {}
    for version, fn in (("kernel", cgmm.gmm_log_likelihood),
                        ("plain", cgmm.gmm_log_likelihood_reference)):
        ll = lambda xx: fn(xx, log_pi, head.sigma.weight, head.sigma.bias, head.mu.weight,
                           head.mu.bias, matmul_dtype=bf16)

        def fwd():
            with torch.no_grad():
                return ll(x)

        bwd = lambda: torch.autograd.grad((ll(x) * c).sum(), params)
        bwd_x = lambda: torch.autograd.grad((ll(xg) * c).sum(), params + [xg])
        grads[version] = bwd_x()
        grads[version + " ms"] = [median_ms(f, torch, runs, 1) for f in (fwd, bwd, bwd_x)]
    errs = [(g - w).abs().max().item() for g, w in zip(grads["kernel"], grads["plain"])]
    for key, idx, what in (("B3", 1, "parameter backward"), ("B4", 2, "feature backward")):
        k_ms = grads["kernel ms"][idx] - grads["kernel ms"][idx - 1]
        p_ms = grads["plain ms"][idx] - grads["plain ms"][idx - 1]
        idx_g = range(5) if key == "B3" else [5]
        err = max(errs[i] for i in idx_g)
        rel = max(errs[i] / grads["plain"][i].abs().max().item() for i in idx_g)
        print(f"[{card}] gmm {what} ({key}) rows={b * 196} D={d} K={MDN_K} bf16, by "
              f"difference of medians: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
              f"(kernel fwd/+bwd/+dx {grads['kernel ms']}, plain {grads['plain ms']}); "
              f"max|kernel-plain| {err:.3e} ({rel:.3e} of max|plain|, tol "
              f"{GRAD_RTOL['bfloat16']:.0e})")
        if not (math.isfinite(rel) and rel <= GRAD_RTOL["bfloat16"]):
            raise AssertionError(f"{key} disagrees with its plain version at B={b}: {rel}")
        out[key] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}

    mean, std = default_norm_stats()
    as_t = lambda a: torch.as_tensor(a, device=dev)
    fn = make_mdn_batch_fn(encoder, head, m.hp, as_t(mean), as_t(std))

    def patch_ll():
        with torch.inference_mode():
            return fn(images)

    def scores():
        # the host score tail of score_mdn, per batch: normalization by the
        # batch's max, 224-px maps, inverted min patch probability
        return payload_to_scores("mdn", patch_ll().float().cpu().numpy(), 224)[0]

    ll = patch_ll()
    if ll.shape != (FLAGSHIP_BATCH, 196) or not torch.isfinite(ll).all():
        raise AssertionError("MDN scoring batch gave non-finite or misshapen output")
    s = scores()
    if s.shape != (FLAGSHIP_BATCH,) or not np.all(np.isfinite(s)):
        raise AssertionError("MDN score tail gave non-finite or misshapen scores")
    ll_ms = median_ms(patch_ll, torch, runs=5, warmup=1)
    # CUDA events around a call that ends on the host: the host tail counts
    score_ms = median_ms(scores, torch, runs=5, warmup=1)
    for what, ms in (("uint8→patch log-likelihoods, batch on the device", ll_ms),
                     ("uint8→scores, device part + host score tail", score_ms)):
        print(f"[{card}] MDN {what}: DeiT-base + MDN K={MDN_K} B={FLAGSHIP_BATCH} bf16: "
              f"{ms:.3f} ms/batch = {FLAGSHIP_BATCH / ms * 1e3:.1f} img/s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False — this smoke run "
                 "needs an NVIDIA GPU; there is no CPU fallback")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from PIL import Image

    from vit_ad_tpu_torch.cli import score as score_cli
    from vit_ad_tpu_torch.config import DtypePolicy, set_numerics_policy
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.models.flow import NormalizingFlow
    from vit_ad_tpu_torch.ops.cuda import build
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa
    from vit_ad_tpu_torch.pipeline.eval import make_nf_batch_fn
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models, score_models
    from vit_ad_tpu_torch.registry import get_model

    set_numerics_policy()
    dev = torch.device("cuda")

    phase("1 device")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()}")
    print(card, flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    print(f"built and loaded {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in lib_path.with_name(lib_path.name + ".log").read_text().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    phase("3 kernels vs plain")
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, n, c, h, dt in KERNEL_CASES:
        dtype = getattr(torch, dt)
        qkv = torch.randn(b, n, 3 * c, device=dev, generator=gen).to(dtype)
        before = wa.launches
        out = wa.vit_attention_qkv(qkv, h)
        ref = wa.vit_attention_qkv_reference(qkv, h)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = math.isfinite(err) and err <= TOL[dt] and wa.launches == before + 1
        print(f"vit_attention_qkv B={b} N={n} C={c} H={h} {dt}: max|kernel-plain| "
              f"{err:.3e} (tol {TOL[dt]:.0e}), launches +{wa.launches - before}")
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: {err}")
    # backward: recomputation through the plain version, so the gradient must
    # equal autograd of the plain version
    x = torch.randn(2, 6, 3 * 64, device=dev, generator=gen, requires_grad=True)
    g = torch.randn(2, 6, 64, device=dev, generator=gen)
    (gx,) = torch.autograd.grad(wa.vit_attention_qkv(x, 2), x, g)
    (gr,) = torch.autograd.grad(wa.vit_attention_qkv_reference(x, 2), x, g)
    gerr = (gx - gr).abs().max().item()
    print(f"vit_attention_qkv backward vs plain autograd (f32, B=2 N=6 hd=32): "
          f"max diff {gerr:.3e} (tol 1e-6)")
    if not gerr <= 1e-6:
        raise AssertionError(f"backward disagrees with the plain version: {gerr}")
    for case in GMM_FWD_CASES:
        check_gmm_forward(*case, gen, dev)
    for case in GMM_BWD_CASES:
        check_gmm_backward(*case, gen, dev)
    torch.cuda.synchronize()

    phase("4 main path: DeiT-base + NF-20 scoring through the CLI")
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        yy, xx = np.mgrid[0:224, 0:224]
        for i in range(N_IMAGES):
            base = (rng.integers(0, 256, 3)[None, None, :]
                    + 40 * np.sin((xx + 7 * i)[..., None] / 9.0))
            img = np.clip(base + rng.normal(0, 12, (224, 224, 3)), 0, 255).astype(np.uint8)
            if i % 4 == 3:  # a bright square "defect" on every fourth image
                img[60 + i:100 + i, 80:120] = 255
            Image.fromarray(img).save(os.path.join(img_dir, f"img_{i:03d}.png"))
        deit_pth = os.path.join(tmp, "deit_base_distilled_patch16_224.pth")
        nf_pth = os.path.join(tmp, "nf_smoke_widget.pth")
        torch.save(get_model("enc_deit", 224, generator=torch.Generator().manual_seed(1))
                   .state_dict(), deit_pth)
        torch.save(NormalizingFlow(768, 224, 196, hidden_ratio=0.16, flow_steps=20,
                                   generator=torch.Generator().manual_seed(2)).state_dict(),
                   nf_pth)
        out_dir = os.path.join(tmp, "scores")
        argv = ["--pth", nf_pth, "-a", "nf", "-m", "enc_deit", "-E", deit_pth,
                "-d", img_dir, "-b", str(SMOKE_BATCH), "-o", out_dir]
        wa.launches = 0
        t0 = time.perf_counter()
        rc = score_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nf_launches = wa.launches
        n_batches = -(-N_IMAGES // SMOKE_BATCH)
        print(f"cli.score.main rc={rc} in {wall:.2f} s (model load included); "
              f"attention launches {nf_launches}, expected 12 x {n_batches} batches "
              f"= {12 * n_batches}")
        if rc != 0 or nf_launches != 12 * n_batches:
            raise AssertionError("main path did not launch the attention kernel "
                                 "once per block per batch")
        with open(os.path.join(out_dir, "scores.csv")) as f:
            rows = list(csv.reader(f))[1:]
        files = score_cli.list_images(img_dir)
        scores = np.array([float(r[1]) for r in rows])
        if [r[0] for r in rows] != files or not np.all(np.isfinite(scores)):
            raise AssertionError("scores.csv does not hold one finite row per image")
        print(f"scores.csv: {len(rows)} rows, all finite, min {scores.min():.6f} "
              f"max {scores.max():.6f}")

        # the same two images with the f32 policy on the card and on the CPU
        mean, std = default_norm_stats()
        two = files[:2]
        f32_scores = {}
        for device in ("cuda", "cpu"):
            m = build_pth_models(nf_pth, "enc_deit", "nf", encoder_ckpt=deit_pth,
                                 dtypes=DtypePolicy.f32(), device=device)
            s = score_models(m, DataPipeline(2, 224, files=two), mean, std)
            f32_scores[device] = s.image_scores
        rel = np.abs(f32_scores["cuda"] - f32_scores["cpu"]) / np.abs(f32_scores["cpu"])
        print(f"f32 image scores cuda {f32_scores['cuda'].tolist()} cpu "
              f"{f32_scores['cpu'].tolist()}: max rel diff {rel.max():.3e} "
              f"(rtol {SCORE_RTOL_F32:.0e})")
        if not rel.max() <= SCORE_RTOL_F32:
            raise AssertionError("CUDA f32 scores disagree with the CPU path")
        bf16_rel = np.abs(scores[:2] - f32_scores["cpu"]) / np.abs(f32_scores["cpu"])
        print(f"bf16 card scores vs f32 CPU scores (same 2 images): max rel diff "
              f"{bf16_rel.max():.3e} (information: bf16 policy drift)")

        phase("5 main path: DeiT-base + MDN K=150, train then score through the CLIs")
        mdn = mdn_main_path(tmp)

        phase("6 times (CUDA events, median of %d after warm-up)" % TIMED_RUNS)
        qkv = torch.randn(FLAGSHIP_BATCH, 198, 3 * 768, device=dev,
                          generator=gen).to(torch.bfloat16)
        err = (wa.vit_attention_qkv(qkv, 12).float()
               - wa.vit_attention_qkv_reference(qkv, 12).float()).abs().max().item()
        if not err <= TOL["bfloat16"]:
            raise AssertionError(f"kernel disagrees at batch {FLAGSHIP_BATCH}: {err}")
        kern = lambda: wa.vit_attention_qkv(qkv, 12)
        plain = lambda: wa.vit_attention_qkv_reference(qkv, 12)
        plain_ms = [median_ms(plain, torch)]
        kern_ms = [median_ms(kern, torch), median_ms(kern, torch)]
        plain_ms.append(median_ms(plain, torch))
        att_ms, att_plain_ms = statistics.mean(kern_ms), statistics.mean(plain_ms)
        print(f"[{card}] vit_attention_qkv B={FLAGSHIP_BATCH} N=198 C=768 H=12 bf16: "
              f"kernel {kern_ms} ms, plain {plain_ms} ms (order plain, kernel, kernel, "
              f"plain); max|kernel-plain| {err:.3e}")

        m = build_pth_models(nf_pth, "enc_deit", "nf", encoder_ckpt=deit_pth, device=dev)
        encoder, flow = m.parts
        as_t = lambda a: torch.as_tensor(a, device=dev)
        fn = make_nf_batch_fn(encoder, flow, m.hp, as_t(mean), as_t(std))
        images = torch.from_numpy(np.stack(
            [np.asarray(Image.open(files[i % len(files)]).convert("RGB"))
             for i in range(FLAGSHIP_BATCH)])).to(dev)

        def flagship():
            with torch.inference_mode():
                maps = fn(images)
                return maps.amax(dim=(1, 2))

        out = flagship()
        if out.shape != (FLAGSHIP_BATCH,) or not torch.isfinite(out).all():
            raise AssertionError("flagship batch gave non-finite or misshapen scores")
        torch.cuda.reset_peak_memory_stats()
        batch_ms = median_ms(flagship, torch, runs=10)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[{card}] flagship uint8→scores DeiT-base+NF-20 B={FLAGSHIP_BATCH} bf16, "
              f"batch on the device: {batch_ms:.3f} ms/batch = "
              f"{FLAGSHIP_BATCH / batch_ms * 1e3:.1f} img/s; peak memory {peak:.2f} GiB")
        gmm_times = mdn_times(mdn, images, card, gen)
    torch.cuda.synchronize()

    phase("7 result")
    kernels = [{
        "name": "vit_attention_qkv",
        "route": "cuda",
        "source": "vit_ad_tpu_torch/csrc/vit_attention_qkv.cu",
        "replaces": "vit_ad_tpu/ops/pallas/window_attention.py:375",
        "launches": nf_launches,
        "max_abs_err": err,
        "ms": att_ms,
        "plain_ms": att_plain_ms,
    }]
    # launches are kernel launches: B3 counts its terms and weights kernels
    # once per chunk of components. B4 runs only when the features need a
    # gradient: never on the frozen-trunk MDN path, so its main-path count is
    # 0 (its check and time are phases 3, 6)
    for key, kernel, replaces in (
            ("B2", "gmm_forward", "vit_ad_tpu/ops/pallas/gmm.py:39"),
            ("B3", "gmm_backward_params", "vit_ad_tpu/ops/pallas/gmm_train.py:88"),
            ("B4", "gmm_backward_x", "vit_ad_tpu/ops/pallas/gmm_train.py:175")):
        kernels.append({"name": kernel, "route": "cuda", "source": "vit_ad_tpu_torch/csrc/gmm.cu",
                        "replaces": replaces, "launches": mdn["launches"][key],
                        **gmm_times[key]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
