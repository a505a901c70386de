#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vit_ad_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's flagship serving path — score a folder of images with an
NF-20 head on a full-width DeiT-base/16 trunk, bf16 compute — through the
score CLI, after building and checking the hand-written kernels. Phases:

  1. device   card name and power limit (nvidia-smi)
  2. build    compile the kernels from vit_ad_tpu_torch/csrc (nvcc, sm_90a)
  3. kernels  each kernel against its plain PyTorch version on the card
  4. main     40 synthetic 224-px PNGs scored by `cli.score.main` with seeded
              random full-width weights; launch counts; CUDA-vs-CPU f32 scores
  5. times    kernel vs plain, and flagship uint8→scores img/s at batch 128
  6. result   a kernels JSON line, the nvidia-smi line, and last the
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
        if "registers" in line or "spill" in line:
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
        main_launches = wa.launches
        n_batches = -(-N_IMAGES // SMOKE_BATCH)
        print(f"cli.score.main rc={rc} in {wall:.2f} s (model load included); "
              f"attention launches {main_launches}, expected 12 x {n_batches} batches "
              f"= {12 * n_batches}")
        if rc != 0 or main_launches != 12 * n_batches:
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

        phase("5 times (CUDA events, median of %d after warm-up)" % TIMED_RUNS)
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
    torch.cuda.synchronize()

    phase("6 result")
    print(json.dumps({"kernels": [{
        "name": "vit_attention_qkv",
        "route": "cuda",
        "source": "vit_ad_tpu_torch/csrc/vit_attention_qkv.cu",
        "replaces": "vit_ad_tpu/ops/pallas/window_attention.py:375",
        "launches": main_launches,
        "max_abs_err": err,
        "ms": att_ms,
        "plain_ms": att_plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
