#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vit_ad_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --against <another checkout>   # kernels A/B, `against`
    python3 chip_smoke.py --gmm-backward-ab <checkout> ...   # B3 terms, B4 A/B

Drives the port's main paths at full width, bf16 compute, through the port's
CLIs, after building and checking the hand-written kernels: on a DeiT-base/16
trunk the flagship serving path (score a folder with an NF-20 head; the
blocks' MLP tail goes through the MLP kernel by default), the same with the
stock tail, and the MDN path (train a
K=150 GMM head on cached features, save it, score a folder with it); on the
EsViT Swin-T trunk the NF path (train an NF-20 head on cached Swin features,
save it, score a folder with it); on the ResNet-50 trunk the multi-stage MDN
path (train two K=100 GMM heads jointly with the stage LayerNorms, save them,
score a folder with them). Phases:

  1. device   card name and power limit (nvidia-smi)
  2. build    compile the kernels from vit_ad_tpu_torch/csrc (nvcc, sm_90a)
  3. kernels  each kernel against its plain PyTorch version on the card:
              ViT attention (B1), GMM forward (B2; also at the edges of its
              bf16 kernel, `GMM_FWD_EDGES`, each asserting the route the C
              entry reported), its parameter and feature backwards (B3, B4;
              also at the edges of their bf16 kernels, `GMM_BWD_EDGES`, and
              without dx, each asserting the routes the C entries reported),
              Swin window attention from packed and from split inputs (B5,
              B5a; also at the edges of its three forms, `WINDOW_EDGES`),
              one-pass LayerNorm (B7, each case asserting its route), fused
              MLP half-block (B6)
  4. NF path  40 synthetic 224-px PNGs scored by `cli.score.main` with seeded
              random full-width weights; launch counts (B1 and, by the
              default `models/vit.FUSED_MLP_DEFAULT`, B6 12 times per encoder
              batch each, B7 13: the blocks' first norm and the final norm);
              CUDA-vs-CPU f32 scores
  5. MLP flag the same folder and weights with `--no-fused-mlp` (the stock
              tail): B6 never; bf16 scores against phase 4's; the f32 policy
              (erf GELU) launches none with the flag on and keeps its scores
  6. MDN path a synthetic category: `cli.train_mdn.main` (K=150, a few
              epochs), then `cli.score.main -a mdn` on its .pth; launch
              counts per step and batch (every B2 launch through its bf16
              wgmma kernel); CUDA-vs-CPU f32 scores
  7. EsViT    a synthetic category: `cli.train_nf.main -m esvit --fused-ln`
              (a few epochs), then `cli.score.main -a nf -m enc_esvit` on its
              .pth; B5 (all through the one-pass kernel) and B7 launch counts
              per encoder batch; CUDA-vs-CPU f32 scores
  8. ResNet   a synthetic category: `cli.train_mdn.main -m res_net` (K=100, a
              few joint steps), then `cli.score.main -a mdn` on the two head
              files and the encoder file it wrote; B2, B3 and B4 launch counts
              per step for both heads (B4 never while scoring); the loss
              falls, only the read stage norms move; CUDA-vs-CPU f32 scores
              at K=4
  9. times    kernels vs plain vs the one PyTorch call that computes the same
              function, where there is one, each beside its bound, by events
              and, for the attention kernels and B7, back to back (B5a alone
              with its bias gathered, beside its public entry; B3 and B4 also
              checked at 64 x 196 rows and at the ResNet heads' shapes; B6
              also step by step: LayerNorm, each product alone); DeiT NF
              (fused MLP off and on, with the peak memory of each; the ViT
              norms on B7 and on the f32 cast), MDN, EsViT NF (fused LayerNorm
              off and on) and ResNet MDN uint8→scores img/s at batch 128; the
              MDN, NF and joint ResNet MDN (K=100, 150) train steps; where the
              device time of a DeiT NF batch, an EsViT batch and a ResNet joint
              step (K=100) goes (torch.profiler)
 10. result   a kernels JSON line, the nvidia-smi line, and last the
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
    # bf16 edges, hd = 64 and 32: one token, one key tile exactly and one token
    # more, a Swin window's 49, 196, and both sides of the one-pass kernel's
    # cap (208 | 209 tokens: scores in registers | the two-pass kernel)
    *[(2, n, hd * heads, heads, "bfloat16")
      for n in (1, 16, 17, 49, 196, 208, 209, 255, 256) for hd, heads in ((64, 2), (32, 3))],
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
    # the ResNet-50 heads on a 16-image step: stage 2 (196 tokens), stage 3 (49)
    (3136, 1024, 100, "bfloat16"), (784, 2048, 100, "bfloat16"),
]
# B2 at the edges of its bf16 kernel, (rows, D, K): 64-row blocks filled by
# one row, one row short of a block, one over one and two blocks; widths of one
# and two 64-feature halves (D = 64, 192: the last block of an odd number of
# halves has one consumer warpgroup) and 128; K = 1, 2 and 151; the widest
# width whose x rows stay in shared memory (1024) and the narrowest streamed
# one (1088); and, under f32, the first kernel at the same edges
GMM_FWD_EDGES = [(1, 768, 2, "bfloat16"), (63, 768, 2, "bfloat16"), (65, 768, 2, "bfloat16"),
                 (129, 768, 2, "bfloat16"), (100, 64, 1, "bfloat16"), (100, 64, 151, "bfloat16"),
                 (100, 128, 2, "bfloat16"), (100, 192, 151, "bfloat16"),
                 (333, 1024, 3, "bfloat16"), (333, 1088, 3, "bfloat16"),
                 (65, 64, 151, "float32"), (129, 192, 2, "float32")]
# backward, (rows, D, K, dtype, dx wanted): one chunk of components at 392
# and 200 rows; the train step's 16 x 196 rows take 2 chunks under bf16 and 3
# under f32 (ops/cuda/gmm.py `backward_chunk`), which run k0 > 0 and carry
# the dx sum across chunks; the frozen-trunk trainers want no dx
GMM_BWD_CASES = [(392, 768, 150, "bfloat16", True), (392, 768, 150, "float32", True),
                 (200, 1024, 8, "bfloat16", True), (200, 2048, 4, "float32", True),
                 (3136, 768, 150, "bfloat16", True), (3136, 768, 150, "float32", True),
                 (392, 768, 150, "bfloat16", False), (3136, 768, 150, "bfloat16", False),
                 # the ResNet-50 heads' train step: 2 chunks at D=1024, 1 at D=2048,
                 # B4 in 5 and 7 split partials a chunk on 132 SMs (`gmm.dx_splits`)
                 (3136, 1024, 100, "bfloat16", True), (784, 2048, 100, "bfloat16", True)]
# B3 and B4 at the edges of their bf16 kernels: 64-row blocks filled by one row,
# one row short of a block, one over one and two blocks (B4's 128-row tiles
# too); widths of one, two and three 64-feature groups (D = 64 and 192: the
# last block of the terms kernel has one consumer warpgroup, the last
# 128-wide GEMM tile one box); the widest width whose x rows stay in shared
# memory (1024) and the narrowest streamed one (1088); K = 1; and, under f32,
# the first kernels at the same edges
GMM_BWD_EDGES = [(1, 768, 2, "bfloat16", True), (63, 768, 2, "bfloat16", True),
                 (65, 768, 2, "bfloat16", True), (129, 768, 2, "bfloat16", True),
                 (100, 64, 3, "bfloat16", True), (100, 128, 3, "bfloat16", True),
                 (100, 192, 3, "bfloat16", True), (333, 1024, 3, "bfloat16", True),
                 (333, 1088, 3, "bfloat16", True), (100, 768, 1, "bfloat16", True),
                 (65, 64, 3, "float32", True), (129, 192, 2, "float32", True)]
# the MDN main path: K=150 (startTraining_mdn.py:33) on DeiT-base, D=768
MDN_K, MDN_TRAIN, MDN_TEST, MDN_EPOCHS, MDN_BATCH, MDN_SCORE_BATCH = 150, 32, 4, 3, 16, 4
MDN_TIMED_RUNS = 3
# the EsViT main path: Swin-T + NF-20 (startTraining_NF.py:26-39 defaults)
ESVIT_TRAIN, ESVIT_TEST, ESVIT_EPOCHS, ESVIT_BATCH, ESVIT_SCORE_BATCH = 32, 4, 3, 16, 4
# kernel launches of one EsViT encoder batch: 12 window attentions; with the
# fused LayerNorm 24 block norms, the patch norm, 3 merge norms, the final norm
ESVIT_B5_PER_BATCH, ESVIT_B7_PER_BATCH = 12, 24 + 1 + 3 + 1
# B7 launches of one DeiT-base encoder batch: the 12 blocks' first norm and the
# final norm (the second norm is B6's LayerNorm step, or the stock tail's)
DEIT_B7_PER_BATCH = 12 + 1
NO_LAUNCHES = {"B1": 0, "B2": 0, "B3": 0, "B4": 0, "B5": 0, "B5a": 0, "B6": 0, "B7": 0}
# the ResNet-50 multi-stage MDN main path: heads on stage maps 2 and 3 (D=1024
# on 14x14 tokens, D=2048 on 7x7), K=100 and K=150 (the reference's two
# settings; the CLI run uses 100), a few joint steps at batch 16
RESNET_K, RESNET_TRAIN, RESNET_TEST, RESNET_EPOCHS, RESNET_BATCH = 100, 32, 4, 3, 16
RESNET_SCORE_BATCH, RESNET_TIMED_KS, RESNET_CPU_K = 4, (100, 150), 4
RESNET_HEADS = ((1024, 196), (2048, 49))  # (D, tokens per image) of stages 2, 3
# bf16 image scores with the fused MLP on vs off, relative: the two tails
# round the hidden activations and the residual at other points (f32 vs bf16)
# through 12 blocks; the bf16 policy itself drifts ~1e-2 from f32
FUSED_MLP_SCORE_RTOL = 2e-2
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): HBM3 bytes/s
# and bf16 tensor-core FLOP/s, the rates of every kernel's bound
HBM_BYTES_PER_S, PEAK_BF16_FLOPS = 3.35e12, 989e12
# Swin-T window attention at B=128, 224 px: (stage, windows, window side, C,
# heads, windows per image under the shift mask)
SWIN_STAGES = [("stage 0", 2048, 14, 96, 3, 16), ("stage 1", 512, 14, 192, 6, 4),
               ("stage 2", 128, 14, 384, 12, 0), ("stage 3", 128, 7, 768, 24, 0)]
# Swin-T block LayerNorms at B=128: (rows, D)
LN_STAGES = [(401408, 96), (100352, 192), (25088, 384), (6272, 768)]
# Window attention (B5 packed, B5a split) vs plain, TOL as for B1; cases are
# (windows, window side, C, heads, images sharing the mask | 0 = no mask,
# padded map side | 0): the four EsViT Swin-T stage shapes at B=2 images
# (hd = 32 everywhere), and a 20x20 map padded to 28x28 under window 14.
WINDOW_CASES = [
    (32, 14, 96, 3, 2, 0), (32, 14, 96, 3, 0, 0),     # stage 0: shifted, unshifted
    (8, 14, 192, 6, 2, 0), (8, 14, 192, 6, 0, 0),     # stage 1
    (4, 14, 384, 12, 0, 0),                           # stage 2: window clamped, no mask
    (4, 7, 768, 24, 0, 0),                            # stage 3: N = 49
    (8, 14, 96, 3, 2, 28),                            # padded geometry, 4 windows per image
]
SPLIT_CASES = [(32, 14, 96, 3, 2, 0), (4, 7, 768, 24, 0, 0)]
# Window attention at the edges of its kernels' forms, (window height, width,
# split entry): the packed entry at square windows whose N falls on both sides
# of the narrow one-pass form's 64 tokens (1, 16, 36, 49, 64 | 81, 121, 196) and
# of the one-pass cap (208 | 225, 256: the two-pass form), the split entry at 208
# and 209 tokens; each at hd 32 (3 heads) and 64 (2 heads), with and without a
# mask, 9 windows (3 images of 3 mask rows: an odd number of images, so the
# last block of the one-pass forms, which pair images, has an empty slot)
WINDOW_EDGES = [(s, s, False) for s in (1, 4, 6, 7, 8, 9, 11, 14, 15, 16)] + \
    [(13, 16, True), (11, 19, True)]
# LayerNorm (B7) vs plain: |kernel - plain| <= atol + rtol |plain|. Both
# compute in f32 and round once; under bf16 a last-bit f32 difference can flip
# that rounding, one bf16 ulp (2^-8 relative, 2^-7 allowed); f32: summation
# order of the two reductions.
LN_TOL = {"bfloat16": (1e-3, 2.0**-7), "float32": (1e-5, 1e-5)}
# (rows, D): the Swin-T block widths and the widest merge norm at rows that
# fill no block of 4, and two widths that are no multiple of 32 lanes x 8
# (100 is no multiple of 8 either: the kernel's scalar vectors); for the bf16
# rows kernel (D = 8 LPR NV, 32 / LPR rows a warp), one row, row counts that
# fill no warp's group of rows at D = 96, 192 and 384 (8, 4 and 2 rows a
# warp), and row counts past what the card holds at once, so that the warps
# stride over the rows more than once (B6's LayerNorm step at [25344, 768])
LN_CASES = [(4099, 96), (2051, 192), (1027, 384), (515, 768), (259, 1536), (1027, 100),
            (515, 1000), (1, 384), (1, 768), (4101, 96), (2053, 192), (1025, 384),
            (50001, 384), (25344, 768), (6273, 2048)]
LN_EPS = 1e-5
# Fused MLP half-block (B6) vs plain, max abs difference relative to the
# largest plain entry. bf16: kernel and plain round the same three tensors to
# bf16 from f32 sums taken in other orders (2e-2 is ~2.5 bf16 ulps of the
# largest entry); f32: summation order and tanhf only.
MLP_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
MLP_EPS = 1e-6
# (rows, D, H): the DeiT-base MLP of a B=128 batch (128 x 198 rows, a whole
# number of the kernels' 128- and 32-row tiles), a B=127 batch (ragged last
# tile), one f32 tile exactly, fewer rows than a tile, two other widths the gate
# admits (D=384: the 192-wide output tiles end exactly; D=1024: the last one is
# cut at 64), one row less than, exactly and one row more than a bf16 tile, and
# the row counts the CLI paths of phases 4 to 6 give the kernel: batches of 16
# and 8 images (the NF folder's whole and last batch) and of 4 (MDN scoring)
MLP_CASES = [(25344, 768, 3072), (25146, 768, 3072), (32, 768, 3072), (5, 768, 3072),
             (1000, 384, 1536), (200, 1024, 4096), (127, 768, 3072), (128, 768, 3072),
             (129, 768, 3072), (16 * 198, 768, 3072), (8 * 198, 768, 3072),
             (4 * 198, 768, 3072)]


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


def back_to_back_ms(fn, torch, launches: int = 200, warmup: int = 10) -> float:
    """ms per call of `launches` calls enqueued back to back between two CUDA
    events: the device time of a short kernel without the host's gap between
    calls, which `median_ms` includes."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


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
    before, before_wgmma = cgmm.fwd_launches, cgmm.fwd_wgmma_launches
    want_route = cgmm.forward_route(d, dtype)
    with torch.no_grad():
        got = cgmm.gmm_log_likelihood(*args, matmul_dtype=dtype)
        want = cgmm.gmm_log_likelihood_reference(*args, matmul_dtype=dtype)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = diff.max().item()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= LL_ATOL + LL_RTOL * want.abs()).all())
    took_wgmma = cgmm.fwd_wgmma_launches - before_wgmma
    print(f"gmm forward (B2) rows={rows} D={d} K={k} {dt}: max|kernel-plain| {err:.3e} "
          f"(tol {LL_ATOL:.0e} + {LL_RTOL:.0e}|plain|), |plain| <= {want.abs().max().item():.2f}, "
          f"launches +{cgmm.fwd_launches - before}, route {cgmm.last_fwd_route} (expected "
          f"{want_route}, wgmma +{took_wgmma})")
    if not ok or cgmm.fwd_launches != before + 1:
        raise AssertionError(f"GMM forward kernel disagrees with its plain version: {err}")
    if cgmm.last_fwd_route != want_route or took_wgmma != int(dt == "bfloat16"):
        raise AssertionError(f"GMM forward took route {cgmm.last_fwd_route} at D={d} {dt}, "
                             f"expected {want_route}")
    return err


def check_gmm_backward(rows: int, d: int, k: int, dt: str, want_dx: bool, gen, dev) -> float:
    """B3 (log_pi, weight and bias gradients) and, with `want_dx` (x requiring
    grad), B4 against autograd of the plain version; asserts the routes the C
    entries reported; returns the largest relative error."""
    import torch
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

    dtype = getattr(torch, dt)
    chunks = -(-k // cgmm.backward_chunk(rows, d, k, dtype))
    args = gmm_inputs(rows, d, k, gen, dev)
    args = [t.requires_grad_(i > 0 or want_dx) for i, t in enumerate(args)]
    wrt = args if want_dx else args[1:]
    c = torch.randn(1, rows, d, device=dev, generator=gen)
    names = ("x", "log_pi", "w_sigma", "b_sigma", "w_mu", "b_mu")[0 if want_dx else 1:]
    counts = lambda: (cgmm.bwd_params_launches, cgmm.bwd_x_launches,
                      cgmm.bwd_wgmma_params_launches, cgmm.bwd_wgmma_x_launches)
    before = counts()
    got = torch.autograd.grad((cgmm.gmm_log_likelihood(*args, matmul_dtype=dtype) * c).sum(), wrt)
    launched = tuple(a - b for a, b in zip(counts(), before))
    want = torch.autograd.grad(
        (cgmm.gmm_log_likelihood_reference(*args, matmul_dtype=dtype) * c).sum(), wrt)
    torch.cuda.synchronize()
    routes = cgmm.backward_routes(d, dtype)
    worst = 0.0
    for name, g, w in zip(names, got, want):
        rel = ((g - w).abs().max() / w.abs().max()).item()
        worst = max(worst, rel)
        print(f"  gmm backward {'B4' if name == 'x' else 'B3'} d{name} rows={rows} D={d} K={k} "
              f"{dt} ({chunks} chunks): max|kernel-plain|/max|plain| {rel:.3e} "
              f"(tol {GRAD_RTOL[dt]:.0e})")
        if not (math.isfinite(rel) and rel <= GRAD_RTOL[dt]):
            raise AssertionError(f"GMM backward kernel disagrees on d{name}: {rel}")
    # per chunk: B3's terms and weights entries, B4's dx entry when dx is wanted
    bf16 = int(dt == "bfloat16")
    expect = (2 * chunks, chunks * want_dx, 2 * chunks * bf16, chunks * want_dx * bf16)
    reported = {key: cgmm.last_bwd_routes[key] for key in ("terms", "weights")
                + (("x",) if want_dx else ())}
    print(f"  routes reported {reported}, expected {routes}; launches (B3, B4, B3 wgmma, "
          f"B4 wgmma) {launched}, expected {expect}")
    if launched != expect or any(routes[key] != v for key, v in reported.items()):
        raise AssertionError(f"GMM backward launched {launched} through {reported}, expected "
                             f"{expect} through {routes}")
    return worst


def window_inputs(case, dtype, gen, dev):
    """Seeded inputs of one window-attention case: packed qkv windows, a bias
    table (std 0.5, so the bias moves the softmax) and the shift mask."""
    import torch
    from vit_ad_tpu_torch.ops import window_attention as wops

    windows, side, c, heads, masked_images, padded = case
    n = side * side
    qkv3 = torch.randn(windows, n, 3 * c, device=dev, generator=gen).to(dtype)
    table = 0.5 * torch.randn((2 * side - 1) ** 2, heads, device=dev, generator=gen)
    mask = None
    if masked_images:
        hp = padded or int(math.isqrt(windows // masked_images)) * side
        mask = torch.from_numpy(wops.shift_attention_mask(hp, hp, side, side // 2)).to(dev)
        assert mask.shape[0] * masked_images == windows, (mask.shape, case)
    return qkv3, table, mask


def check_window_attention(case, dt: str, gen, dev, split: bool = False) -> float:
    """B5 (packed) or B5a (split) against its plain version; returns max |diff|."""
    import torch
    from vit_ad_tpu_torch.ops import window_attention as wops
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    windows, side, c, heads, _, _ = case
    qkv3, table, mask = window_inputs(case, getattr(torch, dt), gen, dev)
    index = torch.from_numpy(wops.relative_position_index(side, side)).to(dev)
    bias = wops.gather_bias(table, index)
    before = (wa.window_launches, wa.split_launches)
    before_one_pass = wa.window_one_pass_launches + wa.split_one_pass_launches
    if split:
        q, k, v = (t.contiguous() for t in
                   qkv3.reshape(windows, side * side, 3, heads, c // heads).unbind(2))
        out = wa.window_attention(q, k, v, table, heads, (side, side), mask)
        ref = wops.window_attention_core_reference(q, k, v, bias, mask)
    else:
        out = wa.swin_attention_windows(qkv3, table, heads, side, mask)
        ref = wops.window_attention_reference(qkv3, bias, mask, heads)
    return report_window_check(out, ref, before, before_one_pass, split, dt,
                               f"windows={windows} N={side * side} C={c} H={heads} "
                               f"mask={'none' if mask is None else tuple(mask.shape)}")


def report_window_check(out, ref, before, before_one_pass, split: bool, dt: str,
                        what: str) -> float:
    """Print and assert one window-attention check: the kernel agrees with its
    plain version, launched once through the entry it was called by, and the
    C entry reported the route `window_attention_route` expects (the one-pass
    counter moved exactly for "one_pass"). Returns max |diff|."""
    import torch
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    torch.cuda.synchronize()
    launched = (wa.window_launches - before[0], wa.split_launches - before[1])
    one_pass = wa.window_one_pass_launches + wa.split_one_pass_launches - before_one_pass
    want_route = wa.window_attention_route(out.shape[1], out.dtype)
    err = (out.float() - ref.float()).abs().max().item()
    name = "window_attention (B5a, split)" if split else "swin_attention_windows (B5)"
    print(f"{name} {what} {dt}: max|kernel-plain| {err:.3e} (tol {TOL[dt]:.0e}), launches "
          f"+{launched}, route {wa.last_window_route} (expected {want_route})")
    if not (math.isfinite(err) and err <= TOL[dt]) or launched != ((0, 1) if split else (1, 0)) \
            or wa.last_window_route != want_route or one_pass != int(want_route == "one_pass"):
        raise AssertionError(f"{name} {what} {dt}: disagrees with its plain version ({err}) or "
                             f"took route {wa.last_window_route}, expected {want_route}")
    return err


def check_window_edge(wh: int, ww: int, split: bool, hd: int, masked: bool, dt: str, gen,
                      dev) -> float:
    """B5 (square windows) or B5a at one `WINDOW_EDGES` geometry against its
    plain version, with a random 0 / -100 mask over 3 mask rows or none."""
    import torch
    from vit_ad_tpu_torch.ops import window_attention as wops
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    windows, heads = 9, 3 if hd == 32 else 2
    n, c = wh * ww, heads * hd
    qkv3 = torch.randn(windows, n, 3 * c, device=dev, generator=gen).to(getattr(torch, dt))
    table = 0.5 * torch.randn((2 * wh - 1) * (2 * ww - 1), heads, device=dev, generator=gen)
    bias = wops.gather_bias(table, torch.from_numpy(wops.relative_position_index(wh, ww)).to(dev))
    mask = None
    if masked:
        mask = -100.0 * (torch.rand(3, n, n, device=dev, generator=gen) < 0.3).float()
    before = (wa.window_launches, wa.split_launches)
    before_one_pass = wa.window_one_pass_launches + wa.split_one_pass_launches
    if split:
        q, k, v = (t.contiguous() for t in qkv3.reshape(windows, n, 3, heads, hd).unbind(2))
        out = wa.window_attention(q, k, v, table, heads, (wh, ww), mask)
        ref = wops.window_attention_core_reference(q, k, v, bias, mask)
    else:
        out = wa.swin_attention_windows(qkv3, table, heads, wh, mask)
        ref = wops.window_attention_reference(qkv3, bias, mask, heads)
    return report_window_check(out, ref, before, before_one_pass, split, dt,
                               f"edge window {wh}x{ww} N={n} hd={hd} H={heads} "
                               f"mask={'random 0/-100 x 3' if masked else 'none'}")


def check_layer_norm(rows: int, d: int, dt: str, gen, dev) -> float:
    """B7 against its plain version; returns max |diff|."""
    import torch
    from vit_ad_tpu_torch.ops.cuda import layer_norm as ln

    x = (1.5 * torch.randn(rows, d, device=dev, generator=gen) + 0.3).to(getattr(torch, dt))
    scale = 1.0 + 0.2 * torch.randn(d, device=dev, generator=gen)
    bias = 0.2 * torch.randn(d, device=dev, generator=gen)
    before, before_rows = ln.launches, ln.rows_launches
    route = ln.layer_norm_route(d, x.dtype)
    out = ln.layer_norm(x, scale, bias, LN_EPS)
    ref = ln.layer_norm_reference(x, scale, bias, LN_EPS)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    atol, rtol = LN_TOL[dt]
    ok = bool(torch.isfinite(out).all()) and bool((diff <= atol + rtol * ref.float().abs()).all())
    took_rows = ln.rows_launches - before_rows
    print(f"layer_norm (B7) rows={rows} D={d} {dt}: max|kernel-plain| {diff.max().item():.3e} "
          f"(tol {atol:.0e} + {rtol:.1e}|plain|), launches +{ln.launches - before}, route "
          f"{route} (rows kernel +{took_rows})")
    if not ok or out.dtype != x.dtype or ln.launches != before + 1:
        raise AssertionError("layer_norm kernel disagrees with its plain version")
    if took_rows != int(route == "rows"):
        raise AssertionError(f"layer_norm at D={d} {dt} did not report route {route}")
    return diff.max().item()


def mlp_inputs(rows: int, d: int, hidden: int, dtype, gen, dev):
    """Seeded inputs of the fused MLP half-block: x [rows, D] with a mean and
    a spread the LayerNorm has to remove, a norm affine away from (1, 0), and
    fc1/fc2 in the nn.Linear layouts at the scale of a trained ViT block (the
    hidden pre-activations have std ~1, the MLP output std ~0.5)."""
    import torch

    r = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
    x = (1.5 * r(rows, d) + 0.3).to(dtype)
    return [x, 1.0 + 0.2 * r(d), 0.2 * r(d), (r(hidden, d) / math.sqrt(d)).to(dtype),
            0.1 * r(hidden), (r(d, hidden) / math.sqrt(hidden)).to(dtype), 0.1 * r(d)]


def check_mlp_block(rows: int, d: int, hidden: int, dt: str, gen, dev) -> float:
    """B6 against its plain version; returns max |diff|. The tolerance is
    relative to the largest plain entry: under bf16 both round the LayerNorm
    output, the GELU output and the result to bf16, and an f32 sum that
    differs in its last bits can flip any of those roundings."""
    import torch
    from vit_ad_tpu_torch.ops import mlp as mops
    from vit_ad_tpu_torch.ops.cuda import mlp as cmlp

    args = mlp_inputs(rows, d, hidden, getattr(torch, dt), gen, dev)
    before, before_wgmma = cmlp.launches, cmlp.wgmma_launches
    route = cmlp.mlp_route(d, hidden, args[0].dtype)
    with torch.no_grad():
        out = cmlp.mlp_block(*args, MLP_EPS)
        ref = mops.mlp_block_reference(*args, MLP_EPS)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    took_wgmma = cmlp.wgmma_launches - before_wgmma
    print(f"mlp_block (B6) rows={rows} D={d} H={hidden} {dt}: max|kernel-plain| {err:.3e} = "
          f"{err / scale:.3e} of max|plain| {scale:.2f} (tol {MLP_TOL[dt]:.0e}), launches "
          f"+{cmlp.launches - before}, route {route} (wgmma route +{took_wgmma})")
    if not (math.isfinite(err) and err <= MLP_TOL[dt] * scale) or out.dtype != args[0].dtype \
            or out.shape != args[0].shape or cmlp.launches != before + 1:
        raise AssertionError(f"mlp_block kernel disagrees with its plain version: {err}")
    if route != ("wgmma" if dt == "bfloat16" else "fma") or took_wgmma != int(route == "wgmma"):
        raise AssertionError(f"mlp_block took the wrong route at D={d} H={hidden} {dt}: {route}, "
                             f"wgmma route +{took_wgmma}")
    return err


def check_mlp_kernel(gen, dev) -> None:
    """Phase 3, B6: the fused MLP half-block at the DeiT-base shape of a B=128
    batch and its neighbours, in bf16 and f32, and its recompute backward
    against plain autograd."""
    import torch
    from vit_ad_tpu_torch.ops import mlp as mops
    from vit_ad_tpu_torch.ops.cuda import mlp as cmlp

    for dt in ("bfloat16", "float32"):
        for rows, d, hidden in MLP_CASES:
            check_mlp_block(rows, d, hidden, dt, gen, dev)
    args = [t.requires_grad_(True) for t in mlp_inputs(45, 128, 256, torch.float32, gen, dev)]
    gy = torch.randn(45, 128, device=dev, generator=gen)
    got = torch.autograd.grad(cmlp.mlp_block(*args, MLP_EPS), args, gy)
    want = torch.autograd.grad(mops.mlp_block_reference(*args, MLP_EPS), args, gy)
    gerr = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))
    print(f"mlp_block backward vs plain autograd (f32, rows=45 D=128 H=256): max relative "
          f"diff {gerr:.3e} (tol 1e-5)")
    if not gerr <= 1e-5:
        raise AssertionError(f"mlp_block's recompute backward disagrees with plain autograd: "
                             f"{gerr}")


def check_swin_kernels(gen, dev) -> None:
    """Phase 3, the Swin slice: B5 at every stage shape and a padded
    geometry, B5a at two of them, B7 at the block and merge widths, each in
    bf16 and f32; and the recompute backwards against plain autograd."""
    import torch
    from vit_ad_tpu_torch.ops import window_attention as wops
    from vit_ad_tpu_torch.ops.cuda import layer_norm as ln
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    for dt in ("bfloat16", "float32"):
        for case in WINDOW_CASES:
            check_window_attention(case, dt, gen, dev)
        for case in SPLIT_CASES:
            check_window_attention(case, dt, gen, dev, split=True)
        for wh, ww, split in WINDOW_EDGES:
            for hd in (32, 64):
                for masked in (False, True):
                    check_window_edge(wh, ww, split, hd, masked, dt, gen, dev)
        for rows, d in LN_CASES:
            check_layer_norm(rows, d, dt, gen, dev)
    # backwards recompute through the plain versions, so the gradients must
    # equal autograd of the plain version (f32, tiny shapes)
    case = (8, 7, 64, 2, 2, 0)
    qkv3, table, mask = window_inputs(case, torch.float32, gen, dev)
    qkv3.requires_grad_(True)
    table.requires_grad_(True)
    g = torch.randn(8, 49, 64, device=dev, generator=gen)
    got = torch.autograd.grad(wa.swin_attention_windows(qkv3, table, 2, 7, mask), [qkv3, table], g)
    index = torch.from_numpy(wops.relative_position_index(7, 7)).to(dev)
    want = torch.autograd.grad(
        wops.window_attention_reference(qkv3, wops.gather_bias(table, index), mask, 2),
        [qkv3, table], g)
    x = torch.randn(33, 96, device=dev, generator=gen, requires_grad=True)
    params = [torch.randn(96, device=dev, generator=gen, requires_grad=True) for _ in range(2)]
    gy = torch.randn(33, 96, device=dev, generator=gen)
    got += torch.autograd.grad(ln.layer_norm(x, *params, LN_EPS), [x, *params], gy)
    want += torch.autograd.grad(ln.layer_norm_reference(x, *params, LN_EPS), [x, *params], gy)
    gerr = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))
    print(f"swin_attention_windows and layer_norm backwards vs plain autograd (f32): max "
          f"relative diff {gerr:.3e} (tol 1e-5)")
    if not gerr <= 1e-5:
        raise AssertionError(f"a recompute backward disagrees with plain autograd: {gerr}")


def check_scores_csv(out_dir: str, files, what: str):
    """scores.csv holds one finite row per image, in input order."""
    import numpy as np

    with open(os.path.join(out_dir, "scores.csv")) as f:
        rows = list(csv.reader(f))[1:]
    scores = np.array([float(r[1]) for r in rows])
    if [r[0] for r in rows] != files or not np.all(np.isfinite(scores)):
        raise AssertionError(f"{what} scores.csv does not hold one finite row per image")
    print(f"scores.csv: {len(rows)} rows, all finite, min {scores.min():.6f} "
          f"max {scores.max():.6f}")
    return scores


def esvit_main_path(tmp: str) -> dict:
    """Phase 7: train an NF-20 head on the full-width EsViT Swin-T trunk's
    features of a synthetic 224-px category with `cli.train_nf` (fused
    LayerNorm on), score its test folder with `cli.score -a nf -m enc_esvit`,
    and check the launch counts of both runs and the f32 scores against the
    CPU."""
    import glob

    import numpy as np
    import torch
    from vit_ad_tpu_torch.cli import score as score_cli
    from vit_ad_tpu_torch.cli import train_nf as train_cli
    from vit_ad_tpu_torch.config import DtypePolicy
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.data.synthetic import make_mvtec_category
    from vit_ad_tpu_torch.ops.cuda import layer_norm as ln
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models, score_models

    cat = make_mvtec_category(os.path.join(tmp, "esvit"), "gadget", img_size=224,
                              n_train=ESVIT_TRAIN, n_test_good=ESVIT_TEST,
                              n_test_defect=ESVIT_TEST)
    test_dir = os.path.join(cat, "test")
    run = os.path.join(tmp, "esvit_run")
    split = DataPipeline(ESVIT_BATCH, 224, base_path=cat, data_path="train/good")
    n_batches = lambda n, b: -(-n // b)
    n_enc = (n_batches(len(split.train_files), ESVIT_BATCH)
             + n_batches(len(split.valid_files), ESVIT_BATCH)
             + n_batches(2 * ESVIT_TEST, ESVIT_BATCH))

    reset_launches()
    t0 = time.perf_counter()
    rc = train_cli.main(["-m", "esvit", "-d", cat, "-t", "train/good", "-v", "test",
                         "-e", str(ESVIT_EPOCHS), "-p", str(ESVIT_EPOCHS),
                         "-b", str(ESVIT_BATCH), "-i", "224", "--device", "cuda",
                         "--out", run, "--fused-ln"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train = read_launches()
    # the trunk is frozen and its features cached: the encoder runs once over
    # the train, validation and test batches; the flow has no kernel
    expect = {**NO_LAUNCHES, "B5": ESVIT_B5_PER_BATCH * n_enc, "B7": ESVIT_B7_PER_BATCH * n_enc}
    print(f"cli.train_nf.main -m esvit --fused-ln rc={rc} in {wall:.2f} s ({n_enc} encoder "
          f"batches of {ESVIT_BATCH}): launches {train}, expected {expect}; B5 through the "
          f"one-pass kernel {wa.window_one_pass_launches}, B7 through the rows kernel "
          f"{ln.rows_launches}")
    if rc != 0 or train != expect or wa.window_one_pass_launches != expect["B5"] or \
            ln.rows_launches != expect["B7"]:
        raise AssertionError("the EsViT NF training path did not launch B5 12 times, all "
                             "through the one-pass kernel, and B7 29 times per encoder batch, "
                             "all through the rows kernel")
    with open(os.path.join(run, "history.json")) as f:
        hist = json.load(f)
    if not all(math.isfinite(v) for v in hist["train_loss"] + hist["valid_loss"]) or \
            not all(math.isfinite(v) for v in hist["metrics"].values()) or \
            hist["epochs_ran"] != ESVIT_EPOCHS:
        raise AssertionError(f"non-finite losses or metrics: {hist}")
    if not hist["train_loss"][-1] < hist["train_loss"][0]:
        raise AssertionError(f"the NF train loss did not fall: {hist['train_loss']}")
    print(f"train loss {hist['train_loss']}, valid loss {hist['valid_loss']}, "
          f"metrics {hist['metrics']} (random trunk: information only)")
    (pth,) = glob.glob(os.path.join(run, "nf_enc_esvit_*.pth"))

    out_dir = os.path.join(tmp, "esvit_scores")
    reset_launches()
    t0 = time.perf_counter()
    rc = score_cli.main(["--pth", pth, "-a", "nf", "-m", "enc_esvit", "-d", test_dir,
                         "-b", str(ESVIT_SCORE_BATCH), "-o", out_dir, "--fused-ln"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    score = read_launches()
    nb = n_batches(2 * ESVIT_TEST, ESVIT_SCORE_BATCH)
    expect = {**NO_LAUNCHES, "B5": ESVIT_B5_PER_BATCH * nb, "B7": ESVIT_B7_PER_BATCH * nb}
    print(f"cli.score.main -a nf -m enc_esvit --fused-ln rc={rc} in {wall:.2f} s: launches "
          f"{score}, expected {expect}; B5 through the one-pass kernel "
          f"{wa.window_one_pass_launches}, B7 through the rows kernel {ln.rows_launches}")
    if rc != 0 or score != expect or wa.window_one_pass_launches != expect["B5"] or \
            ln.rows_launches != expect["B7"]:
        raise AssertionError("EsViT scoring did not launch B5 12 times, all through the "
                             "one-pass kernel, and B7 29 times per batch, all through the rows "
                             "kernel")
    files = score_cli.list_images(test_dir)
    scores = check_scores_csv(out_dir, files, "EsViT")

    mean, std = default_norm_stats()
    two = files[:2]
    got = {}
    for device in ("cuda", "cpu"):
        m = build_pth_models(pth, "enc_esvit", "nf", dtypes=DtypePolicy.f32(), device=device,
                             fused_ln=True)
        got[device] = score_models(m, DataPipeline(2, 224, files=two), mean, std).image_scores
    rel = np.abs(got["cuda"] - got["cpu"]) / np.abs(got["cpu"])
    print(f"EsViT f32 image scores cuda {got['cuda'].tolist()} cpu {got['cpu'].tolist()}: "
          f"max rel diff {rel.max():.3e} (rtol {SCORE_RTOL_F32:.0e})")
    if not rel.max() <= SCORE_RTOL_F32:
        raise AssertionError("CUDA f32 EsViT scores disagree with the CPU path")
    bf16_rel = np.abs(scores[:2] - got["cpu"]) / np.abs(got["cpu"])
    print(f"EsViT bf16 card scores vs f32 CPU scores (same 2 images): max rel diff "
          f"{bf16_rel.max():.3e} (information: bf16 policy drift)")
    return {"launches": {k: train[k] + score[k] for k in train}, "pth": pth}


def sdpa_windows(q, k, v, additive):
    """The library control of the window attention: one
    `scaled_dot_product_attention` call on q, k, v [B_, H, N, hd] with the
    bias and mask as one additive mask in q's dtype: either [B_, H, N, N],
    expanded for every window beforehand, or [n_w, H, N, N], broadcast by the
    call over [images, n_w, H, N, hd] views."""
    import torch.nn.functional as F

    b_, h, n, hd = q.shape
    if additive.shape[0] != b_:
        n_w = additive.shape[0]
        q, k, v = (t.reshape(b_ // n_w, n_w, h, n, hd) for t in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=additive)
    return out.reshape(b_, h, n, hd).transpose(1, 2).reshape(b_, n, h * hd)


def sdpa_ms(q, k, v, additive, torch):
    """(best ms by events, the two ms by events, best ms back to back) of the
    SDPA control with the broadcast and with the expanded additive mask (the
    expansion is made before the timed calls)."""
    b_, n_w = q.shape[0], additive.shape[0]
    expanded = additive.repeat(b_ // n_w, 1, 1, 1)
    calls = [lambda a=a: sdpa_windows(q, k, v, a) for a in (additive, expanded)]
    both = [median_ms(call, torch) for call in calls]
    return min(both), both, min(back_to_back_ms(call, torch) for call in calls)


def swin_times(card: str, gen) -> dict:
    """Phase 9, Swin part: B5 at the four Swin-T stage shapes of a B=128
    batch, B5a at stage 0, B7 at the four block-norm shapes and B6's
    LayerNorm step (`layer_norm_times`): kernel vs plain vs the library call
    (SDPA with an additive mask; `F.layer_norm`), beside the bound. Returns
    the kernels' JSON numbers (stage 0 for B5 and B7, the heaviest call;
    every stage in `per_stage`)."""
    import torch
    from vit_ad_tpu_torch.ops import window_attention as wops
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    out = {"B5": None, "B5a": None, "B7": None}
    per_stage = []
    for stage, windows, side, c, heads, n_w in SWIN_STAGES:
        case = (windows, side, c, heads, windows // n_w if n_w else 0, 0)
        qkv3, table, mask = window_inputs(case, bf16, gen, dev)
        n, hd = side * side, c // heads
        index = torch.from_numpy(wops.relative_position_index(side, side)).to(dev)
        bias = wops.gather_bias(table, index)
        q, k, v = wops.split_packed(qkv3, heads)  # [B_, H, N, hd] views of qkv3
        additive = (bias[None] if mask is None else bias[None] + mask[:, None]).to(bf16)
        kern = lambda: wa.swin_attention_windows(qkv3, table, heads, side, mask, bias=bias)
        plain = lambda: wops.window_attention_reference(qkv3, bias, mask, heads)
        lib = lambda: sdpa_windows(q, k, v, additive)
        with torch.no_grad():
            got = kern()
            err = (got.float() - plain().float()).abs().max().item()
            lib_err = (got.float() - lib().float()).abs().max().item()
            kern_ms, plain_ms = alternate(kern, plain, TIMED_RUNS, 3)
            lib_ms, lib_both, lib_b2b = sdpa_ms(q, k, v, additive, torch)
            kern_b2b = back_to_back_ms(kern, torch)
        if not err <= TOL["bfloat16"]:
            raise AssertionError(f"B5 disagrees with its plain version at {stage}: {err}")
        nums = {"max_abs_err": err, "ms": statistics.mean(kern_ms),
                "plain_ms": statistics.mean(plain_ms), "library_ms": lib_ms,
                "back_to_back_ms": kern_b2b, "library_back_to_back_ms": lib_b2b,
                **bound(tensor_bytes(qkv3, got, bias, mask), 4 * windows * heads * n * n * hd)}
        per_stage.append({"shape": f"{stage} [{windows},{n},{3 * c}] H={heads} "
                                   f"mask={'none' if mask is None else n_w}", **nums})
        print(f"[{card}] swin_attention_windows (B5) {per_stage[-1]['shape']} bf16: kernel "
              f"{kern_ms} ms ({kern_b2b:.4f} ms back to back, 200 launches), plain {plain_ms} ms "
              f"(order plain, kernel, kernel, plain), SDPA with additive mask (broadcast, "
              f"expanded) {lib_both} ms ({lib_b2b:.4f} ms back to back), bound "
              f"{nums['bound_ms']:.4f} ms by {nums['bound_by']}; max|kernel-plain| {err:.3e}, "
              f"max|kernel-SDPA| {lib_err:.3e}")
        if out["B5"] is None:  # stage 0, shifted: the heaviest of the 12 launches
            out["B5"] = nums
            qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # [B_, N, H, hd]
            # the kernel alone (the bias gathered beforehand, as for SDPA), and
            # the public entry, which gathers the table on every call
            kern = lambda: wa.split_window_attention(qs, ks, vs, bias, mask)
            entry = lambda: wa.window_attention(qs, ks, vs, table, heads, (side, side), mask)
            plain = lambda: wops.window_attention_core_reference(qs, ks, vs, bias, mask)
            with torch.no_grad():
                got = kern()
                err = (got.float() - plain().float()).abs().max().item()
                if not torch.equal(entry(), got):
                    raise AssertionError("B5a's public entry and its kernel alone disagree")
                kern_ms, plain_ms = alternate(kern, plain, TIMED_RUNS, 3)
                entry_ms = median_ms(entry, torch)
                kern_b2b = back_to_back_ms(kern, torch)
                lib_ms, lib_both, lib_b2b = sdpa_ms(*(t.transpose(1, 2) for t in (qs, ks, vs)),
                                                    additive, torch)
            if not err <= TOL["bfloat16"]:
                raise AssertionError(f"B5a disagrees with its plain version at {stage}: {err}")
            out["B5a"] = {"max_abs_err": err, "ms": statistics.mean(kern_ms),
                          "plain_ms": statistics.mean(plain_ms), "library_ms": lib_ms,
                          "back_to_back_ms": kern_b2b, "library_back_to_back_ms": lib_b2b,
                          "entry_ms": entry_ms,
                          **bound(tensor_bytes(qs, ks, vs, got, bias, mask),
                                  4 * windows * heads * n * n * hd)}
            print(f"[{card}] window_attention (B5a, split q k v) {per_stage[-1]['shape']} bf16: "
                  f"kernel alone {kern_ms} ms ({kern_b2b:.4f} ms back to back), the public entry "
                  f"with its table gather {entry_ms:.4f} ms, plain {plain_ms} ms, SDPA "
                  f"{lib_both} ms ({lib_b2b:.4f} ms back to back), bound "
                  f"{out['B5a']['bound_ms']:.4f} ms; max|kernel-plain| {err:.3e}")
            del qs, ks, vs
        del qkv3, q, k, v, got
    out["B5"]["per_stage"] = per_stage

    out["B7"] = layer_norm_times(card, gen)
    return out


def layer_norm_times(card: str, gen) -> dict:
    """Phase 9, B7 at `LN_PATH_SHAPES` (the four Swin-T block norms of a B=128
    batch and B6's LayerNorm step), bf16: kernel vs plain by events (order
    plain, kernel, kernel, plain), and kernel, `F.layer_norm` on the same bf16
    rows and the unfused path (`F.layer_norm` on the f32 cast and back: the
    DeiT blocks' norm before this port's kernel took it) by events and back to
    back, beside the bound. Returns the JSON numbers of [401408,96] (the
    heaviest call), every shape in `per_stage`."""
    import torch
    import torch.nn.functional as F
    from vit_ad_tpu_torch.ops.cuda import layer_norm as ln

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    per_shape = []
    for rows, d in LN_PATH_SHAPES:
        x = (1.5 * torch.randn(rows, d, device=dev, generator=gen) + 0.3).to(bf16)
        scale = 1.0 + 0.2 * torch.randn(d, device=dev, generator=gen)
        shift = 0.2 * torch.randn(d, device=dev, generator=gen)
        scale_bf, shift_bf = scale.to(bf16), shift.to(bf16)
        kern = lambda: ln.layer_norm(x, scale, shift, LN_EPS)
        plain = lambda: ln.layer_norm_reference(x, scale, shift, LN_EPS)
        # one library call on the same bf16 rows (scale and bias rounded to bf16
        # before the timed calls), and the unfused path around its f32 call
        lib = lambda: F.layer_norm(x, (d,), scale_bf, shift_bf, LN_EPS)
        unfused = lambda: F.layer_norm(x.float(), (d,), scale, shift, LN_EPS).to(bf16)
        with torch.no_grad():
            got, want = kern(), plain()
            diff = (got.float() - want.float()).abs()
            atol, rtol = LN_TOL["bfloat16"]
            if not bool((diff <= atol + rtol * want.float().abs()).all()):
                raise AssertionError(f"B7 disagrees with its plain version at [{rows},{d}]")
            kern_ms, plain_ms = alternate(kern, plain, TIMED_RUNS, 3)
            lib_ms, unfused_ms = median_ms(lib, torch), median_ms(unfused, torch)
            b2b = {name: back_to_back_ms(fn, torch)
                   for name, fn in (("kernel", kern), ("library", lib), ("unfused", unfused))}
        nums = {"max_abs_err": diff.max().item(), "ms": statistics.mean(kern_ms),
                "plain_ms": statistics.mean(plain_ms), "library_ms": lib_ms,
                "back_to_back_ms": b2b["kernel"], "library_back_to_back_ms": b2b["library"],
                **bound(tensor_bytes(x, got, scale, shift), 8 * rows * d, 67e12)}
        per_shape.append({"shape": f"[{rows},{d}]", "unfused_ms": unfused_ms,
                          "unfused_back_to_back_ms": b2b["unfused"], **nums})
        print(f"[{card}] layer_norm (B7) [{rows},{d}] bf16, route {ln.layer_norm_route(d, bf16)}: "
              f"kernel {kern_ms} ms, plain {plain_ms} ms (order plain, kernel, kernel, plain), "
              f"F.layer_norm on the bf16 rows {lib_ms:.4f} ms, F.layer_norm on the f32 cast and "
              f"back (the unfused path) {unfused_ms:.4f} ms; back to back (200 calls) kernel "
              f"{b2b['kernel']:.4f} ms, F.layer_norm {b2b['library']:.4f} ms, unfused "
              f"{b2b['unfused']:.4f} ms; bound {nums['bound_ms']:.4f} ms by {nums['bound_by']} "
              f"(kernel back to back at {nums['bound_ms'] / b2b['kernel']:.3f} of it); "
              f"max|kernel-plain| {nums['max_abs_err']:.3e}")
        del x, got, want
    return {**per_shape[0], "per_stage": per_shape}


def print_device_profile(what: str, fn, card: str, batches: int = 3, top: int = 16) -> None:
    """Where the device time of `fn` goes: `torch.profiler` over `batches`
    calls, kernels summed by name, ms per call. Information only: prints
    "not measured" if the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3 / batches
    kernels = {}
    for event in prof.events():
        # a user range on the device's timeline (the optimizer's step) spans
        # kernels that are counted themselves
        if event.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(event, "is_user_annotation", False):
            us = getattr(event, "device_time", None)
            us = event.cuda_time if us is None else us
            ms, count = kernels.get(event.name, (0.0, 0))
            kernels[event.name] = (ms + us / 1e3 / batches, count + 1)
    busy = sum(ms for ms, _ in kernels.values())
    if busy <= 0:
        print(f"[{card}] profile of {what}: not measured (the profiler recorded no device "
              f"activity)")
        return
    print(f"[{card}] profile of {what}: {busy:.3f} ms of kernels per call, {wall_ms:.3f} ms wall "
          f"under the profiler, {sum(n for _, n in kernels.values()) // batches} launches per "
          f"call; by kernel (ms per call, launches per call):")
    for name, (ms, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {ms:8.3f}  {count // batches:4d}  {name[:110]}")


def esvit_times(esvit: dict, images, card: str, gen) -> None:
    """Phase 9, EsViT part: uint8→scores img/s of Swin-T + NF-20 at B=128
    bf16 with the fused LayerNorm off and on (order off, on, on, off), the
    encoder alone likewise, the NF train step on cached [B, 49, 768] tokens
    (7x7x768 maps), and where the device time of a scoring batch goes."""
    import torch
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models
    from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
    from vit_ad_tpu_torch.pipeline.train import masked_nf_loss, train_step

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    fns, m = flag_ab("EsViT", "Swin-T", "fused LN", images, card,
                     lambda fused: build_pth_models(esvit["pth"], "enc_esvit", "nf", device=dev,
                                                    fused_ln=fused))
    print(f"EsViT peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    flow = m.parts[1].train()
    for b in (32, 128):
        feats = torch.randn(b, 49, 768, device=dev, generator=gen)
        valid = torch.ones(b, device=dev)
        opt = torch_adam(flow.parameters(), 1e-3, 1e-5)
        step = lambda: train_step(masked_nf_loss, flow, opt, feats, valid, None)
        loss = step()
        if not torch.isfinite(loss):
            raise AssertionError(f"NF train step gave a non-finite loss: {loss}")
        ms = median_ms(step, torch, runs=10)
        print(f"[{card}] NF-20 train step (flow forward + backward + Adam, no kernel) on cached "
              f"[{b},7,7,768] maps, f32: {ms:.3f} ms = {b / ms * 1e3:.1f} img/s")
    # last: the profiler's hooks slow the host down for whatever is timed after it
    print_device_profile(f"EsViT uint8→scores B={FLAGSHIP_BATCH} bf16, fused LN on", fns[True],
                         card)


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
    from vit_ad_tpu_torch.ops.cuda import layer_norm as ln
    from vit_ad_tpu_torch.ops.cuda import mlp as cmlp
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    wa.launches = cgmm.fwd_launches = cgmm.bwd_params_launches = cgmm.bwd_x_launches = 0
    wa.window_launches = wa.split_launches = ln.launches = cmlp.launches = 0
    cgmm.fwd_wgmma_launches = ln.rows_launches = 0
    cgmm.bwd_wgmma_params_launches = cgmm.bwd_wgmma_x_launches = 0
    wa.one_pass_launches = cmlp.wgmma_launches = 0
    wa.window_one_pass_launches = wa.split_one_pass_launches = 0


def read_launches() -> dict:
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm
    from vit_ad_tpu_torch.ops.cuda import layer_norm as ln
    from vit_ad_tpu_torch.ops.cuda import mlp as cmlp
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    return {"B1": wa.launches, "B2": cgmm.fwd_launches, "B3": cgmm.bwd_params_launches,
            "B4": cgmm.bwd_x_launches, "B5": wa.window_launches, "B5a": wa.split_launches,
            "B6": cmlp.launches, "B7": ln.launches}


def bound(n_bytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def mdn_main_path(tmp: str) -> dict:
    """Phase 6: train a K=150 MDN head on a synthetic 224-px category with
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
    expect = {**NO_LAUNCHES, "B1": 12 * (n_tr + n_va + n_te),
              "B6": 12 * (n_tr + n_va + n_te), "B7": DEIT_B7_PER_BATCH * (n_tr + n_va + n_te),
              "B2": ep * (n_tr + n_va) + n_te, "B3": ep * n_tr * 2 * chunks}
    print(f"cli.train_mdn.main rc={rc} in {wall:.2f} s ({ep} epochs x {n_tr} train + {n_va} "
          f"valid batches of {MDN_BATCH}, {n_te} test batch; {chunks} backward chunks): "
          f"launches {train}, expected {expect}; B2 through the wgmma kernel "
          f"{cgmm.fwd_wgmma_launches}, B3 through its wgmma kernels "
          f"{cgmm.bwd_wgmma_params_launches}")
    if rc != 0 or train != expect or cgmm.fwd_wgmma_launches != expect["B2"] or \
            cgmm.bwd_wgmma_params_launches != expect["B3"]:
        raise AssertionError("the MDN training path did not launch B2 and B3 on every step, "
                             "each through its wgmma kernels (and B4 on none)")
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
    expect = {**NO_LAUNCHES, "B1": 12 * nb, "B6": 12 * nb, "B2": nb, "B7": DEIT_B7_PER_BATCH * nb}
    print(f"cli.score.main -a mdn rc={rc} in {wall:.2f} s: launches {score}, expected {expect}; "
          f"B2 through the wgmma kernel {cgmm.fwd_wgmma_launches}")
    if rc != 0 or score != expect or cgmm.fwd_wgmma_launches != expect["B2"]:
        raise AssertionError("MDN scoring did not launch B2 once per batch, through the wgmma "
                             "kernel")
    files = score_cli.list_images(test_dir)
    check_scores_csv(out_dir, files, "MDN")

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


def gmm_split_times(rows: int, d: int, k: int, head, card: str, gen, runs: int) -> dict:
    """B2, B3 and B4 alone on `rows` features of width `d` with the weights of
    `head` (a GaussianMDN of K=`k`), bf16: the forward, and B3 and B4 by
    difference of the medians of forward, forward + backward and forward +
    backward with dx, kernel and plain. Returns the kernels' JSON numbers;
    raises if B3 or B4 disagrees with its plain version here (B2 is held to
    its tolerance at these shapes in phase 3)."""
    import torch
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    x = torch.randn(1, rows, d, device=dev, generator=gen)
    log_pi = torch.log(torch.softmax(torch.randn(1, rows, k, device=dev, generator=gen),
                                     -1) + 1e-15).requires_grad_(True)
    c = torch.randn(1, rows, d, device=dev, generator=gen)
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
        grads[version + " ll"] = fwd()
        grads[version] = bwd_x()
        grads[version + " ms"] = [median_ms(f, torch, runs, 1) for f in (fwd, bwd, bwd_x)]
    ll_diff = (grads["kernel ll"] - grads["plain ll"]).abs()
    errs = [(g - w).abs().max().item() for g, w in zip(grads["kernel"], grads["plain"])]
    # B2 computes mu and pre (two [rows, D] x [D, D] products per component);
    # B3 recomputes them and contracts x with dmu and dpre (two more); B4
    # multiplies dmu and dpre by the heads (two). Each reads x, log_pi and
    # both heads once (B3 and B4 also g and ll); B2 writes ll, B3 both heads'
    # gradients, B4 dx.
    head_bytes = tensor_bytes(*params[1:])
    prod = 2 * rows * d * d * k  # one [rows, D] x [D, D] product per component
    acts = tensor_bytes(x, c, log_pi) + rows * d * 4
    bounds = {"B2": bound(tensor_bytes(x, log_pi) + head_bytes + rows * d * 4, 2 * prod),
              "B3": bound(acts + 2 * head_bytes + tensor_bytes(log_pi), 4 * prod),
              "B4": bound(acts + head_bytes + tensor_bytes(x), 2 * prod)}
    k_fwd, p_fwd = grads["kernel ms"][0], grads["plain ms"][0]
    print(f"[{card}] gmm forward (B2) rows={rows} D={d} K={k} bf16, route "
          f"{cgmm.forward_route(d, bf16)}: kernel {k_fwd:.3f} ms ({2 * prod / k_fwd / 1e9:.1f} "
          f"TFLOP/s, {bounds['B2']['bound_ms'] / k_fwd:.3f} of the bound), plain {p_fwd:.3f} ms, "
          f"bound {bounds['B2']['bound_ms']:.3f} ms by {bounds['B2']['bound_by']}; "
          f"max|kernel-plain| {ll_diff.max().item():.3e}")
    out = {"B2": {"max_abs_err": ll_diff.max().item(), "ms": k_fwd, "plain_ms": p_fwd,
                  "library_ms": None, **bounds["B2"]}}
    for key, idx, what in (("B3", 1, "parameter backward"), ("B4", 2, "feature backward")):
        k_ms = grads["kernel ms"][idx] - grads["kernel ms"][idx - 1]
        p_ms = grads["plain ms"][idx] - grads["plain ms"][idx - 1]
        idx_g = range(5) if key == "B3" else [5]
        err = max(errs[i] for i in idx_g)
        rel = max(errs[i] / grads["plain"][i].abs().max().item() for i in idx_g)
        print(f"[{card}] gmm {what} ({key}) rows={rows} D={d} K={k} bf16, by "
              f"difference of medians: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
              f"(kernel fwd/+bwd/+dx {grads['kernel ms']}, plain {grads['plain ms']}), bound "
              f"{bounds[key]['bound_ms']:.3f} ms by {bounds[key]['bound_by']}; "
              f"max|kernel-plain| {err:.3e} ({rel:.3e} of max|plain|, tol "
              f"{GRAD_RTOL['bfloat16']:.0e})")
        if not (math.isfinite(rel) and rel <= GRAD_RTOL["bfloat16"]):
            raise AssertionError(f"{key} disagrees with its plain version at rows={rows} "
                                 f"D={d}: {rel}")
        out[key] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                    **bounds[key]}
    for v in out.values():
        v["shape"] = f"rows={rows} D={d} K={k}"
    return out


def mdn_times(mdn: dict, images, card: str, gen) -> dict:
    """Phase 9, MDN part: B2 at batch 128, the train step (B2 + B3) at 32
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
        # two [rows, D] x [D, D] products per component; x, log_pi, both heads
        # and their biases read once, ll written once
        b2 = bound(tensor_bytes(*args) + rows * d * 4, tflop * 1e12)
        print(f"[{card}] gmm forward (B2) B={FLAGSHIP_BATCH} rows={rows} D={d} K={k} bf16, "
              f"route {cgmm.last_fwd_route}: kernel {kern_ms} ms "
              f"({tflop / statistics.mean(kern_ms) * 1e3:.1f} TFLOP/s, "
              f"{b2['bound_ms'] / statistics.mean(kern_ms):.3f} of the bound), plain {plain_ms} ms "
              f"(order plain, kernel, kernel, plain), bound {b2['bound_ms']:.3f} ms by "
              f"{b2['bound_by']}; max|kernel-plain| {err:.3e}")
        out["B2"] = {"max_abs_err": err, "ms": statistics.mean(kern_ms),
                     "plain_ms": statistics.mean(plain_ms), "library_ms": None, **b2,
                     "shape": f"rows={rows} D={d} K={k}"}
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

    # B3 and B4 alone at B=64 (6.4 TFLOP per product set)
    split = gmm_split_times(64 * 196, d, MDN_K, head, card, gen, runs)
    out["B3"], out["B4"] = split["B3"], split["B4"]

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


def fused_mlp_main_path(tmp: str, nf_pth: str, deit_pth: str, img_dir: str, files,
                        default_scores, f32_cuda_scores) -> dict:
    """Phase 5: the phase-4 folder and weights scored again by `cli.score`
    with `--no-fused-mlp`: B1 once per block per batch, B6 never. bf16 scores
    against phase 4's; under the f32 policy (erf GELU) the flag on launches
    nothing and leaves the scores as they were."""
    import numpy as np
    import torch
    from vit_ad_tpu_torch.cli import score as score_cli
    from vit_ad_tpu_torch.config import DtypePolicy
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.ops.cuda import mlp as cmlp
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models, score_models

    flag = "--no-fused-mlp"
    out_dir = os.path.join(tmp, "scores_other_mlp_flag")
    reset_launches()
    t0 = time.perf_counter()
    rc = score_cli.main(["--pth", nf_pth, "-a", "nf", "-m", "enc_deit", "-E", deit_pth,
                         "-d", img_dir, "-b", str(SMOKE_BATCH), "-o", out_dir, flag])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_batches = -(-N_IMAGES // SMOKE_BATCH)
    expect = {**NO_LAUNCHES, "B1": 12 * n_batches, "B7": DEIT_B7_PER_BATCH * n_batches}
    print(f"cli.score.main {flag} rc={rc} in {wall:.2f} s; launches {launches}, expected "
          f"{expect} (12 attention, {DEIT_B7_PER_BATCH} LayerNorm and no MLP launches x "
          f"{n_batches} batches); wgmma route {cmlp.wgmma_launches}")
    if rc != 0 or launches != expect or cmlp.wgmma_launches != 0:
        raise AssertionError(f"the {flag} path launched the MLP kernel, or not the attention "
                             f"kernel once per block per batch")
    scores = check_scores_csv(out_dir, files, f"NF, {flag}")
    rel = np.abs(scores - default_scores) / np.abs(default_scores)
    print(f"bf16 image scores, {flag} vs the default ({len(scores)} images): max rel diff "
          f"{rel.max():.3e} (rtol {FUSED_MLP_SCORE_RTOL:.0e}: other rounding points of the "
          f"hidden activations and the residual)")
    if not rel.max() <= FUSED_MLP_SCORE_RTOL:
        raise AssertionError("bf16 scores with the fused MLP are off the unfused ones")

    reset_launches()
    m = build_pth_models(nf_pth, "enc_deit", "nf", encoder_ckpt=deit_pth,
                         dtypes=DtypePolicy.f32(), device="cuda", fused_mlp=True)
    mean, std = default_norm_stats()
    got = score_models(m, DataPipeline(2, 224, files=files[:2]), mean, std).image_scores
    f32_launches = read_launches()
    print(f"f32 policy with the flag on (erf GELU: the gate is off): launches {f32_launches}, "
          f"scores {got.tolist()} vs the default {f32_cuda_scores.tolist()}")
    if f32_launches != {**NO_LAUNCHES, "B1": 12, "B7": DEIT_B7_PER_BATCH} or \
            not np.array_equal(got, f32_cuda_scores):
        raise AssertionError("the f32 policy took the fused MLP or its scores moved")
    return {"launches": launches}


def resnet_main_path(tmp: str) -> dict:
    """Phase 8: train the two stage heads (K=100) and the stage LayerNorms on
    a full-width ResNet-50 with `cli.train_mdn -m res_net` on a synthetic
    224-px category, score its test folder with `cli.score` on the files it
    wrote; launch counts per step and batch (B4 on every step, never while
    scoring), the loss, which parameters moved, and f32 scores against the
    CPU at K=4."""
    import glob

    import numpy as np
    import torch
    from vit_ad_tpu_torch.cli import score as score_cli
    from vit_ad_tpu_torch.cli import train_mdn as train_cli
    from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.data.synthetic import make_mvtec_category
    from vit_ad_tpu_torch.models.mdn import GaussianMDN
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm
    from vit_ad_tpu_torch.pipeline.loading import build_pth_resnet_mdn_models, score_models
    from vit_ad_tpu_torch.pipeline.train import default_encoder

    cat = make_mvtec_category(os.path.join(tmp, "resnet"), "bracket", img_size=224,
                              n_train=RESNET_TRAIN, n_test_good=RESNET_TEST,
                              n_test_defect=RESNET_TEST)
    test_dir = os.path.join(cat, "test")
    run = os.path.join(tmp, "resnet_run")
    split = DataPipeline(RESNET_BATCH, 224, base_path=cat, data_path="train/good")
    n_batches = lambda n, b: -(-n // b)
    n_tr = n_batches(len(split.train_files), RESNET_BATCH)
    n_va = n_batches(len(split.valid_files), RESNET_BATCH)
    n_te = n_batches(2 * RESNET_TEST, RESNET_BATCH)

    reset_launches()
    t0 = time.perf_counter()
    rc = train_cli.main(["-m", "res_net", "-d", cat, "-t", "train/good", "-v", "test",
                         "-n", str(RESNET_K), "-e", str(RESNET_EPOCHS),
                         "-p", str(RESNET_EPOCHS), "-b", str(RESNET_BATCH), "-i", "224",
                         "--device", "cuda", "--out", run])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train = read_launches()
    with open(os.path.join(run, "history.json")) as f:
        hist = json.load(f)
    ep = hist["epochs_ran"]
    # every joint step (padded batches: RESNET_BATCH x tokens rows per head):
    # one forward per head, and per chunk of components B3's two kernels and
    # B4's one, since the stage norms need the features' gradient; the
    # noiseless validation loss and the evaluation: forwards only
    chunks = [-(-RESNET_K // cgmm.backward_chunk(RESNET_BATCH * tokens, d, RESNET_K,
                                                 DtypePolicy().compute_dtype))
              for d, tokens in RESNET_HEADS]
    steps = ep * n_tr
    expect = {**NO_LAUNCHES, "B2": 2 * (ep * (n_tr + n_va) + n_te),
              "B3": steps * 2 * sum(chunks), "B4": steps * sum(chunks)}
    print(f"cli.train_mdn.main -m res_net rc={rc} in {wall:.2f} s ({ep} epochs x {n_tr} train + "
          f"{n_va} valid batches of {RESNET_BATCH}, {n_te} test batch; backward chunks "
          f"{chunks} at D=1024, 2048): launches {train}, expected {expect}; through the "
          f"wgmma kernels B2 {cgmm.fwd_wgmma_launches}, B3 {cgmm.bwd_wgmma_params_launches}, "
          f"B4 {cgmm.bwd_wgmma_x_launches}")
    if rc != 0 or train != expect or ep != RESNET_EPOCHS or \
            cgmm.fwd_wgmma_launches != expect["B2"] or \
            cgmm.bwd_wgmma_params_launches != expect["B3"] or \
            cgmm.bwd_wgmma_x_launches != expect["B4"]:
        raise AssertionError("the ResNet MDN training path did not launch B2, B3 and B4 for "
                             "both heads on every step, each through its wgmma kernels")
    if not all(math.isfinite(v) for v in hist["train_loss"] + hist["valid_loss"]) or \
            not all(math.isfinite(v) for v in hist["metrics"].values()):
        raise AssertionError(f"non-finite losses or metrics: {hist}")
    if not hist["train_loss"][-1] < hist["train_loss"][0]:
        raise AssertionError(f"the joint train loss did not fall: {hist['train_loss']}")
    print(f"train loss {hist['train_loss']}, valid loss {hist['valid_loss']}, "
          f"metrics {hist['metrics']} (random trunk: information only)")

    pths = sorted(glob.glob(os.path.join(run, f"{RESNET_K}_gaussians_enc_res_net_stage*.pth")))
    (enc_pth,) = glob.glob(os.path.join(run, "ResNetEncoder_*.pth"))
    if len(pths) != 2:
        raise AssertionError(f"expected one head file per stage, got {pths}")
    # the trunk is frozen: bit-identical to the seeded init the CLI started
    # from; the stage norms the heads read have trained, the others have not
    hp = HyperParams(model_name="enc_res_net", img_size=224)
    init = default_encoder(hp).state_dict()
    after = torch.load(enc_pth, map_location="cpu", weights_only=True)
    moved = sorted(k for k, v in init.items() if not torch.equal(v, after[k]))
    want_moved = sorted(f"norms.{i}.{leaf}" for i in (2, 3) for leaf in ("weight", "bias"))
    print(f"encoder file: {len(after)} tensors, changed by training: {moved}")
    if sorted(after) != sorted(init) or moved != want_moved:
        raise AssertionError(f"training moved {moved}, expected exactly {want_moved}")
    del init, after

    out_dir = os.path.join(tmp, "resnet_scores")
    reset_launches()
    t0 = time.perf_counter()
    rc = score_cli.main(["--pth", *pths, "-a", "mdn", "-E", enc_pth, "-d", test_dir,
                         "-b", str(RESNET_SCORE_BATCH), "-o", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    score = read_launches()
    expect = {**NO_LAUNCHES, "B2": 2 * n_batches(2 * RESNET_TEST, RESNET_SCORE_BATCH)}
    print(f"cli.score.main -a mdn, two stage heads, rc={rc} in {wall:.2f} s: launches {score}, "
          f"expected {expect}; B2 through the wgmma kernel {cgmm.fwd_wgmma_launches}")
    if rc != 0 or score != expect or cgmm.fwd_wgmma_launches != expect["B2"]:
        raise AssertionError("ResNet MDN scoring did not launch B2 once per head per batch "
                             "(and B3, B4 never)")
    files = score_cli.list_images(test_dir)
    scores = check_scores_csv(out_dir, files, "ResNet MDN")
    if not (np.all(scores >= 0) and np.all(scores <= 1)):
        raise AssertionError("ResNet MDN image scores lie outside [0, 1]")

    # f32 on the card against the CPU with seeded K=4 heads (K=100 heads take
    # the CPU minutes per batch) on the trained encoder
    small = []
    for (d, _), stage in zip(RESNET_HEADS, (2, 3)):
        path = os.path.join(tmp, f"{RESNET_CPU_K}_gaussians_enc_res_net_stage{stage}_bracket.pth")
        torch.save(GaussianMDN(d, RESNET_CPU_K,
                               generator=torch.Generator().manual_seed(stage)).state_dict(), path)
        small.append(path)
    mean, std = default_norm_stats()
    got = {}
    for device in ("cuda", "cpu"):
        m = build_pth_resnet_mdn_models(small, encoder_ckpt=enc_pth, dtypes=DtypePolicy.f32(),
                                        device=device)
        got[device] = score_models(m, DataPipeline(4, 224, files=files[:4]), mean, std)
    rel = np.abs(got["cuda"].image_scores - got["cpu"].image_scores) \
        / np.abs(got["cpu"].image_scores)
    map_diff = np.abs(got["cuda"].pixel_scores - got["cpu"].pixel_scores).max()
    print(f"ResNet MDN f32 image scores (K={RESNET_CPU_K}) cuda "
          f"{got['cuda'].image_scores.tolist()} cpu {got['cpu'].image_scores.tolist()}: max rel "
          f"diff {rel.max():.3e} (rtol {SCORE_RTOL_F32:.0e}); anomaly maps in [0, 1]: max abs "
          f"diff {map_diff:.3e}")
    if not rel.max() <= SCORE_RTOL_F32:
        raise AssertionError("CUDA f32 ResNet MDN scores disagree with the CPU path")
    return {"launches": {k: train[k] + score[k] for k in train}, "pths": pths,
            "encoder": enc_pth}


def mlp_times(card: str, gen) -> dict:
    """Phase 9, B6: the MLP half-block at the DeiT-base shape of a B=128
    batch, bf16: kernel vs plain (order plain, kernel, kernel, plain) vs the
    stock tail of `models/vit._block_apply` (LayerNorm on the f32 cast, two
    `F.linear`, `F.gelu`, add: the library's path for the same function),
    beside the bound; the same back to back; and its three steps alone: k0
    (the LayerNorm kernel at eps 1e-6), k1 (product + GELU) and k2 (product +
    residual), each beside the one `F.linear` of its product. Returns the
    kernel's JSON numbers."""
    import torch
    import torch.nn.functional as F
    from vit_ad_tpu_torch.ops import mlp as mops
    from vit_ad_tpu_torch.ops.cuda import layer_norm as ln
    from vit_ad_tpu_torch.ops.cuda import mlp as cmlp

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rows, d, hidden = MLP_CASES[0]
    args = mlp_inputs(rows, d, hidden, bf16, gen, dev)
    x, nw, nb, w1, b1, w2, b2 = args
    b1c, b2c = b1.to(bf16), b2.to(bf16)  # the stock tail's cached compute-dtype biases
    kern = lambda: cmlp.mlp_block(*args, MLP_EPS)
    plain = lambda: mops.mlp_block_reference(*args, MLP_EPS)

    def stock():
        y = F.layer_norm(x.float(), (d,), nw, nb, MLP_EPS).to(bf16)
        h = F.gelu(F.linear(y, w1, b1c), approximate="tanh")
        return x + F.linear(h, w2, b2c)

    with torch.no_grad():
        before = cmlp.wgmma_launches
        got, want = kern(), plain()
        if cmlp.mlp_route(d, hidden, bf16) != "wgmma" or cmlp.wgmma_launches != before + 1:
            raise AssertionError("B6 did not take the wgmma route at the DeiT-base shape")
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        stock_err = (got.float() - stock().float()).abs().max().item()
        if not err <= MLP_TOL["bfloat16"] * scale:
            raise AssertionError(f"B6 disagrees with its plain version at [{rows},{d}]: {err}")
        kern_ms, plain_ms = alternate(kern, plain, TIMED_RUNS, 3)
        stock_ms = median_ms(stock, torch)
        b2b = [back_to_back_ms(f, torch, launches=50) for f in (kern, stock)]
    flops = 4 * rows * d * hidden
    nums = {"max_abs_err": err, "ms": statistics.mean(kern_ms),
            "plain_ms": statistics.mean(plain_ms), "library_ms": stock_ms,
            **bound(tensor_bytes(*args) + tensor_bytes(x), flops),
            "design": "LayerNorm kernel + two persistent wgmma GEMMs behind TMA (128x192 tiles, "
                      "4-stage ring, GELU / residual epilogues stored by TMA)"}
    print(f"[{card}] mlp_block (B6) [{rows},{d}] H={hidden} bf16: kernel {kern_ms} ms "
          f"({flops / nums['ms'] / 1e9:.1f} TFLOP/s), "
          f"plain {plain_ms} ms (order plain, kernel, kernel, plain), stock tail (F.layer_norm on "
          f"the f32 cast, F.linear, F.gelu, F.linear, add) {stock_ms:.4f} ms, bound "
          f"{nums['bound_ms']:.4f} ms by {nums['bound_by']}; back to back (50 calls) kernel "
          f"{b2b[0]:.4f} ms, stock tail {b2b[1]:.4f} ms; max|kernel-plain| {err:.3e} of "
          f"max|plain| {scale:.2f}, max|kernel-stock| {stock_err:.3e}")

    # the three steps alone, on this call's own intermediates
    with torch.no_grad():
        y = ln.layer_norm(x, nw, nb, MLP_EPS)
        hid = cmlp.gemm_step(y, w1, b1, cmlp.EPILOGUE_GELU)
        k0 = lambda: ln.layer_norm(x, nw, nb, MLP_EPS)
        k0_ms, k0_b2b = median_ms(k0, torch), back_to_back_ms(k0, torch)
        print(f"[{card}]   k0 LayerNorm [{rows},{d}] bf16 eps 1e-6: {k0_ms:.4f} ms (back to back "
              f"{k0_b2b:.4f} ms), bound {bound(2 * tensor_bytes(x), 0)['bound_ms']:.4f} ms by "
              f"bytes")
        half = flops / 2
        for name, a, w, bias, epi, resid in (("k1 GELU(y.W1^T + b1)", y, w1, b1,
                                              cmlp.EPILOGUE_GELU, None),
                                             ("k2 x + hidden.W2^T + b2", hid, w2, b2,
                                              cmlp.EPILOGUE_RESIDUAL, x)):
            lib_ms = median_ms(lambda: F.linear(a, w), torch)
            step = lambda: cmlp.gemm_step(a, w, bias, epi, resid)
            ms, ms_b2b = median_ms(step, torch), back_to_back_ms(step, torch, launches=50)
            print(f"[{card}]   {name} [{a.shape[0]},{a.shape[1]}]x[{w.shape[0]},"
                  f"{w.shape[1]}]^T, 128x192 tiles: {ms:.4f} ms = {half / ms / 1e9:.1f} TFLOP/s "
                  f"(back to back {ms_b2b:.4f} ms = {half / ms_b2b / 1e9:.1f} TFLOP/s); "
                  f"F.linear alone, no epilogue, {lib_ms:.4f} ms; bound "
                  f"{half / PEAK_BF16_FLOPS * 1e3:.4f} ms by operations")
    return nums


def flag_ab(name: str, trunk: str, flag: str, images, card: str, build):
    """uint8→scores img/s of `trunk` + NF-20 at B=128 bf16 with a kernel flag
    off and on (`build(flag value)` gives the RunModels; order off, on, on,
    off), the encoder alone likewise, and how far the scores move. Returns
    ({flag value: the scoring function}, the flag-on RunModels)."""
    import torch
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import preprocess
    from vit_ad_tpu_torch.pipeline.eval import make_nf_batch_fn

    mean, std = (torch.as_tensor(a, device=images.device) for a in default_norm_stats())
    fns, encs = {}, {}
    for on in (False, True):
        m = build(on)
        batch_fn = make_nf_batch_fn(*m.parts, m.hp, mean, std)

        def scores(batch_fn=batch_fn):
            with torch.inference_mode():
                return batch_fn(images).amax(dim=(1, 2))

        def encode(enc=m.parts[0]):
            with torch.inference_mode():
                return enc(preprocess(images, mean, std)).patch_embedding

        fns[on], encs[on] = scores, encode
        out = scores()
        if out.shape != (FLAGSHIP_BATCH,) or not torch.isfinite(out).all():
            raise AssertionError(f"{name} batch gave non-finite or misshapen scores")
    s_on, s_off = fns[True](), fns[False]()
    drift = ((s_on - s_off).abs() / s_off.abs()).max().item()
    for what, pair in ((f"uint8→scores {trunk} + NF-20", fns),
                       (f"uint8→tokens {trunk} alone", encs)):
        off = [median_ms(pair[False], torch, runs=10)]
        on = [median_ms(pair[True], torch, runs=10), median_ms(pair[True], torch, runs=10)]
        off.append(median_ms(pair[False], torch, runs=10))
        rate = lambda ms: FLAGSHIP_BATCH / statistics.mean(ms) * 1e3
        print(f"[{card}] {name} {what} B={FLAGSHIP_BATCH} bf16, batch on the device: {flag} "
              f"off {off} ms = {rate(off):.1f} img/s, on {on} ms = {rate(on):.1f} img/s "
              f"(order off, on, on, off)")
    print(f"{name} scores with the {flag} on vs off, B={FLAGSHIP_BATCH}: max rel diff "
          f"{drift:.3e} (bf16 roundings)")
    return fns, m


def fused_mlp_ab(nf_pth: str, deit_pth: str, images, card: str) -> dict:
    """Phase 9: DeiT-base + NF-20 uint8→scores img/s at B=128 bf16 with the
    fused MLP off and on (order off, on, on, off), and the encoder alone; B6
    runs 12 times per batch with the flag on, each through the wgmma route,
    never with it off; the peak memory of a batch either way. Returns {flag
    value: the scoring function}."""
    import torch
    from vit_ad_tpu_torch.ops.cuda import mlp as cmlp
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models

    fns, _ = flag_ab("DeiT", "DeiT-base", "fused MLP", images, card,
                     lambda fused: build_pth_models(nf_pth, "enc_deit", "nf",
                                                    encoder_ckpt=deit_pth,
                                                    device=torch.device("cuda"),
                                                    fused_mlp=fused))
    for fused, want in ((False, 0), (True, 12)):
        before = cmlp.launches, cmlp.wgmma_launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fns[fused]()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        took = cmlp.launches - before[0], cmlp.wgmma_launches - before[1]
        print(f"[{card}] DeiT NF batch of {FLAGSHIP_BATCH} with fused_mlp={fused}: B6 launches "
              f"{took[0]} (wgmma route {took[1]}), peak memory {peak:.2f} GiB (both models and "
              f"the batch resident)")
        if took != (want, want):
            raise AssertionError(f"fused_mlp={fused}: {took} B6 launches per batch (all, wgmma "
                                 f"route), expected {want}")
    return fns


def vit_norm_ab(nf_pth: str, deit_pth: str, images, card: str) -> None:
    """Phase 9: DeiT-base + NF-20 uint8→scores img/s at B=128 bf16 with the
    blocks' first norm and the final norm through the LayerNorm kernel (B7,
    the port's path: 13 launches a batch) and through `F.layer_norm` on the
    f32 cast and back (the path before it: `models/vit.layer_norm` swapped for
    that expression during the "off" turns), order off, on, on, off."""
    import torch
    import torch.nn.functional as F
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.models import vit
    from vit_ad_tpu_torch.ops.cuda import layer_norm as ln
    from vit_ad_tpu_torch.pipeline.eval import make_nf_batch_fn
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models

    dev = torch.device("cuda")
    mean, std = (torch.as_tensor(a, device=dev) for a in default_norm_stats())
    m = build_pth_models(nf_pth, "enc_deit", "nf", encoder_ckpt=deit_pth, device=dev)
    batch_fn = make_nf_batch_fn(*m.parts, m.hp, mean, std)
    kernel_norm = vit.layer_norm
    unfused = lambda x, w, b, eps: F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)

    def scores(on: bool):
        vit.layer_norm = kernel_norm if on else unfused
        try:
            with torch.inference_mode():
                return batch_fn(images).amax(dim=(1, 2))
        finally:
            vit.layer_norm = kernel_norm

    launched = {}
    for on in (False, True):
        before = ln.launches
        out = scores(on)
        torch.cuda.synchronize()
        launched[on] = ln.launches - before
        if out.shape != (FLAGSHIP_BATCH,) or not torch.isfinite(out).all():
            raise AssertionError("DeiT NF batch gave non-finite or misshapen scores")
    if launched != {False: 0, True: DEIT_B7_PER_BATCH}:
        raise AssertionError(f"B7 launches per DeiT batch with the norms off / on: {launched}")
    drift = ((scores(True) - scores(False)).abs() / scores(False).abs()).max().item()
    off = [median_ms(lambda: scores(False), torch, runs=10)]
    on = [median_ms(lambda: scores(True), torch, runs=10) for _ in range(2)]
    off.append(median_ms(lambda: scores(False), torch, runs=10))
    rate = lambda ms: FLAGSHIP_BATCH / statistics.mean(ms) * 1e3
    print(f"[{card}] DeiT uint8→scores DeiT-base + NF-20 B={FLAGSHIP_BATCH} bf16, batch on the "
          f"device, norm1 and final norm: F.layer_norm on the f32 cast and back {off} ms = "
          f"{rate(off):.1f} img/s, the LayerNorm kernel (B7, {DEIT_B7_PER_BATCH} launches a "
          f"batch) {on} ms = {rate(on):.1f} img/s (order off, on, on, off); scores on vs off "
          f"max rel diff {drift:.3e} (bf16 roundings)")


def resnet_joint_step(k: int, images):
    """The ResNet-50 joint train step at batch RESNET_BATCH with two fresh
    K=`k` stage heads (seeded) and the stage norms under Adam: (step,
    encoder, heads, optimizer)."""
    import torch
    from vit_ad_tpu_torch.config import HyperParams
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.models.mdn import GaussianMDN
    from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
    from vit_ad_tpu_torch.pipeline.train import default_encoder, mdn_resnet_train_step

    dev = torch.device("cuda")
    mean, std = (torch.as_tensor(a, device=dev) for a in default_norm_stats())
    hp = HyperParams(model_name="enc_res_net", img_size=224)
    batch = images[:RESNET_BATCH]
    valid = torch.ones(RESNET_BATCH, device=dev)
    encoder = default_encoder(hp).to(dev)
    with torch.device(dev):
        init = torch.Generator(device=dev).manual_seed(hp.seed)
        heads = torch.nn.ModuleList(GaussianMDN(d, k, generator=init) for d, _ in RESNET_HEADS)
    opt = torch_adam(list(heads.parameters()) + list(encoder.norms.parameters()), 7e-4, 7e-4)
    noise = torch.Generator(device=dev).manual_seed(0)
    step = lambda: mdn_resnet_train_step(encoder, heads, opt, batch, valid, noise, mean, std)
    return step, encoder, heads, opt


def resnet_times(resnet: dict, images, card: str, gen) -> dict:
    """Phase 9, ResNet part: the joint train step (frozen trunk forward, two
    heads' B2 + B3 + B4, stage norms, Adam) at batch 16 with K=100 and K=150:
    ms, img/s, peak memory; B2, B3, B4 alone at the step's two head shapes
    (K=100); the trunk alone; multi-stage MDN scoring img/s at B=128 with the
    trained K=100 heads. Returns the per-shape JSON numbers of B2-B4."""
    import numpy as np
    import torch
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import preprocess
    from vit_ad_tpu_torch.pipeline.eval import make_mdn_resnet_batch_fn
    from vit_ad_tpu_torch.pipeline.loading import build_pth_resnet_mdn_models
    from vit_ad_tpu_torch.scoring import payload_to_scores

    dev = torch.device("cuda")
    mean, std = (torch.as_tensor(a, device=dev) for a in default_norm_stats())
    batch = images[:RESNET_BATCH]
    per_shape = []
    for k in RESNET_TIMED_KS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step, encoder, heads, opt = resnet_joint_step(k, images)
        before = read_launches()
        loss = step()
        after = read_launches()
        if not torch.isfinite(loss) or not after["B4"] > before["B4"]:
            raise AssertionError(f"ResNet MDN train step: loss {loss}, B4 launches "
                                 f"{after['B4'] - before['B4']}")
        ms = median_ms(step, torch, runs=5, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        weights = sum(p.numel() * 4 for p in heads.parameters()) / 2**30
        print(f"[{card}] ResNet-50 + MDN joint train step (trunk forward, B2 + B3 + B4 on "
              f"D=1024 x {RESNET_BATCH * 196} rows and D=2048 x {RESNET_BATCH * 49} rows, "
              f"stage norms, Adam) B={RESNET_BATCH} K={k} bf16: {ms:.3f} ms = "
              f"{RESNET_BATCH / ms * 1e3:.1f} img/s; peak memory {peak:.2f} GiB (head weights "
              f"{weights:.2f} GiB f32), launches per step "
              f"{ {key: after[key] - before[key] for key in ('B2', 'B3', 'B4')} }")
        if k == RESNET_K:
            for (d, tokens), head in zip(RESNET_HEADS, heads):
                opt.zero_grad(set_to_none=True)
                per_shape.append(gmm_split_times(RESNET_BATCH * tokens, d, k, head, card, gen,
                                                 MDN_TIMED_RUNS))

            def trunk():
                with torch.inference_mode():
                    return encoder.stage_features(preprocess(batch, mean, std), (2, 3))

            trunk_ms = median_ms(trunk, torch, runs=10)
            print(f"[{card}] ResNet-50 trunk + stage norms 2, 3 alone, B={RESNET_BATCH} bf16 "
                  f"(cuDNN convolutions, no kernel of the port): {trunk_ms:.3f} ms")
        del opt, heads, encoder, step
    torch.cuda.empty_cache()

    m = build_pth_resnet_mdn_models(resnet["pths"], encoder_ckpt=resnet["encoder"], device=dev)
    fn = make_mdn_resnet_batch_fn(*m.parts, m.hp, mean, std)

    def stage_lls():
        with torch.inference_mode():
            return fn(images)

    lls = stage_lls()
    if [tuple(t.shape) for t in lls] != [(FLAGSHIP_BATCH, t) for _, t in RESNET_HEADS] or \
            not all(torch.isfinite(t).all() for t in lls):
        raise AssertionError("ResNet MDN scoring batch gave non-finite or misshapen output")
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(stage_lls, torch, runs=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] ResNet-50 + MDN uint8→per-stage patch log-likelihoods, K={RESNET_K} "
          f"B={FLAGSHIP_BATCH} bf16, batch on the device: {ms:.3f} ms/batch = "
          f"{FLAGSHIP_BATCH / ms * 1e3:.1f} img/s; peak memory {peak:.2f} GiB")

    def scores():
        # the host score tail of score_mdn_resnet, per batch: normalization by
        # the batch's max, 224-px maps averaged over the stages, max
        return payload_to_scores(
            "mdn_resnet", tuple(t.float().cpu().numpy() for t in stage_lls()), 224)[0]

    s = scores()
    if s.shape != (FLAGSHIP_BATCH,) or not np.all(np.isfinite(s)):
        raise AssertionError("ResNet MDN score tail gave non-finite or misshapen scores")
    ms = median_ms(scores, torch, runs=5, warmup=1)
    print(f"[{card}] ResNet-50 + MDN uint8→scores, device part + host score tail, K={RESNET_K} "
          f"B={FLAGSHIP_BATCH} bf16: {ms:.3f} ms/batch = {FLAGSHIP_BATCH / ms * 1e3:.1f} img/s")
    return {key: [shape[key] for shape in per_shape] for key in ("B2", "B3", "B4")}


# B2's shapes on the main paths, (what, rows, D, K): DeiT MDN scoring at
# B=128 and its train step at B=64, the ResNet-50 stage-2 and stage-3 heads on
# a 16-image step
GMM_PATH_SHAPES = [("DeiT MDN scoring B=128", 25088, 768, 150),
                   ("DeiT MDN train B=64", 12544, 768, 150),
                   ("ResNet stage 2, 16 images", 3136, 1024, 100),
                   ("ResNet stage 3, 16 images", 784, 2048, 100)]
# B7's shapes: the Swin-T block norms at B=128 and B6's LayerNorm step
LN_PATH_SHAPES = LN_STAGES + [(25344, 768)]


def gmm_forward_args(entries: dict, t: dict, rows: int, d: int, k: int) -> list:
    """gmm_forward's arguments (but the stream and the route) in the layout
    of the checkout whose ENTRY_POINTS are `entries`: x rounded to bf16 and
    component-major log_pi and biases beside x (this form), or, in a checkout
    whose entry takes no route, log_pi [rows, K] and the Linear-layout biases.
    `t` holds both layouts."""
    if len(entries["gmm_forward"]) == 13:
        return [t["x"].data_ptr(), t["log_pi"].data_ptr(), t["w_mu"].data_ptr(),
                t["w_sigma"].data_ptr(), t["b_mu"].data_ptr(), t["b_sigma"].data_ptr(),
                t["ll"].data_ptr(), rows, d, k, 1, 0]
    return [t["x"].data_ptr(), t["x_m"].data_ptr(), t["log_pi_t"].data_ptr(),
            t["w_mu"].data_ptr(), t["w_sigma"].data_ptr(), t["b_mu_t"].data_ptr(),
            t["b_sigma_t"].data_ptr(), t["ll"].data_ptr(), rows, d, k, 1, 0]


def checkout_module(root: str, rel: str, name: str):
    """The Python file <root>/<rel> of another checkout as a module named
    `name`, or None where that checkout has no such file."""
    import importlib.util

    path = os.path.join(root, rel)
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_checkout(root, who: str):
    """(library, ENTRY_POINTS) of the checkout at `root` (None: this one),
    its kernels built from its csrc by its own ops/cuda/build.py."""
    import ctypes

    from vit_ad_tpu_torch.ops.cuda import build

    mod = build if root is None else checkout_module(
        root, os.path.join("vit_ad_tpu_torch", "ops", "cuda", "build.py"), f"{who}_build")
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(mod.build()))
    for entry, argtypes in mod.ENTRY_POINTS.items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
    print(f"{who}: built and loaded {mod.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return lib, mod.ENTRY_POINTS


def against(parent: str) -> int:
    """`python3 chip_smoke.py --against <checkout>`: every kernel entry point of
    the checkout at <checkout> (built from its csrc by its own
    ops/cuda/build.py) against this checkout's, called raw on the same inputs,
    back to back (200 launches; B2 5), in turns parent, change, change, parent:
    B5 at the four Swin-T stage shapes of a B=128 batch and at stage 0 without
    the mask, B5a at stage 0, B1 at DeiT-base B=128, B6 at [25344,768] H=3072,
    B7 at the four Swin-T block norms and B6's LayerNorm step (beside
    `F.layer_norm` on the same bf16 rows, before and after the turns), B2 bf16
    at `GMM_PATH_SHAPES`, and B3 and B4 bf16 at `GMM_BWD_PATH_SHAPES`
    (`gmm_backward_against`). Prints ms per call, the bound, and the change's
    largest difference from the parent's output."""
    import ctypes

    import torch
    import torch.nn.functional as F
    from vit_ad_tpu_torch.ops import window_attention as wops
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py --against: torch.cuda.is_available() is False")
    card = card_line()
    print(card, flush=True)
    libs = {who: load_checkout(root, who) for who, root in (("parent", parent), ("change", None))}

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    route = ctypes.c_int(0)
    ptr = lambda t: None if t is None else t.data_ptr()

    def call(who: str, entry: str, args, out):
        lib, entries = libs[who]
        takes_route = entries[entry][-1] is ctypes.POINTER(ctypes.c_int)
        fn = getattr(lib, entry)
        args = args(entries) if callable(args) else args

        def run():
            err = fn(*args, stream, *((ctypes.byref(route),) if takes_route else ()))
            if err:
                raise RuntimeError(f"{who} {entry} failed: error {err}")
            return out
        return run

    # (name, entry, its arguments but the stream and the route, or a function
    # of a checkout's ENTRY_POINTS giving them, the output, launches per turn,
    # the library call or None, (bytes, FLOP) of the bound); `hold` keeps
    # every tensor whose pointer an argument list holds alive
    cases, hold = [], []
    for stage, windows, side, c, heads, n_w in SWIN_STAGES:
        case = (windows, side, c, heads, windows // n_w if n_w else 0, 0)
        qkv3, table, mask = window_inputs(case, bf16, gen, dev)
        n, hd = side * side, c // heads
        bias = wops.gather_bias(table, torch.from_numpy(
            wops.relative_position_index(side, side)).to(dev)).contiguous()
        scale = wa._scale_value(hd, bf16)
        hold += [qkv3, bias, mask]
        for m in ((mask, None) if mask is not None else (None,)):
            out = torch.empty(windows, n, c, dtype=bf16, device=dev)
            cases.append((f"B5 {stage} [{windows},{n},{3 * c}] H={heads} "
                          f"mask={'shift' if m is not None else 'none'}",
                          "swin_window_attention_forward",
                          [qkv3.data_ptr(), qkv3[..., c:].data_ptr(), qkv3[..., 2 * c:].data_ptr(),
                           out.data_ptr(), bias.data_ptr(), ptr(m), windows, n, heads, hd, 3 * c,
                           1 if m is None else m.shape[0], 1, 1, scale, 0], out, 200, None,
                          None))
        if stage == "stage 0":
            split = [t.contiguous() for t in qkv3.reshape(windows, n, 3, c).unbind(2)]
            hold += split
            out = torch.empty(windows, n, c, dtype=bf16, device=dev)
            cases.append((f"B5a {stage} split [{windows},{n},{c}] x 3 H={heads} mask=shift",
                          "swin_window_attention_forward",
                          [*(t.data_ptr() for t in split), out.data_ptr(), bias.data_ptr(),
                           mask.data_ptr(), windows, n, heads, hd, c, mask.shape[0], 0, 1, scale,
                           0], out, 200, None, None))
    qkv = torch.randn(FLAGSHIP_BATCH, 198, 3 * 768, device=dev, generator=gen).to(bf16)
    out = torch.empty(FLAGSHIP_BATCH, 198, 768, dtype=bf16, device=dev)
    hold.append(qkv)
    cases.append(("B1 [128,198,2304] H=12", "vit_attention_qkv_forward",
                  [qkv.data_ptr(), out.data_ptr(), FLAGSHIP_BATCH, 198, 12, 64, 1,
                   wa._scale_value(64, bf16), 0], out, 200, None, None))
    rows, d, hidden = MLP_CASES[0]
    mlp = mlp_inputs(rows, d, hidden, bf16, gen, dev)  # x, norm w/b, w1, b1, w2, b2
    out, y = torch.empty_like(mlp[0]), torch.empty_like(mlp[0])
    hid = torch.empty(rows, hidden, dtype=bf16, device=dev)
    hold += [*mlp, y, hid]
    cases.append((f"B6 [{rows},{d}] H={hidden}", "mlp_block_forward",
                  [*(t.data_ptr() for t in mlp), out.data_ptr(), y.data_ptr(), hid.data_ptr(),
                   rows, d, hidden, MLP_EPS, 1, 0], out, 200, None, None))
    for rows, d in LN_PATH_SHAPES:
        x = (1.5 * torch.randn(rows, d, device=dev, generator=gen) + 0.3).to(bf16)
        scale, shift = (torch.randn(d, device=dev, generator=gen) for _ in range(2))
        scale_bf, shift_bf = scale.to(bf16), shift.to(bf16)
        out = torch.empty_like(x)
        hold += [x, scale, shift, scale_bf, shift_bf]
        lib = lambda x=x, d=d, w=scale_bf, b=shift_bf: F.layer_norm(x, (d,), w, b, LN_EPS)
        cases.append((f"B7 [{rows},{d}]", "layer_norm_forward",
                      [x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), rows, d,
                       LN_EPS, 1, 0], out, 200, lib, (2 * tensor_bytes(x), 0)))
    for what, rows, d, k in GMM_PATH_SHAPES:
        x = torch.randn(rows, d, device=dev, generator=gen)
        log_pi = torch.log(torch.softmax(torch.randn(rows, k, device=dev, generator=gen), -1)
                           + 1e-15)
        s_w = 0.5 / math.sqrt(d)
        t = {"x": x, "x_m": x.to(bf16), "log_pi": log_pi,
             "log_pi_t": cgmm.component_major(log_pi),
             "ll": torch.empty(rows, d, device=dev)}
        for name in ("mu", "sigma"):
            t[f"w_{name}"] = (torch.randn(d * k, d, device=dev, generator=gen) * s_w).to(bf16)
            t[f"b_{name}"] = torch.randn(d * k, device=dev, generator=gen) * 0.1
            t[f"b_{name}_t"] = cgmm.component_major(t[f"b_{name}"].reshape(d, k))
        hold.append(t)
        cases.append((f"B2 {what} rows={rows} D={d} K={k}", "gmm_forward",
                      lambda entries, t=t, rows=rows, d=d, k=k:
                      gmm_forward_args(entries, t, rows, d, k), t["ll"], 5, None,
                      (tensor_bytes(x, log_pi, t["w_mu"], t["w_sigma"], t["b_mu"], t["b_sigma"],
                                    t["ll"]), 4 * rows * d * d * k)))

    for name, entry, args, out, launches, lib, work in cases:
        fns = {who: call(who, entry, args, out) for who in libs}
        b2b = lambda fn: back_to_back_ms(fn, torch, launches=launches,
                                         warmup=1 if launches < 10 else 10)
        with torch.no_grad():
            want = fns["parent"]().clone()
            diff = (fns["change"]().float() - want.float()).abs().max().item()
            times = {"parent": [], "change": [], "library": []}
            turns = ("parent", "change", "change", "parent")
            if lib is not None:
                turns = ("library",) + turns + ("library",)
                fns["library"] = lib
            for who in turns:
                times[who].append(b2b(fns[who]))
        ratio = statistics.mean(times["change"]) / statistics.mean(times["parent"])
        line = (f"[{card}] {name} bf16, back to back ({launches} launches), parent "
                f"{times['parent']} ms, change {times['change']} ms (order "
                f"{', '.join(turns)}): change / parent {ratio:.4f}; max|change-parent| {diff:.3e}")
        if lib is not None:
            line += f"; F.layer_norm on the bf16 rows {times['library']} ms"
        if work is not None:
            b = bound(*work)
            line += f"; bound {b['bound_ms']:.4f} ms by {b['bound_by']}"
            if work[1]:
                tflops = lambda ms: work[1] / statistics.mean(ms) / 1e9
                share = b["bound_ms"] / statistics.mean(times["change"])
                line += (f", {tflops(times['parent']):.1f} / {tflops(times['change']):.1f} "
                         f"TFLOP/s parent / change (the change at {share:.3f} of the bound)")
        print(line, flush=True)
    gmm_backward_against(libs, card, gen, stream)
    return 0


# B3 and B4 on the main paths, (what, rows, D, K): the DeiT MDN train step at
# B=64 (B4 is off that path: timed for comparison) and the ResNet-50 stage
# heads of a 16-image joint step
GMM_BWD_PATH_SHAPES = [("DeiT MDN train B=64", 12544, 768, 150),
                       ("ResNet stage 2, 16 images", 3136, 1024, 100),
                       ("ResNet stage 3, 16 images", 784, 2048, 100)]


def gmm_backward_calls(lib, entries, t: dict, o: dict, rows: int, d: int, k: int, kc: int,
                       sms: int, stream, with_sum: bool, dx_splits=None):
    """The backward's entry calls of one checkout, per chunk as its wrapper
    makes them: (terms, weights, x) lists of argument-bound calls. A checkout
    whose entries take no route (the first kernels) takes log_pi [rows, K] and
    the Linear-layout biases; this form the component-major ones, x_m, and B4's
    split count and partials. `t` holds the inputs in both layouts, `o` this
    checkout's outputs and scratch; `kc` components a chunk, `sms` SMs;
    `dx_splits` that checkout's split rule (default: this one's)."""
    import ctypes

    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

    first_form = entries["gmm_backward_terms"][-1] is not ctypes.POINTER(ctypes.c_int)
    route = ctypes.c_int(0)
    p = lambda name: None if name is None else (t.get(name) if name in t else o[name]).data_ptr()
    dmu_sum = "dmu_sum" if with_sum else None

    def bind(entry, args):
        fn = getattr(lib, entry)
        tail = (stream,) if first_form else (stream, ctypes.byref(route))

        def run():
            err = fn(*args, *tail)
            if err:
                raise RuntimeError(f"{entry} failed: error {err}")
        return run

    terms, weights, dx = [], [], []
    for k0 in range(0, k, kc):
        n = min(kc, k - k0)
        first, last = int(k0 == 0), int(k0 + n >= k)
        if first_form:
            terms.append(bind("gmm_backward_terms", [
                p("x"), p("log_pi"), p("g"), p("ll"), p("w_mu"), p("w_sigma"), p("b_mu"),
                p("b_sigma"), k0, n, p("dmu"), p("dpre"), p("bmu_part"), p("bsig_part"),
                p("dlp_part"), p(dmu_sum), rows, d, k, 1, 0]))
            weights.append(bind("gmm_backward_weights", [
                p("x"), p("dmu"), p("dpre"), p("dwm"), p("dws"), k0, n, rows, d, k, 1, 0]))
            dx.append(bind("gmm_backward_x", [
                p("dmu"), p("dpre"), p("w_mu"), p("w_sigma"), p("dmu_sum"), p("dx"), k0, n,
                first, last, rows, d, k, 1, 0]))
        else:
            splits = (dx_splits or cgmm.dx_splits)(rows, d, n, sms)
            terms.append(bind("gmm_backward_terms", [
                p("x"), p("x_m"), p("log_pi_t"), p("g"), p("ll"), p("w_mu"), p("w_sigma"),
                p("b_mu_t"), p("b_sigma_t"), k0, n, p("dmu"), p("dpre"), p("bmu_part"),
                p("bsig_part"), p("dlp_part"), p(dmu_sum), rows, d, k, 1, 0]))
            weights.append(bind("gmm_backward_weights", [
                p("x"), p("x_m"), p("dmu"), p("dpre"), p("dwm"), p("dws"), k0, n, rows, d, k, 1,
                0]))
            dx.append(bind("gmm_backward_x", [
                p("dmu"), p("dpre"), p("w_mu"), p("w_sigma"), p("dmu_sum"), p("dx"),
                p("dx_part"), k0, n, first, last, splits, rows, d, k, 1, 0]))
    return terms, weights, dx, first_form


def gmm_backward_inputs(rows: int, d: int, k: int, gen) -> dict:
    """Seeded backward inputs on the card in both checkouts' layouts: x, x_m,
    log_pi and its component-major copy, g, bf16 Linear-layout heads with f32
    biases (and their component-major copies), and ll from this checkout's B2."""
    import torch

    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    s_w = 0.5 / math.sqrt(d)
    x = torch.randn(rows, d, device=dev, generator=gen)
    log_pi = torch.log(torch.softmax(torch.randn(rows, k, device=dev, generator=gen), -1)
                       + 1e-15)
    t = {"x": x, "x_m": x.to(bf16), "log_pi": log_pi, "log_pi_t": cgmm.component_major(log_pi),
         "g": torch.randn(rows, d, device=dev, generator=gen)}
    for name in ("mu", "sigma"):
        t[f"w_{name}"] = (torch.randn(d * k, d, device=dev, generator=gen) * s_w).to(bf16)
        t[f"b_{name}"] = torch.randn(d * k, device=dev, generator=gen) * 0.1
        t[f"b_{name}_t"] = cgmm.component_major(t[f"b_{name}"].reshape(d, k))
    with torch.no_grad():
        t["ll"] = cgmm.gmm_log_likelihood(
            x[None], log_pi[None], t["w_sigma"], t["b_sigma"], t["w_mu"], t["b_mu"],
            matmul_dtype=bf16)[0].contiguous()
    return t


def gmm_backward_outputs(rows: int, d: int, k: int, kc: int) -> dict:
    """A checkout's backward outputs and scratch: dmu/dpre [kc, R, D] bf16,
    the partials (d log_pi flat, so either layout fits), dW, sum_k dmu, dx and
    MAX_DX_SPLITS partial dx buffers."""
    import torch

    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

    f32 = dict(dtype=torch.float32, device=torch.device("cuda"))
    o = {"dmu": torch.empty(kc, rows, d, dtype=torch.bfloat16, device=torch.device("cuda")),
         "bmu_part": torch.empty(-(-rows // 64), k, d, **f32),
         "dlp_part": torch.empty(d // 64, rows * k, **f32),
         "dwm": torch.empty(d * k, d, **f32), "dmu_sum": torch.empty(rows, d, **f32),
         "dx": torch.empty(rows, d, **f32),
         "dx_part": torch.empty(cgmm.MAX_DX_SPLITS, rows, d, **f32)}
    o["dpre"], o["bsig_part"] = torch.empty_like(o["dmu"]), torch.empty_like(o["bmu_part"])
    o["dws"] = torch.empty_like(o["dwm"])
    return o


def gmm_backward_against(libs: dict, card: str, gen, stream) -> None:
    """`--against`, B3 and B4: at `GMM_BWD_PATH_SHAPES`, each checkout's
    backward entries called raw as its wrapper calls them (terms and weights
    per chunk of components; dx per chunk), back to back in turns parent,
    change, change, parent: B3 whole and its two halves, B4; ms, TFLOP/s,
    the share of the bound; the change's largest difference from the parent
    in each gradient (the partials reduced in each checkout's layout); and,
    beside the weight-gradient half and B4, one torch.matmul pair on bf16
    operands of the same sizes ([R, D K] against the Linear-layout [D K, D]),
    a yardstick the port never calls."""
    import torch

    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for what, rows, d, k in GMM_BWD_PATH_SHAPES:
        t = gmm_backward_inputs(rows, d, k, gen)
        kc = cgmm.backward_chunk(rows, d, k, bf16)
        outs, calls, grads = {}, {}, {}
        for who, (lib, entries) in libs.items():
            o = outs[who] = gmm_backward_outputs(rows, d, k, kc)
            # the full backward with dx, for the comparison
            terms, weights, dx, first_form = gmm_backward_calls(lib, entries, t, o, rows, d, k,
                                                                kc, sms, stream, True)
            for a, b, c in zip(terms, weights, dx):
                a(), b(), c()
            dlp = o["dlp_part"].sum(0).reshape((rows, k) if first_form else (k, rows))
            grads[who] = {"dlog_pi": dlp if first_form else dlp.t(), "dw_mu": o["dwm"].clone(),
                          "dw_sigma": o["dws"].clone(), "db_mu": o["bmu_part"].sum(0).clone(),
                          "db_sigma": o["bsig_part"].sum(0).clone(), "dx": o["dx"].clone()}
            # what the paths time: B3 with sum_k dmu where dx is wanted (the
            # ResNet joint step), without on the frozen-trunk DeiT path
            calls[who] = gmm_backward_calls(lib, entries, t, o, rows, d, k, kc, sms, stream,
                                            not what.startswith("DeiT"))[:3]
        torch.cuda.synchronize()
        diffs = {}
        for name, want in grads["parent"].items():
            got = grads["change"][name]
            diffs[name] = ((got - want).abs().max() / want.abs().max()).item()
            if not math.isfinite(diffs[name]) or diffs[name] > GRAD_RTOL["bfloat16"]:
                raise AssertionError(f"--against: B3/B4 d{name} of the change differs from the "
                                     f"parent's by {diffs[name]} of its largest entry at {what}")
        prod = 2 * rows * d * d * k  # one [R, D] x [D, D] product per component
        a = torch.randn(rows, d * k, device=dev, generator=gen).to(bf16)
        pair = lambda fn: (lambda: (fn(), fn()))
        yard = {"weights": pair(lambda: torch.matmul(a.t(), t["x_m"])),
                "x": pair(lambda: torch.matmul(a, t["w_mu"]))}
        for part, idx, flop in (("B3", (0, 1), 4 * prod), ("B3 terms", (0,), 2 * prod),
                                ("B3 weights", (1,), 2 * prod), ("B4", (2,), 2 * prod)):
            seq = {who: (lambda fns=[f for i in idx for f in calls[who][i]]:
                         [fn() for fn in fns]) for who in calls}
            times = {"parent": [], "change": []}
            with torch.no_grad():
                for who in ("parent", "change", "change", "parent"):
                    times[who].append(back_to_back_ms(seq[who], torch, launches=3, warmup=1))
            ms = {who: statistics.mean(v) for who, v in times.items()}
            b = bound(0, flop)
            line = (f"[{card}] {part} {what} rows={rows} D={d} K={k} bf16 ({-(-k // kc)} chunks), "
                    f"raw back to back (3 a turn), parent {times['parent']} ms, change "
                    f"{times['change']} ms (order parent, change, change, parent): change / "
                    f"parent {ms['change'] / ms['parent']:.4f}; {flop / ms['parent'] / 1e9:.1f} / "
                    f"{flop / ms['change'] / 1e9:.1f} TFLOP/s parent / change, bound "
                    f"{b['bound_ms']:.3f} ms by {b['bound_by']} (the change at "
                    f"{b['bound_ms'] / ms['change']:.3f} of it)")
            key = {"B3 weights": "weights", "B4": "x"}.get(part)
            if key:
                yard_ms = back_to_back_ms(yard[key], torch, launches=3, warmup=1)
                line += (f"; torch.matmul pair on [{rows}, {d * k}] bf16 operands (yardstick) "
                         f"{yard_ms:.3f} ms")
            if part == "B3":
                line += "; max|change-parent|/max|parent| " + ", ".join(
                    f"d{n} {v:.2e}" for n, v in diffs.items())
            print(line, flush=True)
        del outs, calls, grads, t, a, yard
        torch.cuda.empty_cache()


def gmm_backward_ab(others: list) -> int:
    """`python3 chip_smoke.py --gmm-backward-ab <checkout> ...`: B3's terms
    entry and B4's entry of this checkout and of each other checkout (built
    from its csrc by its own ops/cuda/build.py, with its own
    ops/cuda/gmm.dx_splits where it has one), called raw per chunk as the
    wrappers call them, back to back (3 sequences a turn), in turns this,
    the others, the others reversed, this, at `GMM_BWD_PATH_SHAPES`. Outputs
    are not compared, so a diagnostic build (a part of the kernel switched
    off) can be timed too."""
    import torch

    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py --gmm-backward-ab: torch.cuda.is_available() is False")
    card = card_line()
    print(card, flush=True)
    libs, rules = {"change": load_checkout(None, "change")}, {"change": cgmm.dx_splits}
    for root in others:
        libs[root] = load_checkout(root, root)
        mod = checkout_module(root, os.path.join("vit_ad_tpu_torch", "ops", "cuda", "gmm.py"),
                              f"{root}_gmm")
        rules[root] = getattr(mod, "dx_splits", cgmm.dx_splits)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for what, rows, d, k in GMM_BWD_PATH_SHAPES:
        t = gmm_backward_inputs(rows, d, k, gen)
        kc = cgmm.backward_chunk(rows, d, k, bf16)
        o = gmm_backward_outputs(rows, d, k, kc)
        seqs = {"terms": {}, "x": {}}
        for who, (lib, entries) in libs.items():
            calls = gmm_backward_calls(lib, entries, t, o, rows, d, k, kc, sms, stream,
                                       not what.startswith("DeiT"), rules[who])
            seqs["terms"][who] = lambda fns=calls[0]: [fn() for fn in fns]
            seqs["x"][who] = lambda fns=calls[2]: [fn() for fn in fns]
        for part, seq in seqs.items():
            times = {who: [] for who in seq}
            for who in list(seq) + list(seq)[::-1]:
                times[who].append(back_to_back_ms(seq[who], torch, launches=3, warmup=1))
            print(f"[{card}] {part} {what} rows={rows} D={d} K={k} bf16, raw back to back (3 a "
                  f"turn): " + ", ".join(f"{who} {v} ms" for who, v in times.items()), flush=True)
        del t, o, seqs
        torch.cuda.empty_cache()
    return 0


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
    from vit_ad_tpu_torch.ops.cuda import layer_norm as ln
    from vit_ad_tpu_torch.ops.cuda import mlp as cmlp
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
        before, before_one_pass = wa.launches, wa.one_pass_launches
        route = wa.attention_route(n, dtype)
        out = wa.vit_attention_qkv(qkv, h)
        ref = wa.vit_attention_qkv_reference(qkv, h)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = (math.isfinite(err) and err <= TOL[dt] and wa.launches == before + 1
              and wa.one_pass_launches - before_one_pass == int(route == "one_pass")
              and route == ("fma" if dt == "float32" else "one_pass" if n <= 208 else "two_pass"))
        print(f"vit_attention_qkv B={b} N={n} C={c} H={h} {dt}: max|kernel-plain| "
              f"{err:.3e} (tol {TOL[dt]:.0e}), launches +{wa.launches - before}, route {route}")
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
    for case in GMM_FWD_CASES + GMM_FWD_EDGES:
        check_gmm_forward(*case, gen, dev)
    for case in GMM_BWD_CASES + GMM_BWD_EDGES:
        check_gmm_backward(*case, gen, dev)
    check_swin_kernels(gen, dev)
    check_mlp_kernel(gen, dev)
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
        reset_launches()
        t0 = time.perf_counter()
        rc = score_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nf_launches = read_launches()
        n_batches = -(-N_IMAGES // SMOKE_BATCH)
        expect = {**NO_LAUNCHES, "B1": 12 * n_batches, "B6": 12 * n_batches,
                  "B7": DEIT_B7_PER_BATCH * n_batches}
        print(f"cli.score.main rc={rc} in {wall:.2f} s (model load included); launches "
              f"{nf_launches}, expected {expect} (12 attention, 12 MLP and "
              f"{DEIT_B7_PER_BATCH} LayerNorm launches x {n_batches} batches); one-pass "
              f"attention {wa.one_pass_launches}, wgmma MLP route {cmlp.wgmma_launches}, rows "
              f"LayerNorm {ln.rows_launches}")
        if rc != 0 or nf_launches != expect or wa.one_pass_launches != expect["B1"] \
                or cmlp.wgmma_launches != expect["B6"] or ln.rows_launches != expect["B7"]:
            raise AssertionError("main path did not launch the attention, MLP and LayerNorm "
                                 "kernels as many times per batch as the encoder has blocks "
                                 "(and norms), each through its redesigned route")
        files = score_cli.list_images(img_dir)
        scores = check_scores_csv(out_dir, files, "NF")

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

        phase("5 main path: DeiT-base + NF-20 scoring with the stock MLP tail (--no-fused-mlp)")
        fused = fused_mlp_main_path(tmp, nf_pth, deit_pth, img_dir, files, scores,
                                    f32_scores["cuda"])

        phase("6 main path: DeiT-base + MDN K=150, train then score through the CLIs")
        mdn = mdn_main_path(tmp)

        phase("7 main path: EsViT Swin-T + NF-20, train then score through the CLIs")
        esvit = esvit_main_path(tmp)

        phase("8 main path: ResNet-50 + two stage MDN heads K=100, train then score through "
              "the CLIs")
        resnet = resnet_main_path(tmp)

        phase("9 times (CUDA events, median of %d after warm-up)" % TIMED_RUNS)
        qkv = torch.randn(FLAGSHIP_BATCH, 198, 3 * 768, device=dev,
                          generator=gen).to(torch.bfloat16)
        err = (wa.vit_attention_qkv(qkv, 12).float()
               - wa.vit_attention_qkv_reference(qkv, 12).float()).abs().max().item()
        if not err <= TOL["bfloat16"]:
            raise AssertionError(f"kernel disagrees at batch {FLAGSHIP_BATCH}: {err}")
        kern = lambda: wa.vit_attention_qkv(qkv, 12)
        plain = lambda: wa.vit_attention_qkv_reference(qkv, 12)
        # the library control: one SDPA call on [B, H, N, hd] views of the packed qkv
        q, k, v = qkv.reshape(FLAGSHIP_BATCH, 198, 3, 12, 64).permute(2, 0, 3, 1, 4)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)
        kern_ms, plain_ms = alternate(kern, plain, TIMED_RUNS, 3)
        att_lib_ms = median_ms(sdpa, torch)
        att_b2b_ms = [back_to_back_ms(f, torch) for f in (kern, sdpa)]
        att_ms, att_plain_ms = statistics.mean(kern_ms), statistics.mean(plain_ms)
        att_bound = bound(tensor_bytes(qkv) + tensor_bytes(qkv) // 3,
                          4 * FLAGSHIP_BATCH * 12 * 198 * 198 * 64)
        print(f"[{card}] vit_attention_qkv B={FLAGSHIP_BATCH} N=198 C=768 H=12 bf16: "
              f"kernel {kern_ms} ms, plain {plain_ms} ms (order plain, kernel, kernel, "
              f"plain), SDPA {att_lib_ms:.4f} ms, bound {att_bound['bound_ms']:.4f} ms by "
              f"{att_bound['bound_by']}; back to back (200 launches) kernel "
              f"{att_b2b_ms[0]:.4f} ms, SDPA {att_b2b_ms[1]:.4f} ms; max|kernel-plain| {err:.3e}")
        del q, k, v

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
        deit_fns = fused_mlp_ab(nf_pth, deit_pth, images, card)
        vit_norm_ab(nf_pth, deit_pth, images, card)
        mlp = mlp_times(card, gen)
        gmm_times = mdn_times(mdn, images, card, gen)
        wide = resnet_times(resnet, images, card, gen)
        swin = swin_times(card, gen)
        esvit_times(esvit, images, card, gen)
        # last: the profiler's hooks slow the host down for whatever is timed after it
        print_device_profile(f"DeiT NF uint8→scores B={FLAGSHIP_BATCH} bf16, fused MLP on "
                             f"(the default)", deit_fns[True], card, top=20)
        del deit_fns
        torch.cuda.empty_cache()
        step = resnet_joint_step(RESNET_K, images)[0]
        print_device_profile(f"ResNet-50 + MDN joint train step B={RESNET_BATCH} "
                             f"K={RESNET_K} bf16", step, card, top=24)
        del step
    torch.cuda.synchronize()

    phase("10 result")
    kernels = [{
        "name": "vit_attention_qkv",
        "route": "cuda",
        "source": "vit_ad_tpu_torch/csrc/vit_attention_qkv.cu",
        "replaces": "vit_ad_tpu/ops/pallas/window_attention.py:375",
        "launches": nf_launches["B1"] + fused["launches"]["B1"] + mdn["launches"]["B1"],
        "max_abs_err": err,
        "ms": att_ms,
        "plain_ms": att_plain_ms,
        **att_bound,
        "library_ms": att_lib_ms,
        "design": "one score pass with the 16 x N scores in registers, ldmatrix fragments, "
                  "cp.async staging, keys padded to 16 (two-pass kernel above 208 tokens)",
    }]
    # launches are kernel launches: B3 counts its terms and weights kernels
    # once per chunk of components. B4 runs only when the features need a
    # gradient: never on the frozen-trunk DeiT path, on every step of the
    # ResNet path, whose stage norms train. The numbers are those of the DeiT
    # head's shape (B2 at B=128, B3 at B=64) and, for B4, of its main path's
    # heaviest shape (the stage-2 head of a 16-image step); `per_shape` has
    # the other shapes
    for key, kernel, replaces in (
            ("B2", "gmm_forward", "vit_ad_tpu/ops/pallas/gmm.py:39"),
            ("B3", "gmm_backward_params", "vit_ad_tpu/ops/pallas/gmm_train.py:88"),
            ("B4", "gmm_backward_x", "vit_ad_tpu/ops/pallas/gmm_train.py:175")):
        shapes = [gmm_times[key]] + wide[key]
        main = wide[key][0] if key == "B4" else gmm_times[key]
        kernels.append({"name": kernel, "route": "cuda", "source": "vit_ad_tpu_torch/csrc/gmm.cu",
                        "replaces": replaces,
                        "launches": mdn["launches"][key] + resnet["launches"][key],
                        **main, "per_shape": shapes})
    kernels[1]["kernel_route"] = "wgmma_x_resident (D <= 1024), wgmma_x_streamed (above)"
    kernels[1]["design"] = ("64 rows x 128 features a block, two consumer warpgroups of 64 "
                            "features on wgmma m64n128k16 (mu and pre as one B operand), a TMA "
                            "ring per warpgroup, x rows resident in shared memory up to "
                            "D = 1024, density and one-exp online logsumexp in registers")
    kernels[2]["kernel_route"] = "terms: B2's routes; weights: wgmma"
    kernels[2]["design"] = ("terms on B2's block, rings and products with the gradient terms "
                            "as epilogue (bf16 scratch, fixed-order partials); weight "
                            "gradients as a persistent wgmma GEMM over (component, 128 e, "
                            "128 i) tiles with MN-major operands, contracting over all rows")
    kernels[3]["kernel_route"] = "wgmma"
    kernels[3]["design"] = ("wgmma GEMM over (128 rows, 128 i) tiles, dmu and dpre K-major "
                            "against the weights MN-major through 3-D tensor maps, one "
                            "accumulator; a chunk split into partials summed in order where "
                            "the tiles fill the card poorly")
    # B5a, the split-input entry, is on no CLI path (the JAX package reaches it
    # only by an experiment toggle): its check and time are phases 3, 7
    for key, kernel, source, replaces in (
            ("B5", "swin_window_attention", "swin_window_attention.cu",
             "vit_ad_tpu/ops/pallas/window_attention.py:212"),
            ("B5a", "swin_window_attention_split", "swin_window_attention.cu",
             "vit_ad_tpu/ops/pallas/window_attention.py:46"),
            ("B7", "layer_norm", "layer_norm.cu", "vit_ad_tpu/ops/pallas/layer_norm.py:53")):
        kernels.append({"name": kernel, "route": "cuda",
                        "source": f"vit_ad_tpu_torch/csrc/{source}", "replaces": replaces,
                        "launches": esvit["launches"][key], **swin[key]})
    # B7 also runs the DeiT blocks' first norm and the final norm
    kernels[-1]["launches"] += (nf_launches["B7"] + fused["launches"]["B7"]
                                + mdn["launches"]["B7"])
    kernels[-1]["design"] = ("rows kernel: D = 8 LPR NV, 32 / LPR rows a warp, scale and bias "
                             "in registers, the warps striding over the rows from D = 384 with "
                             "the next group's loads in flight")
    kernels.append({"name": "mlp_block", "route": "cuda",
                    "source": "vit_ad_tpu_torch/csrc/mlp_block.cu",
                    "replaces": "vit_ad_tpu/ops/pallas/mlp.py:44",
                    "launches": nf_launches["B6"] + fused["launches"]["B6"]
                    + mdn["launches"]["B6"], **mlp})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--against":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(against(sys.argv[2]))
    if len(sys.argv) >= 3 and sys.argv[1] == "--gmm-backward-ab":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(gmm_backward_ab(sys.argv[2:]))
    sys.exit(main())
