#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vit_ad_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --against <another checkout>   # kernels A/B, `against`
    python3 chip_smoke.py --gmm-backward-ab <checkout> ...   # B3 terms, B4 A/B
    python3 chip_smoke.py --serve-bundle <bundle> <images.npy> <out.json> [device]
    python3 chip_smoke.py --mesh-rank <spec.json>   # one rank of phase 15 (VITAD_* set)
    CHIP_SMOKE_KMEANS_IMAGES=400 python3 chip_smoke.py   # phase 13's k-means at MVTec size

Drives the port's main paths at full width, bf16 compute, through the port's
CLIs, after building and checking the hand-written kernels: on a DeiT-base/16
trunk the flagship serving path (score a folder with an NF-20 head; the
blocks' MLP tail goes through the MLP kernel by default), the same with the
stock tail, and the MDN path (train a
K=150 GMM head on cached features, save it, score a folder with it); on the
EsViT Swin-T trunk the NF path (train an NF-20 head on cached Swin features,
save it, score a folder with it); on the ResNet-50 trunk the multi-stage MDN
path (train two K=100 GMM heads jointly with the stage LayerNorms, save them,
score a folder with them); on the DeiT-base trunk the reconstruction path
(train the ResNetDecoder of ae_deit on cached trunk latents, save the AE,
score a folder with it) and the vanilla CNN auto-encoder end to end; on the
NesT-T, EfficientFormer-L3 and EfficientNet-B4 trunks an NF, an MDN and an
NF path (train, save, score); on the ResNet-50 trunk the NF heads on stage
maps 0-2 through the run directory (train, `cli.score -r`, `--watch`,
`--heatmaps`, `--weights-dtype bf16`, `cli.validate`); and the DeiT NF, DeiT
MDN, EsViT NF and ResNet MDN runs as serving bundles (`torch.export`
programs carrying the kernels as registered ops), each served from a fresh
process (`--serve-bundle`); the sweep engine over DeiT-base MDN runs
(sequential, resumed, and through a spawned worker), k-means init, the VAE,
and the weight CLIs (export and convert); the mesh; the model levers of the
JAX package, each off and on; and the quality-parity harness. Phases:

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
  9. recon    a synthetic category: `cli.train_recon.main -m ae_deit` (the
              ResNetDecoder on the frozen DeiT-base, a few epochs), then
              `cli.score.main -a recon` on the AE file it wrote; B1, B6 and B7
              launch counts per encoder batch (latent cache, scoring) and
              none in a decoder-only step; the loss falls, the trunk is
              bit-identical, the decoder moved; CUDA-vs-CPU f32 scores, bf16
              scores within the policy's drift; `cli.train_recon -m ae_cnn`
              end to end (BatchNorm in training mode), its loss falling
 10. trunks   one synthetic category: `cli.train_nf -m nest`, then
              `cli.score -a nf -m enc_nest` (B1 12 times per encoder batch,
              all through the one-pass kernel at hd = 32; under the default
              fused LayerNorm B7 27 times, all through the rows kernel); `cli.train_mdn -m eff_former` (K=150),
              then `cli.score -a mdn` (B2 per forward and B3 per train step at
              D = 512, all through their wgmma kernels); `cli.train_nf -m
              eff_net`, then `cli.score -a nf` (no kernel); CUDA-vs-CPU f32
              scores of each
 11. run dirs a synthetic category: `cli.train_nf -m res_net` (ResNet-50 and
              three NF-20 flows on stage maps 0-2 at batch 32, a few epochs;
              no kernel on this path): every run-directory file, the loss
              falls, the trunk bit-identical, only the read stage norms move;
              `cli.score -r` on it, f32 card vs CPU; `cli.score -r` on phase
              6's MDN run equal to `--pth` on its file (B1, B6, B7 and B2 per
              batch); a DeiT-base NF run: `--watch` twice (the second scores
              only the new files, as the one-shot scores, one set of B1, B6
              and B7 per new batch), `--heatmaps 4`, `--weights-dtype bf16`
              (cast count, drift); `cli.validate` over the runs against each
              trainer's recorded metrics
 12. bundles  the host's decode rates (PIL, and the native library where it
              builds); `cli.score -b 128` on the DeiT NF, DeiT MDN, EsViT NF
              and ResNet MDN runs' folders; each run exported as a native
              bundle at batch 128 (DeiT NF with the full and the scores
              payload, DeiT MDN with the scores payload and the training
              images' baked normalizer, ResNet MDN with the tuple payload)
              and served from a fresh process that imports torch, numpy, the
              serving module and the op module only: launches per batch equal
              the live path's, none while tracing, scores equal `cli.score`'s
              (the MDN scores payload: the host tail of the live payload with
              the same normalizer); the portable DeiT NF bundle (traced from
              a copy of the models on the CPU) holds no kernel op, scores on
              the CPU at batch 2 as the port's CPU path, and is moved to the
              card and served there without a launch
 13. sweep    `cli.trainings_loop -a mdn -m enc_deit` over two synthetic
              categories (DeiT-base + MDN K=100, batch 64, two epochs): no
              row with an error, B1, B6, B7 per encoder batch and B2, B3 per
              step through their redesigned routes, results.csv in the JAX
              columns; the same command again launches nothing and keeps its
              rows; the same sweep through one spawned worker pinned to card
              0, its rows against the sequential ones; `train_mdn` with
              k-means init at K=100 (the mu bias at the optimizer's start is
              the centres, the loss falls, the host seconds of k-means; on
              a category of N images of its own with
              CHIP_SMOKE_KMEANS_IMAGES=N); the
              VAE through `run_sweep` (no launch, the loss falls, f32 scores
              card vs CPU); `cli.export_weights` on phase 6's MDN run (`--pth`
              on the file scores as `-r` on the run) and on phase 11's
              NF-ResNet run (three flows and the encoder, strict loads);
              `cli.convert_weights --arch deit` on a timm-layout file
              (`-E <dir>` scores as `-E <file>`) and a `student`-wrapped
              EsViT file through `-E` (scores as its bare state dict)
 14. times    kernels vs plain vs the one PyTorch call that computes the same
              function, where there is one, each beside its bound, by events
              and, for the attention kernels and B7, back to back (B5a alone
              with its bias gathered, beside its public entry; B3 and B4 also
              checked at 64 x 196 rows and at the ResNet heads' shapes; B6
              also step by step: LayerNorm, each product alone); DeiT NF
              (fused MLP off and on, with the peak memory of each; the ViT
              norms on B7 and on the f32 cast), MDN, EsViT NF (fused LayerNorm
              off and on) and ResNet MDN uint8→scores img/s at batch 128; the
              MDN, NF and joint ResNet MDN (K=100, 150) train steps; ae_deit
              recon uint8→scores img/s at batch 128, the ae_deit decoder-only
              and ae_cnn end-to-end train steps at batch 64 (ms, peak memory);
              where the device time of a DeiT NF batch, an EsViT batch, a
              ResNet joint step (K=100), an ae_deit recon batch and the
              ae_deit decoder step goes (torch.profiler); NesT-T + NF-20
              uint8→scores img/s at batch 128 with the fused LayerNorm off and
              on and its peak memory, B1 at NesT's three level shapes beside
              SDPA, B7 at its two ConvPool norm shapes, B2 and B3 at
              EfficientFormer's MDN shapes, EfficientFormer-L3 and
              EfficientNet-B4 ms per batch alone, and the profiles of the
              three; NF-ResNet uint8→scores img/s at batch 128, its train step
              at batch 32 (ms, peak memory) and its profile; the wall time of
              a 32-image `--watch` wave after the first; each bundle's
              uint8→payload img/s beside the live path's on the same batch,
              its export, load and first-call seconds
 15. mesh     B2, B3 and B4 against their plain versions at the shard shapes
              below (75 of 150 components at D=768; 50 of 100 at D=1024 and
              2048, with dx); then two ranks of an explicit cluster (the
              VITAD_* variables, a free local port) on card 0, so their device
              collectives go over gloo: (a) `cli.train_mdn --mesh 1x2`
              (DeiT-base + MDN K=150, batch 64, two epochs, phase 13's first
              category; B2 and B3 on 75
              components a rank through their wgmma kernels) against the same
              command in one process (first-step loss, histories, metrics, the
              mesh run's .pth strict-loaded and scored by `cli.score --pth` as
              the single run's), and its first step through the API (every
              head gradient gathered to the full layout); (b) the ResNet-50 MDN
              joint step at K=100 on 1x2 (B4 on each shard, the partial dx
              summed before the stage norms) against the same steps in one
              process (the first step's head and stage-norm gradients, the
              losses, the parameters after the steps), with each rank's peak
              memory; (c) ae_cnn steps on 2x1 (global BatchNorm, f32) against
              one process; (d) `cli.score --mesh 2` (DeiT-base NF, 100 images
              at batch 128, 64 rows a rank: both ranks score images, the trunk
              replicated) against `cli.score`; (e), (f), (g) a B=128 batch of
              DeiT-base, EsViT Swin-T and NesT-T through the trunk sharded over
              the two model ranks (B1 and B5 on the rank's heads, the GEMM
              steps of the MLP kernel with the GELU and f32-partial epilogues,
              gloo sums) against the whole trunk in one process, with the
              launches a rank; (h) a bare `--mesh 2x1` refuses on a one-card
              host with the card count. Before the ranks, B1 at 6 and 3 heads,
              B5 at the half-head EsViT stages and the GEMM steps at the
              DeiT-base shard shapes are held against their plain versions and
              timed. (a) runs the sharded trunk too. Step ms of (a), (b) and
              (e)-(g) on the shared card are information only
 16. levers   the JAX package's opt-in model levers, each off and on (read
              at call time) on the models above, B=128 bf16: launches of one
              batch, the scores' drift and uint8→scores ms (order off, on, on,
              off) with the part the lever changes timed alone; EsViT NF
              (`VITAD_SWIN_PARTITION=gather`: scores equal to the bit;
              `VITAD_SWIN_PACKED=0`: B5a 12, B5 0; `VITAD_SWIN_LN_FOLD=1`: B7
              5), the EsViT NF without the fused LayerNorm (`VITAD_BF16_LN=1`),
              DeiT NF (`VITAD_VIT_LN_FOLD=1`: B7 1; `VITAD_FOLD_FLOW_PERMS=1`),
              EfficientNet-B4 NF (`VITAD_EFFNET_HARDSWISH=1`); B5a on the split
              route at the four Swin-T stages against its plain version, by
              events beside SDPA; the NF-ResNet step at B=32 with
              `VITAD_NF_REVERSIBLE=1`: first-step gradients against autodiff,
              step ms and peak memory each way
 17. parity   the quality-parity harness (`cli.parity_matrix`): (a) its
              `--rehearse` run on the card (the six §6 entries on enc_cnn and
              ae_cnn at 32 px, K=2), exit 0 with six entries compared, each
              entry's seconds and launches (B2 and B3 per MDN step through
              their wgmma kernels on the two gmm entries); (b) the same six
              entries under the f32 policy on the card and on the CPU, the
              card's results.csv through the tool's 0.5-pt gate against the
              CPU's rows; (c) nf_mvtec_lastblock and gmm_mvtec_100_gaussians
              with their own models (DeiT-base, 224 px, bf16, NF-20 and
              K=100, batch 64, two epochs) through the real-data path on one
              synthetic MVTec category of phase 13's size: B1, B6, B7 per
              encoder batch and B2, B3 per MDN step through their redesigned
              routes, no row with an error, the gate against a stand-in, each
              entry's seconds beside phase 13's per category
 18. result   a kernels JSON line, the nvidia-smi line, and last the
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
    # the EfficientFormer-L3 head on a 16-image step (49 tokens of 512)
    (784, 512, 150, "bfloat16"), (784, 512, 150, "float32"),
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
                 (3136, 1024, 100, "bfloat16", True), (784, 2048, 100, "bfloat16", True),
                 # the EfficientFormer-L3 head's train step: 16 images, D=512, no dx
                 (784, 512, 150, "bfloat16", False)]
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
# "GEMM": `ops/cuda/mlp.gemm_step`, B6's products one at a time (the sharded
# trunks' MLPs and attention projections)
NO_LAUNCHES = {"B1": 0, "B2": 0, "B3": 0, "B4": 0, "B5": 0, "B5a": 0, "B6": 0, "B7": 0,
               "GEMM": 0}
# the ResNet-50 multi-stage MDN main path: heads on stage maps 2 and 3 (D=1024
# on 14x14 tokens, D=2048 on 7x7), K=100 and K=150 (the reference's two
# settings; the CLI run uses 100), a few joint steps at batch 16
RESNET_K, RESNET_TRAIN, RESNET_TEST, RESNET_EPOCHS, RESNET_BATCH = 100, 32, 4, 3, 16
RESNET_SCORE_BATCH, RESNET_TIMED_KS, RESNET_CPU_K = 4, (100, 150), 4
RESNET_HEADS = ((1024, 196), (2048, 49))  # (D, tokens per image) of stages 2, 3
# the recon path: ae_deit (DeiT-base trunk + ResNetDecoder) trained by
# cli.train_recon at a smoke batch, a few epochs, and scored by cli.score; the
# end-to-end ae_cnn run; the timed decoder step and ae_cnn step at batch 64
RECON_TRAIN, RECON_TEST, RECON_EPOCHS, RECON_BATCH, RECON_SCORE_BATCH = 32, 4, 3, 16, 4
RECON_STEP_BATCH = 64
# the other trunks (phase 10): NesT-T + NF-20, EfficientFormer-L3 + MDN K=150
# and EfficientNet-B4 + NF-20 trained by the CLIs on one synthetic category at
# a smoke batch, a few epochs, and scored by cli.score
TRUNK_TRAIN, TRUNK_TEST, TRUNK_EPOCHS, TRUNK_BATCH, TRUNK_SCORE_BATCH = 32, 4, 3, 16, 4
# kernel launches of one NesT-T encoder batch: 12 block attentions; with the
# fused LayerNorm the 24 block norms, the two ConvPool norms and the final norm
NEST_B1_PER_BATCH, NEST_B7_PER_BATCH = 12, 24 + 2 + 1
# NesT-T's attention calls at B=128, 224 px: (level, blocks, C, heads); every
# block holds 14 x 14 = 196 tokens, hd = 32
NEST_LEVELS = [("level 0", 2048, 96, 3), ("level 1", 512, 192, 6), ("level 2", 128, 384, 12)]
# B7's shapes on NesT-T at B=128 that no other path gives it: the two ConvPool
# norms (its block norms are the Swin-T stage shapes of LN_STAGES)
NEST_LN_SHAPES = [(401408, 192), (100352, 384)]
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


def flow_step_inputs(b: int, c: int, h: int, w: int, kernel: int, gen, dev):
    """A seeded flow step on the card (global scales spread around their
    init, conv weights x3 so the soft clamp's atan works off its linear
    range) and its tail's operands as the op takes them: x1, x2, the second
    convolution's output without its bias, that bias, g, o, perm, coeff."""
    import torch
    import torch.nn.functional as F
    from vit_ad_tpu_torch.models.flow import AllInOneBlock

    perm = torch.randperm(c, generator=torch.Generator().manual_seed(c)).numpy()
    blk = AllInOneBlock(c, max(1, int((c - c // 2) * 0.16)), kernel, perm).to(dev)
    with torch.no_grad():
        blk.global_scale.add_(2.0 * torch.randn(blk.global_scale.shape, device=dev,
                                                generator=gen))
        blk.global_offset.copy_(0.3 * torch.randn(blk.global_offset.shape, device=dev,
                                                  generator=gen))
        for conv in (blk.subnet[0], blk.subnet[2]):
            conv.weight.mul_(3.0)
        x = torch.randn(b, c, h, w, device=dev, generator=gen)
        x1, x2 = x[:, : blk.split1].contiguous(), x[:, blk.split1:].contiguous()
        p = blk.step_params()
        pad = kernel // 2
        a = F.conv2d(F.relu(F.conv2d(x1, p[0], p[1], padding=pad)), p[2], None, padding=pad)
    return blk, (x1, x2, a, *p[3:], blk.perm, blk.clamp * 0.636)


def flow_coupling_times(card: str, gen, batch: int = FLAGSHIP_BATCH) -> dict:
    """Phase 14, F1 at DeiT-base's map [batch, 768, 14, 14] (both kernels'
    steps alike: the tail does not see the kernel), checked against the plain
    tail on the same inputs (its card tests: tests/test_torch_flow_coupling.py
    -m card) and timed against it by events (order plain, kernel, kernel,
    plain) and back to back, beside its bound; then the NF-20 flow's forward
    on that map (`transform`) through F1 and through the plain tail."""
    import torch
    import torch.nn.functional as F
    from vit_ad_tpu_torch.models.flow import NormalizingFlow
    from vit_ad_tpu_torch.ops.cuda import flow as cflow

    dev = torch.device("cuda")
    _, args = flow_step_inputs(batch, 768, 14, 14, 3, gen, dev)
    kern = lambda: cflow.flow_coupling_op(*args)
    plain = lambda: cflow.flow_coupling_reference(*args)
    with torch.no_grad():
        kern_ms, plain_ms = alternate(kern, plain, TIMED_RUNS, 3)
        b2b = {name: back_to_back_ms(fn, torch, launches=100)
               for name, fn in (("kernel", kern), ("plain", plain))}
        got, want = kern(), plain()
    for g, w in zip(got[:2], want[:2]):
        if not bool(((g - w).abs() <= 8 * 2.0 ** -23 * w.abs().max()).all()):
            raise AssertionError("F1 disagrees with the plain tail at DeiT-base's map")
    nbytes = tensor_bytes(*args[:3], *got[:2])  # x1, x2, a in; y out
    nums = {"ms": statistics.mean(kern_ms), "plain_ms": statistics.mean(plain_ms),
            "back_to_back_ms": b2b["kernel"], "plain_back_to_back_ms": b2b["plain"],
            **bound(nbytes, 20.0 * batch * 196 * 384 + 2.0 * batch * 196 * 384, 67e12)}
    print(f"[{card}] flow_coupling (F1) [{batch},768,14,14]: kernel {kern_ms} ms, plain tail "
          f"{plain_ms} ms (order plain, kernel, kernel, plain); back to back (100 calls) "
          f"kernel {b2b['kernel']:.4f} ms, plain {b2b['plain']:.4f} ms; bound "
          f"{nums['bound_ms']:.4f} ms by {nums['bound_by']} ({nbytes / 1e6:.1f} MB; kernel back "
          f"to back at {nums['bound_ms'] / b2b['kernel']:.3f} of it)")
    flow = NormalizingFlow(768, 224, 196, hidden_ratio=0.16, flow_steps=20).to(dev)
    x = torch.randn(batch, 14, 14, 768, device=dev, generator=gen)

    def plain_flow():
        split = flow.steps[0].split1
        z1 = x[..., :split].permute(0, 3, 1, 2).contiguous()
        z2 = x[..., split:].permute(0, 3, 1, 2).contiguous()
        for blk in flow.steps:
            p = blk.step_params()
            z1, pad = z1.contiguous(), p[0].shape[-1] // 2
            a = F.conv2d(F.relu(F.conv2d(z1, p[0], p[1], padding=pad)), p[2], p[3], padding=pad)
            z1, z2, _ = cflow.flow_coupling_reference(z1, z2, a, None, p[4], p[5], blk.perm,
                                                      blk.clamp * 0.636)
        return z1, z2

    with torch.no_grad():
        flow_ms, plain_flow_ms = alternate(lambda: flow.transform(x), plain_flow, 10, 2)
    nums.update(flow_ms=statistics.mean(flow_ms), plain_flow_ms=statistics.mean(plain_flow_ms))
    print(f"[{card}] NF-20 transform [{batch},14,14,768] f32: through F1 {flow_ms} ms, through "
          f"the plain tail {plain_flow_ms} ms (order plain, F1, F1, plain)")
    return nums


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
    return {"launches": {k: train[k] + score[k] for k in train}, "pth": pth,
            "test_dir": test_dir}


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
    """Phase 11, Swin part: B5 at the four Swin-T stage shapes of a B=128
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


def layer_norm_times(card: str, gen, shapes=None) -> dict:
    """Phase 11, B7 at `shapes` (default `LN_PATH_SHAPES`: the four Swin-T
    block norms of a B=128 batch and B6's LayerNorm step), bf16: kernel vs
    plain by events (order plain, kernel, kernel, plain), and kernel,
    `F.layer_norm` on the same bf16 rows and the unfused path (`F.layer_norm`
    on the f32 cast and back: the DeiT blocks' norm before this port's kernel
    took it) by events and back to back, beside the bound. Returns the JSON
    numbers of the first shape ([401408,96] by default, the heaviest call),
    every shape in `per_stage`."""
    import torch
    import torch.nn.functional as F
    from vit_ad_tpu_torch.ops.cuda import layer_norm as ln

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    per_shape = []
    for rows, d in shapes or LN_PATH_SHAPES:
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
    """Phase 11, EsViT part: uint8→scores img/s of Swin-T + NF-20 at B=128
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

    cmlp.gemm_launches = 0
    cmlp.gemm_route_launches.update(dict.fromkeys(cmlp.gemm_route_launches, 0))
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
            "B6": cmlp.launches, "B7": ln.launches, "GEMM": cmlp.gemm_launches}


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
    return {"launches": launches, "pth": pth, "test_dir": test_dir,
            "train_dir": os.path.join(cat, "train", "good")}


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
    """Phase 11, MDN part: B2 at batch 128, the train step (B2 + B3) at 32
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
            "encoder": enc_pth, "test_dir": test_dir}


def check_deit_routes(got: dict, expect: dict, what: str) -> None:
    """`got` (read_launches) is `expect`, and every B1, B6 and B7 launch took
    the redesigned route (one-pass attention, the wgmma MLP, the rows
    LayerNorm kernel)."""
    from vit_ad_tpu_torch.ops.cuda import layer_norm as ln
    from vit_ad_tpu_torch.ops.cuda import mlp as cmlp
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    print(f"{what}: launches {got}, expected {expect}; one-pass attention "
          f"{wa.one_pass_launches}, wgmma MLP {cmlp.wgmma_launches}, rows LayerNorm "
          f"{ln.rows_launches}")
    if got != expect or wa.one_pass_launches != expect["B1"] or \
            cmlp.wgmma_launches != expect["B6"] or ln.rows_launches != expect["B7"]:
        raise AssertionError(f"{what} did not launch B1, B6 and B7 as expected, each through "
                             "its redesigned route (and nothing else)")


def recon_main_path(tmp: str) -> dict:
    """Phase 9: train the ResNetDecoder of `ae_deit` (full-width DeiT-base/16
    trunk, seeded random weights) on a synthetic 224-px category with
    `cli.train_recon`, score its test folder with `cli.score -a recon`, and
    check: the B1, B6 and B7 launches of the latent cache (12, 12 and 13 per
    encoder batch, each through its redesigned route) and of scoring, none in
    a decoder-only step, the train loss falls, the trunk is bit-identical to
    its init and the decoder moved, f32 scores card vs CPU, bf16 card scores
    against them; then `cli.train_recon -m ae_cnn` end to end (BatchNorm in
    training mode on the card, no kernel), its loss falling."""
    import glob

    import numpy as np
    import torch
    from vit_ad_tpu_torch.cli import score as score_cli
    from vit_ad_tpu_torch.cli import train_recon as train_cli
    from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.data.synthetic import make_mvtec_category
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models, score_models
    from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
    from vit_ad_tpu_torch.pipeline.train import (
        cache_latents,
        default_encoder,
        recon_train_step,
        stage_image_batches,
    )

    dev = torch.device("cuda")
    cat = make_mvtec_category(os.path.join(tmp, "recon"), "gear", img_size=224,
                              n_train=RECON_TRAIN, n_test_good=RECON_TEST,
                              n_test_defect=RECON_TEST)
    test_dir = os.path.join(cat, "test")
    run = os.path.join(tmp, "recon_run")
    split = DataPipeline(RECON_BATCH, 224, base_path=cat, data_path="train/good")
    n_batches = lambda n, b: -(-n // b)
    # the latent cache of the train and valid batches, the test batches, and
    # the reconstructions of the test images the figures keep (up to 9)
    n_enc = (n_batches(len(split.train_files), RECON_BATCH)
             + n_batches(len(split.valid_files), RECON_BATCH)
             + n_batches(2 * RECON_TEST, RECON_BATCH) + 1)
    per_batch = {**NO_LAUNCHES, "B1": 12, "B6": 12, "B7": DEIT_B7_PER_BATCH}
    reset_launches()
    t0 = time.perf_counter()
    rc = train_cli.main(["-m", "ae_deit", "-d", cat, "-t", "train/good", "-v", "test",
                         "-e", str(RECON_EPOCHS), "-p", str(RECON_EPOCHS),
                         "-b", str(RECON_BATCH), "-i", "224", "--device", "cuda", "--out", run])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train = read_launches()
    print(f"cli.train_recon.main -m ae_deit rc={rc} in {wall:.2f} s ({n_enc} encoder batches: "
          f"the latent cache of the train and valid batches and the test batch, of "
          f"{RECON_BATCH}, and the figures' reconstructions)")
    # the trunk runs once per batch (latent cache, evaluation, the recon grid
    # of the figures); the decoder steps and validation passes launch no kernel
    check_deit_routes(train, {k: v * n_enc for k, v in per_batch.items()}, "ae_deit training")
    with open(os.path.join(run, "history.json")) as f:
        hist = json.load(f)
    if rc != 0 or hist["epochs_ran"] != RECON_EPOCHS or \
            not all(math.isfinite(v) for v in hist["train_loss"] + hist["valid_loss"]) or \
            not all(math.isfinite(v) for v in hist["metrics"].values()):
        raise AssertionError(f"ae_deit training failed or gave non-finite losses: {hist}")
    if not hist["train_loss"][-1] < hist["train_loss"][0]:
        raise AssertionError(f"the ae_deit train loss did not fall: {hist['train_loss']}")
    print(f"train loss {hist['train_loss']}, valid loss {hist['valid_loss']}, "
          f"metrics {hist['metrics']} (random trunk: information only)")
    (pth,) = glob.glob(os.path.join(run, "ae_deit_*.pth"))
    init = default_encoder(HyperParams(model_name="ae_deit", img_size=224)).state_dict()
    after = torch.load(pth, map_location="cpu", weights_only=True)
    changed = [k for k, v in init.items() if not torch.equal(v, after[k])]
    trunk_changed = [k for k in changed if k.startswith("encoder.")]
    decoder_weights = [k for k in init if k.startswith("decoder.") and k.endswith(".weight")]
    moved = [k for k in decoder_weights if k in changed]
    print(f"AE file: {len(after)} tensors; trunk tensors changed {len(trunk_changed)}; decoder "
          f"weights moved {len(moved)} of {len(decoder_weights)}")
    if sorted(after) != sorted(init) or trunk_changed or len(moved) != len(decoder_weights):
        raise AssertionError("training changed the frozen trunk or left decoder weights where "
                             f"they were: trunk {trunk_changed[:4]}, decoder moved {len(moved)}")
    del init, after

    # one encoder batch of the latent cache, then one decoder-only step
    mean_t, std_t = (torch.as_tensor(a, device=dev) for a in default_norm_stats())
    ae = build_pth_models(pth, "ae_deit", "recon", device=dev).parts[0]
    batches = stage_image_batches(DataPipeline(RECON_BATCH, 224, base_path=cat,
                                               data_path="train/good").train_batches(), dev)[:1]
    reset_launches()
    latents = cache_latents(ae, batches, mean_t, std_t)
    torch.cuda.synchronize()
    check_deit_routes(read_launches(), per_batch, "one encoder batch of the latent cache")
    ae.train()
    opt = torch_adam(ae.decoder.parameters(), 1e-3, 1e-4)
    reset_launches()
    loss = recon_train_step(ae, opt, batches[0][0], batches[0][1], latents[0], mean_t, std_t)
    torch.cuda.synchronize()
    step = read_launches()
    print(f"one decoder-only train step (B={RECON_BATCH}, loss {loss.item():.6f}): launches "
          f"{step}, expected none")
    if step != NO_LAUNCHES or not torch.isfinite(loss):
        raise AssertionError("a decoder-only recon step launched a kernel or gave a non-finite "
                             "loss")
    del ae, opt, latents, batches

    out_dir = os.path.join(tmp, "recon_scores")
    reset_launches()
    t0 = time.perf_counter()
    rc = score_cli.main(["--pth", pth, "-a", "recon", "-m", "ae_deit", "-d", test_dir,
                         "-b", str(RECON_SCORE_BATCH), "-o", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    score = read_launches()
    nb = n_batches(2 * RECON_TEST, RECON_SCORE_BATCH)
    print(f"cli.score.main -a recon -m ae_deit rc={rc} in {wall:.2f} s ({nb} batches)")
    check_deit_routes(score, {k: v * nb for k, v in per_batch.items()}, "ae_deit recon scoring")
    if rc != 0:
        raise AssertionError("recon scoring failed")
    files = score_cli.list_images(test_dir)
    scores = check_scores_csv(out_dir, files, "recon")

    mean, std = default_norm_stats()
    two = files[:2]
    got = {}
    for device in ("cuda", "cpu"):
        m = build_pth_models(pth, "ae_deit", "recon", dtypes=DtypePolicy.f32(), device=device)
        got[device] = score_models(m, DataPipeline(2, 224, files=two), mean, std).image_scores
    rel = np.abs(got["cuda"] - got["cpu"]) / np.abs(got["cpu"])
    print(f"recon f32 image scores cuda {got['cuda'].tolist()} cpu {got['cpu'].tolist()}: max "
          f"rel diff {rel.max():.3e} (rtol {SCORE_RTOL_F32:.0e})")
    if not rel.max() <= SCORE_RTOL_F32:
        raise AssertionError("CUDA f32 recon scores disagree with the CPU path")
    bf16_rel = np.abs(scores[:2] - got["cpu"]) / np.abs(got["cpu"])
    print(f"recon bf16 card scores vs f32 CPU scores (same 2 images): max rel diff "
          f"{bf16_rel.max():.3e} (rtol {FUSED_MLP_SCORE_RTOL:.0e}, the bf16 policy's drift)")
    if not bf16_rel.max() <= FUSED_MLP_SCORE_RTOL:
        raise AssertionError("bf16 recon scores drift from the f32 ones beyond the policy's")

    cnn_run = os.path.join(tmp, "recon_cnn_run")
    reset_launches()
    t0 = time.perf_counter()
    rc = train_cli.main(["-m", "ae_cnn", "-d", cat, "-t", "train/good", "-v", "test",
                         "-e", str(RECON_EPOCHS), "-p", str(RECON_EPOCHS),
                         "-b", str(RECON_BATCH), "-i", "224", "--device", "cuda",
                         "--out", cnn_run])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cnn = read_launches()
    with open(os.path.join(cnn_run, "history.json")) as f:
        cnn_hist = json.load(f)
    print(f"cli.train_recon.main -m ae_cnn rc={rc} in {wall:.2f} s: launches {cnn} (the vanilla "
          f"AE runs no kernel of the repo); train loss {cnn_hist['train_loss']}, valid loss "
          f"{cnn_hist['valid_loss']}, metrics {cnn_hist['metrics']}")
    if rc != 0 or cnn != NO_LAUNCHES or \
            not all(math.isfinite(v) for v in cnn_hist["train_loss"] + cnn_hist["valid_loss"]) \
            or not cnn_hist["train_loss"][-1] < cnn_hist["train_loss"][0]:
        raise AssertionError(f"the ae_cnn run failed or its loss did not fall: {cnn_hist}")
    return {"launches": {k: train[k] + score[k] for k in train}, "pth": pth}


def recon_times(recon: dict, images, card: str):
    """Phase 11, recon part: ae_deit uint8→scores img/s at B=128 (bf16, the
    batch on the device), the ae_deit decoder-only train step on cached
    latents and the ae_cnn end-to-end train step at B=64 (ms, peak memory),
    by events. Returns the scoring batch and the decoder step, for the
    profiles at the phase's end."""
    import torch
    from vit_ad_tpu_torch.config import HyperParams
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.pipeline.eval import make_recon_batch_fn
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models
    from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
    from vit_ad_tpu_torch.pipeline.train import default_encoder, recon_train_step

    dev = torch.device("cuda")
    mean, std = (torch.as_tensor(a, device=dev) for a in default_norm_stats())
    m = build_pth_models(recon["pth"], "ae_deit", "recon", device=dev)
    ae = m.parts[0]
    fn = make_recon_batch_fn(ae, mean, std)

    def score_batch():
        with torch.inference_mode():
            return fn(images).amax(dim=(1, 2))

    out = score_batch()
    if out.shape != (images.shape[0],) or not torch.isfinite(out).all():
        raise AssertionError("recon scoring batch gave non-finite or misshapen scores")
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(score_batch, torch, runs=10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] recon uint8→scores ae_deit (DeiT-base + ResNetDecoder) B={images.shape[0]} "
          f"bf16, batch on the device: {ms:.3f} ms/batch = {images.shape[0] / ms * 1e3:.1f} "
          f"img/s; peak memory {peak:.2f} GiB")

    b = RECON_STEP_BATCH
    batch, valid = images[:b], torch.ones(b, device=dev)
    latents = torch.randn(b, ae.trunk.embed_dim, device=dev).to(m.hp.dtypes.compute_dtype)
    # a second copy trains: the scoring batch keeps its AE in eval mode
    trained = build_pth_models(recon["pth"], "ae_deit", "recon", device=dev).parts[0].train()
    opt = torch_adam(trained.decoder.parameters(), 1e-3, 1e-4)
    step = lambda: recon_train_step(trained, opt, batch, valid, latents, mean, std)
    cnn = default_encoder(HyperParams(model_name="ae_cnn", img_size=224)).to(dev).train()
    cnn_opt = torch_adam(cnn.parameters(), 1e-3, 1e-4)
    cnn_step = lambda: recon_train_step(cnn, cnn_opt, batch, valid, None, mean, std)
    for what, fn_ in ((f"ae_deit decoder-only train step on cached [{b},{latents.shape[1]}] "
                       "latents (ResNetDecoder forward + backward + Adam)", step),
                      ("ae_cnn end-to-end train step (encoder + decoder, BatchNorm in training "
                       "mode, Adam)", cnn_step)):
        loss = fn_()
        if not torch.isfinite(loss):
            raise AssertionError(f"{what}: non-finite loss {loss}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = median_ms(fn_, torch, runs=10)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[{card}] {what} B={b} bf16: {ms:.3f} ms = {b / ms * 1e3:.1f} img/s; peak "
              f"memory {peak:.2f} GiB")
    return score_batch, step


def _cli_runs(what: str, cat: str, train_main, train_args, score_args, pth_glob: str,
              expect_train: dict, expect_score: dict, tmp: str, routes) -> dict:
    """Train a head with `train_main` on the category `cat`, then score its
    test folder with `cli.score` on the head it wrote; the launch counts of
    each run against `expect_*`, `routes(counts)` (the redesigned routes'
    counters, which must equal the launch counts they name), the history's
    losses and metrics finite and the scores.csv rows. Returns the launches
    of both runs, the head file and the scored files."""
    import glob

    import torch
    from vit_ad_tpu_torch.cli import score as score_cli

    run = os.path.join(tmp, f"{what}_run")
    reset_launches()
    t0 = time.perf_counter()
    rc = train_main(["-d", cat, "-t", "train/good", "-v", "test", "-i", "224", "--device",
                     "cuda", "--out", run, *train_args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train = read_launches()
    print(f"{what}: train CLI {train_args} rc={rc} in {wall:.2f} s: launches {train}, expected "
          f"{expect_train}; routes {routes(train)}")
    if rc != 0 or train != expect_train or any(a != b for a, b in routes(train)):
        raise AssertionError(f"{what}: the training run did not launch the path's kernels as "
                             "many times per batch and step as expected, each through its "
                             "redesigned route")
    with open(os.path.join(run, "history.json")) as f:
        hist = json.load(f)
    if not all(math.isfinite(v) for v in hist["train_loss"] + hist["valid_loss"]) or \
            not all(math.isfinite(v) for v in hist["metrics"].values()):
        raise AssertionError(f"{what}: non-finite losses or metrics: {hist}")
    print(f"{what}: train loss {hist['train_loss']}, valid loss {hist['valid_loss']}, metrics "
          f"{hist['metrics']} (random trunk and head: information only)")
    (pth,) = glob.glob(os.path.join(run, pth_glob))

    test_dir = os.path.join(cat, "test")
    out_dir = os.path.join(tmp, f"{what}_scores")
    reset_launches()
    t0 = time.perf_counter()
    rc = score_cli.main(["--pth", pth, "-d", test_dir, "-b", str(TRUNK_SCORE_BATCH), "-o",
                         out_dir, *score_args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    score = read_launches()
    print(f"{what}: cli.score.main {score_args} rc={rc} in {wall:.2f} s: launches {score}, "
          f"expected {expect_score}; routes {routes(score)}")
    if rc != 0 or score != expect_score or any(a != b for a, b in routes(score)):
        raise AssertionError(f"{what}: scoring did not launch the path's kernels as many times "
                             "per batch as expected, each through its redesigned route")
    files = score_cli.list_images(test_dir)
    check_scores_csv(out_dir, files, what)
    return {"launches": {k: train[k] + score[k] for k in train}, "pth": pth, "files": files}


def _f32_card_vs_cpu(what: str, pth: str, model: str, arch: str, files, distinct: bool = True,
                     **flags) -> None:
    """The head `pth` on `model` under the f32 policy, on the card and on the
    CPU: the image scores of two images, relative, and the trunk's tokens of
    the same images, relative to their largest entry, each within
    SCORE_RTOL_F32 (the tokens also show how far the two images' features
    are apart, which a random trunk may bring close). With `distinct`, the
    two images' scores must also lie further apart than SCORE_RTOL_F32 of
    the larger, or the comparison could not tell a head fault from
    agreement."""
    import numpy as np
    import torch
    from vit_ad_tpu_torch.config import DtypePolicy
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline, preprocess
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models, score_models

    mean, std = default_norm_stats()
    pipe = DataPipeline(2, 224, files=files[:2])
    images = torch.from_numpy(next(iter(pipe.test_batches())).images)
    got, tokens = {}, {}
    for device in ("cuda", "cpu"):
        m = build_pth_models(pth, model, arch, dtypes=DtypePolicy.f32(), device=device,
                             **flags)
        got[device] = score_models(m, pipe, mean, std).image_scores
        as_t = lambda a: torch.as_tensor(a, device=device)
        with torch.inference_mode():
            x = preprocess(images.to(device), as_t(mean), as_t(std))
            tokens[device] = m.parts[0](x).patch_embedding.float().cpu()
    rel = np.abs(got["cuda"] - got["cpu"]) / np.abs(got["cpu"])
    scale = tokens["cpu"].abs().max().item()
    tok_rel = (tokens["cuda"] - tokens["cpu"]).abs().max().item() / scale
    apart = (tokens["cpu"][0] - tokens["cpu"][1]).abs().max().item() / scale
    print(f"{what} f32 image scores cuda {got['cuda'].tolist()} cpu {got['cpu'].tolist()}: "
          f"max rel diff {rel.max():.3e}; tokens (max |token| {scale:.3e}): max diff "
          f"{tok_rel:.3e} of it (rtol {SCORE_RTOL_F32:.0e}), the two images' tokens "
          f"{apart:.3e} of it apart")
    if not (rel.max() <= SCORE_RTOL_F32 and tok_rel <= SCORE_RTOL_F32):
        raise AssertionError(f"CUDA f32 {what} scores or tokens disagree with the CPU path")
    gap = abs(got["cpu"][0] - got["cpu"][1]) / np.abs(got["cpu"]).max()
    print(f"{what}: the two images' f32 scores {gap:.3e} of the larger apart"
          + (f" (must exceed {SCORE_RTOL_F32:.0e})" if distinct else " (not checked)"))
    if distinct and not gap > SCORE_RTOL_F32:
        raise AssertionError(f"{what}: the two images score alike, so the card-vs-CPU "
                             "comparison cannot show a fault of the head or the score tail")


def trunks_main_path(tmp: str) -> dict:
    """Phase 10: the three other trunks at full width through the CLIs, on
    one synthetic 224-px category. NesT-T + NF-20 (`cli.train_nf -m nest`,
    then `cli.score -a nf -m enc_nest`, under the default fused LayerNorm,
    `models/nest.FUSED_LN_DEFAULT`): B1 12 and B7 27 times per encoder batch,
    all through the one-pass and rows kernels.
    EfficientFormer-L3 + MDN K=150 (`cli.train_mdn -m eff_former`, then
    `cli.score -a mdn`): B2 on every forward and B3 on every train step, all
    through their wgmma kernels, at D = 512. EfficientNet-B4 + NF-20
    (`cli.train_nf -m eff_net`, then `cli.score -a nf`): no kernel. Each with
    its f32 scores on the card against the CPU. Returns each path's
    launches and head file."""
    import torch
    from vit_ad_tpu_torch.cli import train_mdn as train_mdn_cli
    from vit_ad_tpu_torch.cli import train_nf as train_nf_cli
    from vit_ad_tpu_torch.config import DtypePolicy
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.data.synthetic import make_mvtec_category
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm
    from vit_ad_tpu_torch.ops.cuda import layer_norm as ln
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    cat = make_mvtec_category(os.path.join(tmp, "trunks"), "hinge", img_size=224,
                              n_train=TRUNK_TRAIN, n_test_good=TRUNK_TEST,
                              n_test_defect=TRUNK_TEST)
    split = DataPipeline(TRUNK_BATCH, 224, base_path=cat, data_path="train/good")
    n_batches = lambda n, b: -(-n // b)
    n_tr = n_batches(len(split.train_files), TRUNK_BATCH)
    n_va = n_batches(len(split.valid_files), TRUNK_BATCH)
    n_te = n_batches(2 * TRUNK_TEST, TRUNK_BATCH)
    n_enc, nb = n_tr + n_va + n_te, n_batches(2 * TRUNK_TEST, TRUNK_SCORE_BATCH)
    common = ["-e", str(TRUNK_EPOCHS), "-p", str(TRUNK_EPOCHS), "-b", str(TRUNK_BATCH)]
    out = {}

    # the trunks are frozen and their features cached: the encoder runs once
    # over the train, validation and test batches
    nest_expect = lambda n: {**NO_LAUNCHES, "B1": NEST_B1_PER_BATCH * n,
                             "B7": NEST_B7_PER_BATCH * n}
    out["nest"] = _cli_runs(
        "NesT", cat, train_nf_cli.main, ["-m", "nest", *common],
        ["-a", "nf", "-m", "enc_nest"], "nf_enc_nest_*.pth", nest_expect(n_enc),
        nest_expect(nb), tmp,
        lambda c: [(wa.one_pass_launches, c["B1"]), (ln.rows_launches, c["B7"])])
    _f32_card_vs_cpu("NesT", out["nest"]["pth"], "enc_nest", "nf", out["nest"]["files"])

    # every train step: one forward and a parameter backward of two kernels per
    # chunk of components (padded batches: always TRUNK_BATCH x 49 rows); the
    # validation loss and the final evaluation: forwards only; no dx
    chunks = -(-MDN_K // cgmm.backward_chunk(TRUNK_BATCH * 49, 512, MDN_K,
                                             DtypePolicy().compute_dtype))
    ep = TRUNK_EPOCHS
    out["eff_former"] = _cli_runs(
        "EfficientFormer", cat, train_mdn_cli.main,
        ["-m", "eff_former", "-n", str(MDN_K), *common], ["-a", "mdn", "-m", "enc_eff_former"],
        f"{MDN_K}_gaussians_enc_eff_former_*.pth",
        {**NO_LAUNCHES, "B2": ep * (n_tr + n_va) + n_te, "B3": ep * n_tr * 2 * chunks},
        {**NO_LAUNCHES, "B2": nb}, tmp,
        lambda c: [(cgmm.fwd_wgmma_launches, c["B2"]),
                   (cgmm.bwd_wgmma_params_launches, c["B3"])])
    _f32_card_vs_cpu("EfficientFormer", out["eff_former"]["pth"], "enc_eff_former", "mdn",
                     out["eff_former"]["files"])

    # the seed-random B4 (the JAX init) shrinks its tokens to ~1e-6 of unit
    # scale, where the head scores every image alike: this pair shows that the
    # path runs and the trunk agrees, not that the head's scores do
    out["eff_net"] = _cli_runs(
        "EfficientNet", cat, train_nf_cli.main, ["-m", "eff_net", *common],
        ["-a", "nf", "-m", "enc_eff_net"], "nf_enc_eff_net_*.pth", dict(NO_LAUNCHES),
        dict(NO_LAUNCHES), tmp, lambda c: [])
    _f32_card_vs_cpu("EfficientNet", out["eff_net"]["pth"], "enc_eff_net", "nf",
                     out["eff_net"]["files"], distinct=False)
    torch.cuda.synchronize()
    return out


def nest_attention_times(card: str, gen) -> list:
    """Phase 11: B1 at NesT-T's three level shapes of a B=128 batch (2048,
    512 and 128 blocks of 196 tokens, hd = 32), bf16: kernel vs plain by
    events (order plain, kernel, kernel, plain), SDPA on the same q, k, v
    (views of the packed qkv) by events, both back to back, beside the bound.
    Raises unless each launch took the one-pass kernel and agrees with the
    plain version. Returns the per-shape JSON numbers."""
    import torch
    import torch.nn.functional as F
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    per_shape = []
    for level, windows, c, heads in NEST_LEVELS:
        qkv = torch.randn(windows, 196, 3 * c, device="cuda", generator=gen).to(torch.bfloat16)
        kern = lambda: wa.vit_attention_qkv(qkv, heads)
        plain = lambda: wa.vit_attention_qkv_reference(qkv, heads)
        q, k, v = qkv.reshape(windows, 196, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v)
        with torch.no_grad():
            before = wa.launches, wa.one_pass_launches
            got = kern()
            took = wa.launches - before[0], wa.one_pass_launches - before[1]
            err = (got.float() - plain().float()).abs().max().item()
            if took != (1, 1) or not err <= TOL["bfloat16"]:
                raise AssertionError(f"B1 at NesT {level}: launches (all, one-pass) {took}, "
                                     f"max|kernel-plain| {err}")
            kern_ms, plain_ms = alternate(kern, plain, TIMED_RUNS, 3)
            lib_ms = median_ms(sdpa, torch)
            b2b = [back_to_back_ms(f, torch) for f in (kern, sdpa)]
        nums = {"shape": f"NesT {level} [{windows},196,{3 * c}] H={heads}",
                "max_abs_err": err, "ms": statistics.mean(kern_ms),
                "plain_ms": statistics.mean(plain_ms), "library_ms": lib_ms,
                "back_to_back_ms": b2b[0], "library_back_to_back_ms": b2b[1],
                **bound(tensor_bytes(qkv, got), 4 * windows * heads * 196 * 196 * (c // heads))}
        per_shape.append(nums)
        print(f"[{card}] vit_attention_qkv (B1) {nums['shape']} bf16, one-pass route: kernel "
              f"{kern_ms} ms ({b2b[0]:.4f} ms back to back, 200 launches), plain {plain_ms} ms "
              f"(order plain, kernel, kernel, plain), SDPA {lib_ms:.4f} ms ({b2b[1]:.4f} ms back "
              f"to back), bound {nums['bound_ms']:.4f} ms by {nums['bound_by']} (kernel back to "
              f"back at {nums['bound_ms'] / b2b[0]:.3f} of it); max|kernel-plain| {err:.3e}")
        del qkv, q, k, v, got
    return per_shape


def trunk_alone(name: str, model: str, images, card: str):
    """Phase 11: uint8→tokens of the frozen trunk `model` alone at B=128 bf16
    (preprocessing included), ms/batch and peak memory. Returns the timed
    function."""
    import torch
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import preprocess
    from vit_ad_tpu_torch.registry import get_model

    dev = torch.device("cuda")
    mean, std = (torch.as_tensor(a, device=dev) for a in default_norm_stats())
    enc = get_model(model, 224, generator=torch.Generator().manual_seed(5)).to(dev).eval()

    def encode():
        with torch.inference_mode():
            return enc(preprocess(images, mean, std)).patch_embedding

    out = encode()
    if out.shape != (FLAGSHIP_BATCH, enc.num_patches, enc.embed_dim) or \
            not torch.isfinite(out).all():
        raise AssertionError(f"{name} gave non-finite or misshapen tokens: {tuple(out.shape)}")
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(encode, torch, runs=10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] {name} uint8→tokens alone B={FLAGSHIP_BATCH} bf16, batch on the device: "
          f"{ms:.3f} ms/batch = {FLAGSHIP_BATCH / ms * 1e3:.1f} img/s; peak memory {peak:.2f} GiB")
    return encode


def trunks_times(trunks: dict, images, card: str, gen) -> dict:
    """Phase 11, the other trunks: NesT-T + NF-20 uint8→scores img/s at B=128
    with the fused LayerNorm off and on (the A/B that sets
    `models/nest.FUSED_LN_DEFAULT`) and its peak memory; B1 at NesT's three
    level shapes and B7 at its two new norm shapes; B2 and B3 at
    EfficientFormer-L3's MDN shapes (D = 512); EfficientFormer-L3 and
    EfficientNet-B4 trunk ms/batch and peak memory. Returns the kernels'
    per-shape JSON numbers and the functions whose device time phase 11
    profiles last."""
    import torch
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fns, _ = flag_ab("NesT", "NesT-T", "fused LN", images, card,
                     lambda fused: build_pth_models(trunks["nest"]["pth"], "enc_nest", "nf",
                                                    device=dev, fused_ln=fused))
    print(f"[{card}] NesT peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(both models and the batch resident)")
    out = {"B1": nest_attention_times(card, gen),
           "B7": layer_norm_times(card, gen, NEST_LN_SHAPES)["per_stage"]}
    head = build_pth_models(trunks["eff_former"]["pth"], "enc_eff_former", "mdn",
                            device=dev).parts[1]
    gmm = [gmm_split_times(b * 49, 512, MDN_K, head, card, gen, MDN_TIMED_RUNS)
           for b in (FLAGSHIP_BATCH, 64)]
    for v, what in zip(gmm, ("EfficientFormer MDN scoring B=128",
                             "EfficientFormer MDN train B=64")):
        for nums in v.values():
            nums["shape"] = f"{what}: {nums['shape']}"
    # B2 at the scoring shape, B3 at the train step's
    out["B2"], out["B3"] = [gmm[0]["B2"]], [gmm[1]["B3"]]
    del head
    torch.cuda.empty_cache()
    profiles = {"NesT": fns[True]}
    for name, model in (("EfficientFormer-L3", "enc_eff_former"),
                        ("EfficientNet-B4", "enc_eff_net")):
        torch.cuda.empty_cache()
        profiles[name] = trunk_alone(name, model, images, card)
    return out, profiles


def mlp_times(card: str, gen) -> dict:
    """Phase 11, B6: the MLP half-block at the DeiT-base shape of a B=128
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
    """Phase 11: DeiT-base + NF-20 uint8→scores img/s at B=128 bf16 with the
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
    """Phase 11: DeiT-base + NF-20 uint8→scores img/s at B=128 bf16 with the
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


# the run-directory phase: NF-20 flows on ResNet-50 stage maps 0-2 (hidden
# ratio 0.16, startTraining_NF.py:35-36) trained by `cli.train_nf -m res_net`
# at batch 32 for a few epochs (80 training images: 2 train batches and 1
# validation batch an epoch); a DeiT-base NF-20 run for `--watch`,
# `--heatmaps` and `--weights-dtype bf16` (its first watch wave 16 images,
# the second 32 new ones); the timed scoring batch 128 and train step 32
NFRES_TRAIN, NFRES_TEST, NFRES_EPOCHS, NFRES_BATCH, NFRES_SCORE_BATCH = 80, 4, 3, 32, 4
DEIT_NF_TRAIN, DEIT_NF_EPOCHS, WATCH_BATCH, WATCH_FIRST, WATCH_NEW = 32, 2, 16, 16, 32
# cli.validate against the metrics each trainer recorded (absolute): the same
# models and batches on the same card, so the same computation
VALIDATE_ATOL = 1e-4


def _launches_of(run) -> tuple:
    """(what `run()` returned, the kernel launches it made, wall seconds)."""
    import torch

    reset_launches()
    t0 = time.perf_counter()
    out = run()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, read_launches(), time.perf_counter() - t0


def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _check_rundir(run: str, what: str, recons: bool = False) -> dict:
    """Every file of a run directory (`cli/common.py`) is there; returns its
    config.json."""
    with open(os.path.join(run, "config.json")) as f:
        cfg = json.load(f)
    figures = ["heatmaps", "ground_truth", "overlay", "roc_curve", "pr_curve"] + \
        (["recons"] if recons else [])
    want = ["config.json", "metrics.jsonl", "metrics.csv", "history.json", "loss_curves.png",
            *(f"figures/{name}.png" for name in figures), *cfg.get("checkpoints", [])]
    missing = [name for name in want if not os.path.exists(os.path.join(run, name))]
    if missing or not cfg.get("checkpoints"):
        raise AssertionError(f"{what}: the run directory lacks {missing or 'checkpoints'}")
    print(f"{what}: run directory holds {len(want)} files: checkpoints {cfg['checkpoints']}")
    return cfg


def _scores_of(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "scores.csv")) as f:
        return {r[0]: float(r[1]) for r in list(csv.reader(f))[1:]}


def _write_images(folder: str, start: int, n: int, size: int = 224) -> None:
    """n synthetic `size`-px PNGs img_<i>.png, i from start (a bright square
    on every fourth)."""
    import numpy as np
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(start, start + n):
        rng = np.random.default_rng(100 + i)
        base = rng.integers(0, 256, 3)[None, None, :] + 40 * np.sin((xx + 7 * i)[..., None] / 9.0)
        img = np.clip(base + rng.normal(0, 12, (size, size, 3)), 0, 255).astype(np.uint8)
        if i % 4 == 3:
            q = size // 4
            img[q:2 * q, q + i % q:2 * q + i % q] = 255
        Image.fromarray(img).save(os.path.join(folder, f"img_{i:03d}.png"))


def rundir_main_path(tmp: str, mdn_run: str, img: int = 224, device: str = "cuda") -> dict:
    """Phase 11: run directories and NF on ResNet. `cli.train_nf -m res_net`
    at full width (ResNet-50, three NF-20 flows, batch 32, bf16 trunk): every
    run-directory file, the loss falls, the trunk bit-identical and only the
    read stage norms moved, no kernel launched (the path has none); `cli.score
    -r` on it, f32 card vs CPU; `cli.score -r` on phase 6's MDN run against
    `--pth` on its file; a DeiT-base NF run: `--watch` twice (the second only
    the new files, its rows the one-shot scores), `--heatmaps 4`,
    `--weights-dtype bf16`; `cli.validate` over the phase's runs against each
    trainer's recorded metrics. `img` and `device` let the phase run small on
    the CPU with tiny registry models (a dry run of its checks; the launch
    counts then stay 0)."""
    import glob

    import numpy as np
    import torch
    from vit_ad_tpu_torch.cli import score as score_cli
    from vit_ad_tpu_torch.cli import train_nf as train_nf_cli
    from vit_ad_tpu_torch.cli import validate as validate_cli
    from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.data.synthetic import make_mvtec_category
    from vit_ad_tpu_torch.pipeline.loading import (
        build_run_models,
        compress_params_bf16,
        find_checkpoint,
        load_run_config,
        score_models,
    )
    from vit_ad_tpu_torch.pipeline.train import default_encoder

    runs = os.path.join(tmp, "runs")
    os.makedirs(runs)
    total: dict = {}
    # the kernels launch on the card only; on the CPU every count stays 0
    on_card = lambda counts: counts if device == "cuda" else NO_LAUNCHES

    # NF-ResNet: train through the CLI
    cat = make_mvtec_category(os.path.join(tmp, "nfres"), "screw", img_size=img,
                              n_train=NFRES_TRAIN, n_test_good=NFRES_TEST,
                              n_test_defect=NFRES_TEST)
    test_dir = os.path.join(cat, "test")
    run = os.path.join(runs, "nf_resnet")
    rc, train, wall = _launches_of(lambda: train_nf_cli.main(
        ["-m", "res_net", "-d", cat, "-t", "train/good", "-v", "test", "-e", str(NFRES_EPOCHS),
         "-p", str(NFRES_EPOCHS), "-b", str(NFRES_BATCH), "-i", str(img), "-r", "0.16", "-f", "20",
         "--device", device, "--out", run]))
    _add(total, train)
    with open(os.path.join(run, "history.json")) as f:
        hist = json.load(f)
    print(f"cli.train_nf.main -m res_net rc={rc} in {wall:.2f} s: train loss "
          f"{hist['train_loss']}, valid loss {hist['valid_loss']}, metrics {hist['metrics']} "
          f"(random trunk: information only); launches {train}, expected {NO_LAUNCHES}")
    if rc != 0 or train != NO_LAUNCHES or hist["epochs_ran"] != NFRES_EPOCHS:
        raise AssertionError("the NF-ResNet training run failed, or launched a kernel")
    if not all(math.isfinite(v) for v in hist["train_loss"] + hist["valid_loss"]) or \
            not hist["train_loss"][-1] < hist["train_loss"][0]:
        raise AssertionError(f"the NF-ResNet train loss did not fall: {hist['train_loss']}")
    cfg = _check_rundir(run, "NF-ResNet")
    init = default_encoder(HyperParams(model_name="enc_res_net", img_size=img)).state_dict()
    after = torch.load(os.path.join(run, cfg["checkpoints"][-1]), map_location="cpu",
                       weights_only=True)
    moved = sorted(k for k, v in init.items() if not torch.equal(v, after[k]))
    want_moved = sorted(f"norms.{i}.{leaf}" for i in (0, 1, 2) for leaf in ("weight", "bias"))
    print(f"encoder file: {len(after)} tensors, changed by training: {moved}")
    if sorted(after) != sorted(init) or moved != want_moved:
        raise AssertionError(f"training moved {moved}, expected exactly {want_moved}")
    del init, after

    # score it with -r: the CLI on the card, then f32 card vs CPU
    out_dir = os.path.join(tmp, "nfres_scores")
    rc, score, wall = _launches_of(lambda: score_cli.main(
        ["-r", run, "-d", test_dir, "-b", str(NFRES_SCORE_BATCH), "-o", out_dir, "--device",
         device]))
    _add(total, score)
    files = score_cli.list_images(test_dir)
    print(f"cli.score.main -r <NF-ResNet run> rc={rc} in {wall:.2f} s: launches {score}")
    if rc != 0 or score != NO_LAUNCHES:
        raise AssertionError("NF-ResNet scoring failed or launched a kernel")
    check_scores_csv(out_dir, files, "NF-ResNet")
    hp, rcfg = load_run_config(run)
    hp.dtypes = DtypePolicy.f32()
    two = [files[0], files[-1]]  # a good and a defective image
    got = {}
    for where in (device, "cpu"):
        m = build_run_models(hp, find_checkpoint(run, rcfg), where)
        got[where] = score_models(m, DataPipeline(2, img, files=two),
                                  *default_norm_stats()).image_scores
    rel = np.abs(got[device] - got["cpu"]) / np.abs(got["cpu"])
    apart = abs(got["cpu"][0] - got["cpu"][1])
    print(f"NF-ResNet f32 image scores {device} {got[device].tolist()} cpu {got['cpu'].tolist()}: "
          f"max rel diff {rel.max():.3e} (rtol {SCORE_RTOL_F32:.0e}); the two images' scores "
          f"{apart:.3e} apart")
    if not rel.max() <= SCORE_RTOL_F32 or not apart > SCORE_RTOL_F32:
        raise AssertionError("CUDA f32 NF-ResNet scores disagree with the CPU path, or do not "
                             "tell the two images apart")

    # -r against --pth on phase 6's MDN run
    mdn_cfg = _check_rundir(mdn_run, "MDN (phase 6)")
    (mdn_pth,) = [os.path.join(mdn_run, n) for n in mdn_cfg["checkpoints"]]
    mdn_test = os.path.join(mdn_cfg["base_path"], "test")
    by_run, by_pth = os.path.join(tmp, "mdn_by_run"), os.path.join(tmp, "mdn_by_pth")
    rc, r_launch, wall = _launches_of(lambda: score_cli.main(
        ["-r", mdn_run, "-d", mdn_test, "-b", str(MDN_SCORE_BATCH), "-o", by_run, "--device",
         device]))
    _add(total, r_launch)
    rc2, p_launch, _ = _launches_of(lambda: score_cli.main(
        ["--pth", mdn_pth, "-a", "mdn", "-d", mdn_test, "-b", str(MDN_SCORE_BATCH), "-o",
         by_pth, "-i", str(img), "--device", device]))
    _add(total, p_launch)
    nb = -(-len(score_cli.list_images(mdn_test)) // MDN_SCORE_BATCH)
    expect = on_card({**NO_LAUNCHES, "B1": 12 * nb, "B6": 12 * nb, "B7": DEIT_B7_PER_BATCH * nb,
                      "B2": nb})
    a, b = _scores_of(by_run), _scores_of(by_pth)
    diff = max(abs(a[k] - b[k]) for k in a) if a.keys() == b.keys() else float("inf")
    print(f"cli.score -r <MDN run> rc={rc} in {wall:.2f} s: launches {r_launch} ({nb} batches; "
          f"expected {expect}); --pth rc={rc2}: launches {p_launch}; max |-r - --pth| {diff:.3e}")
    if rc != 0 or rc2 != 0 or r_launch != expect or p_launch != expect or diff != 0.0:
        raise AssertionError("-r on the MDN run directory does not equal --pth on its file, or "
                             "did not launch B1, B6, B7 and B2 per batch")

    # a DeiT-base NF run: --watch, --heatmaps, --weights-dtype bf16
    deit_cat = make_mvtec_category(os.path.join(tmp, "deit_nf"), "cable", img_size=img,
                                   n_train=DEIT_NF_TRAIN, n_test_good=4, n_test_defect=4)
    deit_run = os.path.join(runs, "deit_nf")
    rc, train, wall = _launches_of(lambda: train_nf_cli.main(
        ["-m", "deit", "-d", deit_cat, "-t", "train/good", "-v", "test", "-e",
         str(DEIT_NF_EPOCHS), "-p", str(DEIT_NF_EPOCHS), "-b", str(WATCH_BATCH), "-i", str(img),
         "--device", device, "--out", deit_run]))
    _add(total, train)
    split = DataPipeline(WATCH_BATCH, img, base_path=deit_cat, data_path="train/good")
    n_enc = sum(-(-n // WATCH_BATCH) for n in (len(split.train_files), len(split.valid_files), 8))
    expect = on_card({**NO_LAUNCHES, "B1": 12 * n_enc, "B6": 12 * n_enc,
                      "B7": DEIT_B7_PER_BATCH * n_enc})
    print(f"cli.train_nf.main -m deit rc={rc} in {wall:.2f} s: launches {train}, expected "
          f"{expect} ({n_enc} encoder batches: feature cache and test)")
    if rc != 0 or train != expect:
        raise AssertionError("the DeiT NF training run did not launch B1, B6 and B7 per encoder "
                             "batch")
    _check_rundir(deit_run, "DeiT NF")

    incoming, watch_out = os.path.join(tmp, "incoming"), os.path.join(tmp, "watch")
    _write_images(incoming, 0, WATCH_FIRST, img)
    watch = ["-r", deit_run, "-d", incoming, "-o", watch_out, "-b", str(WATCH_BATCH),
             "--watch", "0.01", "--watch-waves", "1", "--device", device]
    rc, first, _ = _launches_of(lambda: score_cli.main(watch))
    _add(total, first)
    before = open(os.path.join(watch_out, "scores.csv")).read().splitlines()
    _write_images(incoming, WATCH_FIRST, WATCH_NEW, img)
    rc2, second, wall = _launches_of(lambda: score_cli.main(watch))
    _add(total, second)
    lines = open(os.path.join(watch_out, "scores.csv")).read().splitlines()
    oneshot = os.path.join(tmp, "watch_oneshot")
    rc3, one, _ = _launches_of(lambda: score_cli.main(
        ["-r", deit_run, "-d", incoming, "-o", oneshot, "-b", str(WATCH_BATCH), "--device",
         device]))
    _add(total, one)
    w, o = _scores_of(watch_out), _scores_of(oneshot)
    new_b = -(-WATCH_NEW // WATCH_BATCH)
    expect = on_card({**NO_LAUNCHES, "B1": 12 * new_b, "B6": 12 * new_b,
                      "B7": DEIT_B7_PER_BATCH * new_b})
    diff = max(abs(w[k] - o[k]) for k in o) if w.keys() == o.keys() else float("inf")
    print(f"--watch: first run rc={rc} {len(before) - 1} rows, launches {first}; second run "
          f"rc={rc2} in {wall:.2f} s (model load included) {len(lines) - 1} rows, launches "
          f"{second}, expected {expect}; max |watch - one-shot| {diff:.3e}")
    if rc != 0 or rc2 != 0 or rc3 != 0 or lines[:len(before)] != before or \
            len(lines) != 1 + WATCH_FIRST + WATCH_NEW or second != expect or diff != 0.0:
        raise AssertionError("--watch did not score only the new files, with the one-shot "
                             "scores and one B1/B6/B7 set per new batch")

    hm_out = os.path.join(tmp, "heatmaps_out")
    rc, hm, _ = _launches_of(lambda: score_cli.main(
        ["-r", deit_run, "-d", os.path.join(deit_cat, "test"), "-o", hm_out, "--heatmaps", "4",
         "--device", device]))
    _add(total, hm)
    pngs = sorted(os.listdir(os.path.join(hm_out, "heatmaps")))
    print(f"--heatmaps 4: rc={rc}, {pngs}")
    if rc != 0 or len(pngs) != 4:
        raise AssertionError("--heatmaps 4 did not write four overlays")

    bf_out = os.path.join(tmp, "bf16_out")
    rc, bf, _ = _launches_of(lambda: score_cli.main(
        ["-r", deit_run, "-d", os.path.join(deit_cat, "test"), "-o", bf_out,
         "--weights-dtype", "bf16", "--device", device]))
    _add(total, bf)
    hp, dcfg = load_run_config(deit_run)
    n_cast = compress_params_bf16(build_run_models(hp, find_checkpoint(deit_run, dcfg)))
    s16, s32 = _scores_of(bf_out), _scores_of(hm_out)
    drift = max(abs(s16[k] - s32[k]) / abs(s32[k]) for k in s32)
    print(f"--weights-dtype bf16: rc={rc}, {n_cast} f32 tensors rounded to bf16; scores against "
          f"the f32 weights (same bf16 policy): max rel drift {drift:.3e} (information)")
    if rc != 0 or not n_cast or not all(math.isfinite(v) for v in s16.values()):
        raise AssertionError("--weights-dtype bf16 failed")

    # cli.validate over the phase's runs (phase 6's MDN run linked in)
    os.symlink(mdn_run, os.path.join(runs, "mdn"))
    rc, val, wall = _launches_of(lambda: validate_cli.main(["-r", runs, "--device", device]))
    _add(total, val)
    with open(os.path.join(runs, "validation_results.csv")) as f:
        rows = {r["Name"]: r for r in csv.DictReader(f)}
    worst = 0.0
    for name in ("nf_resnet", "deit_nf", "mdn"):
        with open(os.path.join(runs, name, "metrics.jsonl")) as f:
            recorded = [json.loads(line) for line in f][-1]
        for key in ("image_auroc_score", "pixel_auroc_score", "image_prauc_score",
                    "pro_score_0.3fp"):
            d = abs(float(rows[name][key]) - recorded[key])
            worst = max(worst, d)
            if d > VALIDATE_ATOL:
                print(f"cli.validate {name} {key}: {rows[name][key]} against the recorded "
                      f"{recorded[key]} ({d:.3e})")
    print(f"cli.validate rc={rc} in {wall:.2f} s over {sorted(rows)}: max |validate - "
          f"recorded| {worst:.3e} (atol {VALIDATE_ATOL:.0e}); launches {val}")
    if rc != 0 or sorted(rows) != ["deit_nf", "mdn", "nf_resnet"] or worst > VALIDATE_ATOL:
        raise AssertionError("cli.validate failed or did not reproduce the recorded metrics")
    print(f"phase launches {total}")
    return {"launches": total, "nf_resnet": run, "nf_resnet_data": cat, "deit_nf": deit_run,
            "incoming": incoming}


def rundir_times(r: dict, images, card: str) -> dict:
    """Phase 12, run-directory part: NF-ResNet uint8→scores img/s at batch
    128 (bf16 trunk, f32 flows) and its train step at batch 32 (ms, peak
    memory), and the wall time of a 32-image `--watch` wave of the DeiT NF
    run after the first (models loaded once). Returns the step for the
    profile."""
    import tempfile

    import torch
    from vit_ad_tpu_torch.cli.score import _load_run_cli, _prepare, watch_folder
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.pipeline.eval import make_nf_resnet_batch_fn
    from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
    from vit_ad_tpu_torch.pipeline.train import nf_resnet_train_step

    dev = torch.device("cuda")
    m, _ = _load_run_cli(r["nf_resnet"], dev, None, None)
    encoder, flows = m.parts
    mean, std = (torch.as_tensor(a, device=dev) for a in default_norm_stats())
    fn = make_nf_resnet_batch_fn(encoder, flows, m.hp, mean, std)

    def scores():
        with torch.inference_mode():
            return fn(images).amax(dim=(1, 2))

    out = scores()
    if out.shape != (FLAGSHIP_BATCH,) or not torch.isfinite(out).all():
        raise AssertionError("NF-ResNet batch gave non-finite or misshapen scores")
    held = torch.cuda.memory_allocated() / 2**30  # what the times phase holds already
    torch.cuda.reset_peak_memory_stats()
    batch_ms = median_ms(scores, torch, runs=10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] NF-ResNet uint8→scores ResNet-50 + 3 NF-20 B={FLAGSHIP_BATCH} (bf16 trunk, "
          f"f32 flows), batch on the device: {batch_ms:.3f} ms/batch = "
          f"{FLAGSHIP_BATCH / batch_ms * 1e3:.1f} img/s; peak memory {peak:.2f} GiB, "
          f"{peak - held:.2f} above the {held:.2f} GiB held before")

    flows.train()
    opt = torch_adam(list(flows.parameters()) + list(encoder.norms.parameters()), 1e-3, 1e-5)
    batch, valid = images[:NFRES_BATCH], torch.ones(NFRES_BATCH, device=dev)
    step = lambda: nf_resnet_train_step(encoder, flows, opt, batch, valid, mean, std)
    step()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30  # Adam's state included
    torch.cuda.reset_peak_memory_stats()
    step_ms = median_ms(step, torch, runs=10)
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] NF-ResNet joint train step B={NFRES_BATCH} (3 NF-20 flows + stage norms, "
          f"Adam): {step_ms:.3f} ms = {NFRES_BATCH / step_ms * 1e3:.1f} img/s; peak memory "
          f"{step_peak:.2f} GiB, {step_peak - held:.2f} above the {held:.2f} GiB held before")

    wm, _ = _load_run_cli(r["deit_nf"], dev, None, None)
    _, wmean, wstd = _prepare(wm, WATCH_BATCH, False, "")
    with tempfile.TemporaryDirectory(dir=os.path.dirname(r["incoming"])) as folder:
        out = os.path.join(folder, "out")
        _write_images(os.path.join(folder, "in"), 0, WATCH_BATCH)
        watch_folder(wm, "timed", os.path.join(folder, "in"), out, wmean, wstd, 0.0, 1)
        _write_images(os.path.join(folder, "in"), WATCH_BATCH, WATCH_NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = watch_folder(wm, "timed", os.path.join(folder, "in"), out, wmean, wstd, 0.0, 1)
        torch.cuda.synchronize()
        wave_s = time.perf_counter() - t0
    if summary["last_wave"]["n"] != WATCH_NEW:
        raise AssertionError(f"the timed watch wave scored {summary['last_wave']['n']} files")
    print(f"[{card}] --watch wave of {WATCH_NEW} new 224-px PNGs on the DeiT-base NF-20 run after "
          f"the first (batch {WATCH_BATCH}, models loaded): {wave_s:.3f} s wall = "
          f"{WATCH_NEW / wave_s:.1f} img/s (decode check, decode, scoring, scores.csv)")
    del wm
    return {"step": step, "batch_ms": batch_ms, "step_ms": step_ms, "step_peak": step_peak,
            "wave_s": wave_s}


# the bundles phase: the CLI runs above exported as native serving bundles
# (`serving/aot.py`) at the flagship's batch and 224 px, each served from a
# fresh process (`--serve-bundle`) that imports torch, numpy, the serving
# module and the kernels' op module only; and the DeiT NF run as a portable
# bundle at batch 2 (traced from a CPU copy of the models), served on the CPU
# and on the card
BUNDLE_BATCH, PORTABLE_BATCH = FLAGSHIP_BATCH, 2
# modules a serving process must not import: JAX, the model zoo, the pipeline,
# the data layer (it scores arrays)
SERVING_FORBIDDEN = ("jax.", "flax", "vit_ad_tpu.", "vit_ad_tpu_torch.models",
                     "vit_ad_tpu_torch.pipeline", "vit_ad_tpu_torch.registry",
                     "vit_ad_tpu_torch.data")
# the MDN scores payload against the host tail on the same payload: torch's
# f32 exp against numpy's (a few ulps of a probability in [0, 1])
SCORES_TAIL_ATOL = 1e-6
# the portable bundle on the CPU against the port's CPU path: the same aten ops
PORTABLE_RTOL = 1e-6
DECODE_REPEATS = 3


def serve_bundle(bundle_dir: str, images_npy: str, out_json: str, device: str = "cuda") -> int:
    """`--serve-bundle`: load the bundle in this fresh process and score the
    uint8 images of `images_npy`; write the scores, the kernel launches of
    that call, its seconds and the load's, and any forbidden module the
    process imported."""
    import numpy as np
    from vit_ad_tpu_torch.serving import aot

    t0 = time.perf_counter()
    bundle = aot.load_bundle(bundle_dir, device)
    load_s = time.perf_counter() - t0
    images = np.load(images_npy)
    (scores, _), launches, first_s = _launches_of(lambda: bundle.score(images))
    forbidden = sorted(m for m in sys.modules if m == "jax" or m.startswith(SERVING_FORBIDDEN))
    with open(out_json, "w") as f:
        json.dump({"scores": np.asarray(scores).tolist(), "launches": launches,
                   "chunks": -(-len(images) // bundle.batch), "load_s": load_s,
                   "first_call_s": first_s, "forbidden_imports": forbidden,
                   "device": str(bundle.device)}, f)
    return 0


def decode_rates(files, card: str) -> dict:
    """img/s of decoding 224-px PNGs on the host, one file at a time through
    PIL and through the native library (`data/native.py`), and the native
    batch decoder on all the host's cores; which decoder the data layer runs."""
    import numpy as np
    from PIL import Image
    from vit_ad_tpu_torch.data import native

    paths = list(files) * DECODE_REPEATS

    def pil(p):
        with Image.open(p) as im:
            return np.asarray(im.convert("RGB").resize((224, 224), Image.BILINEAR))

    def rate(fn):
        t0 = time.perf_counter()
        fn()
        return len(paths) / (time.perf_counter() - t0)

    which = native.decoder()
    out = {"decoder": which, "cpus": os.cpu_count(), "files": len(paths),
           "pil_img_s": rate(lambda: [pil(p) for p in paths])}
    print(f"image decoder of the data layer: {which}"
          + (f" (native unavailable: {native.reason})" if which == "pil" else ""))
    if which == "native":
        out["native_img_s"] = rate(lambda: [native.load_image(p, 224) for p in paths])
        out["native_batch_img_s"] = rate(lambda: native.load_batch(paths, 224))
    print(f"[{card}] decode + resize of {len(paths)} 224-px PNGs on the host (os.cpu_count() = "
          f"{out['cpus']}): PIL {out['pil_img_s']:.1f} img/s on one thread; native "
          + (f"{out['native_img_s']:.1f} img/s on one thread, {out['native_batch_img_s']:.1f} "
             f"img/s through load_batch on {out['cpus']} threads" if which == "native"
             else "not measured (unavailable)"))
    return out


def _serve_fresh(bundle_dir: str, images, tmp: str, device: str = "cuda") -> dict:
    """Serve `images` with the bundle from a fresh `--serve-bundle` process."""
    import numpy as np

    npy, res = os.path.join(tmp, "bundle_images.npy"), os.path.join(tmp, "bundle_served.json")
    np.save(npy, images)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-bundle",
                           bundle_dir, npy, res, device], capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serving {bundle_dir} failed: {proc.stderr[-3000:]}")
    with open(res) as f:
        out = json.load(f)
    out["process_s"] = wall
    return out


def bundles_main_path(tmp: str, nf_pth: str, deit_pth: str, img_dir: str, mdn: dict,
                      esvit: dict, resnet: dict) -> dict:
    """Phase 12: the decode rates; `cli.score -b 128` on each run's folder;
    each run exported as a native bundle at batch 128 (`serving/aot.py`) and
    served from a fresh process: launches per batch equal to the live path's
    (B1 12, B6 12, B7 13 for DeiT; B2 1 more for the MDN head; B5 12, B7 29
    for EsViT; B2 2 for the ResNet heads), none while tracing, and scores
    equal to `cli.score`'s (the MDN scores payload: to the host tail of the
    live payload with the same baked normalizer); the portable DeiT NF bundle
    holds no kernel op, scores on the CPU as the port's CPU path, and serves
    on the card without a launch."""
    import numpy as np
    import torch
    from vit_ad_tpu_torch.cli import score as score_cli
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.pipeline.loading import (
        build_pth_models,
        build_pth_resnet_mdn_models,
        score_models,
    )
    from vit_ad_tpu_torch.scoring import payload_to_scores
    from vit_ad_tpu_torch.serving import aot

    card = card_line()
    decode = decode_rates(score_cli.list_images(img_dir), card)
    mean, std = default_norm_stats()
    dev = torch.device("cuda")
    deit = {"B1": 12, "B6": 12, "B7": DEIT_B7_PER_BATCH}
    nf_argv = ["--pth", nf_pth, "-a", "nf", "-m", "enc_deit", "-E", deit_pth]
    ref = aot.decode_files(score_cli.list_images(mdn["train_dir"]), 224, BUNDLE_BATCH)
    runs = [  # name, models, folder, cli.score flags, launches per batch, export options
        ("DeiT NF", lambda: build_pth_models(nf_pth, "enc_deit", "nf", encoder_ckpt=deit_pth,
                                             device=dev), img_dir, nf_argv, deit, {}),
        ("DeiT NF scores", None, img_dir, nf_argv, deit, {"payload": "scores"}),
        ("DeiT MDN scores", lambda: build_pth_models(mdn["pth"], "enc_deit", "mdn", device=dev),
         mdn["test_dir"], ["--pth", mdn["pth"], "-a", "mdn", "-m", "enc_deit"],
         {**deit, "B2": 1}, {"payload": "scores", "ref_images": ref}),
        ("EsViT NF", lambda: build_pth_models(esvit["pth"], "enc_esvit", "nf", device=dev,
                                              fused_ln=True), esvit["test_dir"],
         ["--pth", esvit["pth"], "-a", "nf", "-m", "enc_esvit", "--fused-ln"],
         {"B5": ESVIT_B5_PER_BATCH, "B7": ESVIT_B7_PER_BATCH}, {}),
        ("ResNet MDN", lambda: build_pth_resnet_mdn_models(resnet["pths"],
                                                           encoder_ckpt=resnet["encoder"],
                                                           device=dev), resnet["test_dir"],
         ["--pth", *resnet["pths"], "-a", "mdn", "-E", resnet["encoder"]], {"B2": 2}, {}),
    ]
    total, bundles, cli_scores, m = dict(NO_LAUNCHES), {}, {}, None
    for name, make, folder, argv, per_batch, options in runs:
        files = score_cli.list_images(folder)
        nb = -(-len(files) // BUNDLE_BATCH)
        expect = {**NO_LAUNCHES, **{k: v * nb for k, v in per_batch.items()}}
        if folder not in cli_scores:
            out_dir = os.path.join(tmp, "bundle_cli_" + name.replace(" ", "_"))
            rc, launches, wall = _launches_of(lambda: score_cli.main(
                [*argv, "-d", folder, "-b", str(BUNDLE_BATCH), "-o", out_dir]))
            print(f"{name}: cli.score -b {BUNDLE_BATCH} rc={rc} in {wall:.2f} s: launches "
                  f"{launches}, expected {expect}")
            if rc != 0 or launches != expect:
                raise AssertionError(f"{name}: cli.score did not launch the path's kernels")
            _add(total, launches)
            cli_scores[folder] = check_scores_csv(out_dir, files, name)
        m = make() if make is not None else m
        images = aot.decode_files(files, 224, BUNDLE_BATCH)
        bdir = os.path.join(tmp, "bundles", name.replace(" ", "_"))
        man, traced, export_s = _launches_of(lambda: aot.export_bundle(
            m, bdir, batch=BUNDLE_BATCH, portable=False, mean=mean, std=std,
            extra_meta={"source": argv[1]}, **options))
        size = sum(os.path.getsize(os.path.join(bdir, f)) for f in os.listdir(bdir))
        served = _serve_fresh(bdir, images, tmp)
        _add(total, served["launches"])
        got = np.asarray(served["scores"], np.float32)
        if "ref_images" in options:  # the baked normalizer: the host tail of the live payload
            fn, _ = aot.build_payload_fn_and_params(m, mean, std)
            live = aot._run_padded(fn, images, BUNDLE_BATCH, dev)
            want = payload_to_scores("mdn", live, 224, ref_max_ll=man["ref_max_loglik"])[0]
            call = payload_to_scores("mdn", live, 224)[0]
            if not np.array_equal(call, cli_scores[folder]):
                raise AssertionError(f"{name}: the live payload's per-call scores differ from "
                                     "cli.score's")
            tol = SCORES_TAIL_ATOL
        else:
            want, tol = cli_scores[folder], 0.0
        diff = float(np.abs(got - want).max())
        print(f"{name}: native bundle ({man['payload']} payload, {man['kernel_ops']} kernel "
              f"ops, {size / 2**20:.1f} MiB) exported in {export_s:.2f} s (launches while "
              f"tracing and computing the baked normalizer {traced}); served from a fresh "
              f"process in {served['process_s']:.2f} s (load {served['load_s']:.2f} s, first "
              f"call {served['first_call_s']:.3f} s for {served['chunks']} chunk of "
              f"{BUNDLE_BATCH}): launches {served['launches']}, expected {expect}; max "
              f"|bundle - {'host tail' if tol else 'cli.score'}| {diff:.3e} (tol {tol:.0e}); "
              f"forbidden imports {served['forbidden_imports']}")
        if "ref_images" not in options and traced != NO_LAUNCHES:
            raise AssertionError(f"{name}: the export trace launched kernels {traced}")
        if served["launches"] != expect or served["forbidden_imports"] or not diff <= tol \
                or man["kernel_ops"] < 1:
            raise AssertionError(f"{name}: the native bundle did not serve as the live path")
        bundles[name] = {"dir": bdir, "models": m, "export_s": export_s,
                         "load_s": served["load_s"], "first_call_s": served["first_call_s"],
                         "mib": size / 2**20}

    # the portable bundle of the DeiT NF run, exported from the models on the
    # card (the export traces a CPU copy), served on the CPU and on the card
    m = build_pth_models(nf_pth, "enc_deit", "nf", encoder_ckpt=deit_pth, device=dev)
    pdir = os.path.join(tmp, "bundles", "DeiT_NF_portable")
    man, traced, export_s = _launches_of(lambda: aot.export_bundle(
        m, pdir, batch=PORTABLE_BATCH, platforms=["cpu", "cuda"], mean=mean, std=std))
    ops = aot._ops_in(torch.export.load(os.path.join(pdir, aot.SCORER_NAME)))
    two = score_cli.list_images(img_dir)[:PORTABLE_BATCH]
    got = aot.load_bundle(pdir, device="cpu").score_files(two)[0]
    cpu = build_pth_models(nf_pth, "enc_deit", "nf", encoder_ckpt=deit_pth, device="cpu")
    want = score_models(cpu, DataPipeline(PORTABLE_BATCH, 224, files=two), mean, std).image_scores
    rel = float((np.abs(got - want) / np.abs(want)).max())
    live2 = cli_scores[img_dir][:PORTABLE_BATCH]
    (on_card, _), card_launches, _ = _launches_of(
        lambda: aot.load_bundle(pdir, device="cuda").score_files(two))
    print(f"DeiT NF portable bundle exported in {export_s:.2f} s (traced on the "
          f"{man['exported_on']}; launches {traced}): kernel ops in the graph {ops}; on the CPU "
          f"at batch {PORTABLE_BATCH} scores {got.tolist()}, the port's CPU path "
          f"{want.tolist()}: max rel diff {rel:.3e} (rtol {PORTABLE_RTOL:.0e}); moved to the "
          f"card: scores {on_card.tolist()} (plain ops in bf16 there; max rel diff from "
          f"cli.score's {float((np.abs(on_card - live2) / np.abs(live2)).max()):.3e}), launches "
          f"{card_launches}")
    if ops or man["kernel_ops"] or traced != NO_LAUNCHES or not rel <= PORTABLE_RTOL \
            or man["exported_on"] != "cpu" or card_launches != NO_LAUNCHES \
            or on_card.shape != got.shape or not np.isfinite(on_card).all():
        raise AssertionError("the portable bundle holds a kernel op, scores otherwise than "
                             "the CPU path, or does not serve on the card")
    print(f"phase launches {total}")
    return {"launches": total, "bundles": bundles, "decode": decode}


def bundle_times(b: dict, images, card: str) -> dict:
    """Each native bundle's program against the live payload function on the
    same device batch of 128: median ms in the order bundle, live, bundle
    (the first reading before the live path has run in this loop), beside
    its export, load and first-call seconds, the device memory reserved
    around it, and the decode rates of the bundles phase; then, once every
    reading is taken, for each bundle and its live path the host seconds of
    enqueueing one batch, the program's graph size, and their device
    profiles."""
    import torch
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.scoring import scores_tail
    from vit_ad_tpu_torch.serving import aot

    mean, std = default_norm_stats()
    out = {}
    for name, r in b["bundles"].items():
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved() / 2**30
        bundle = aot.load_bundle(r["dir"])
        fn, _ = aot.build_payload_fn_and_params(r["models"], mean, std)
        if bundle.payload_kind == "scores":
            tail = scores_tail(bundle.kind, 224, bundle.manifest.get("ref_max_loglik"))
            live = lambda f=fn, t=tail: t(f(images))  # noqa: E731
        else:
            live = lambda f=fn: f(images)  # noqa: E731
        program = lambda bundle=bundle: bundle._call(images)  # noqa: E731
        with torch.inference_mode():
            ms = [median_ms(g, torch) for g in (program, live, program)]
        n = images.shape[0]
        out[name] = {"bundle_img_s": [n / ms[0] * 1e3, n / ms[2] * 1e3],
                     "live_img_s": n / ms[1] * 1e3, **{
                         k: r[k] for k in ("export_s", "load_s", "first_call_s", "mib")}}
        print(f"[{card}] {name} bundle uint8→payload B={n}: "
              f"{out[name]['bundle_img_s'][0]:.1f} img/s, live path "
              f"{out[name]['live_img_s']:.1f} img/s, bundle again "
              f"{out[name]['bundle_img_s'][1]:.1f} img/s; export {r['export_s']:.2f} s, load "
              f"{r['load_s']:.2f} s, first call {r['first_call_s']:.3f} s, {r['mib']:.1f} MiB; "
              f"device memory reserved {reserved:.2f} GiB before loading, "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB after")
        nodes = [nd.target for nd in bundle._program.graph.nodes if nd.op == "call_function"]
        asserts = sum("_assert_tensor_metadata" in str(t) for t in nodes)
        out[name]["fns"] = (program, live, len(nodes), asserts)
    d = b["decode"]
    print(f"[{card}] decode img/s on the host ({d['decoder']}, os.cpu_count() = {d['cpus']}): "
          f"PIL {d['pil_img_s']:.1f}"
          + (f", native {d['native_img_s']:.1f}, native batch {d['native_batch_img_s']:.1f}"
             if d["decoder"] == "native" else ", native not available"))
    # last: the profiler's hooks slow the host down for whatever is timed after it
    for name, r in out.items():
        program, live, nodes, asserts = r.pop("fns")
        with torch.inference_mode():
            for what, fn in (("bundle", program), ("live path", live)):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                enqueue = time.perf_counter() - t0
                torch.cuda.synchronize()
                print(f"[{card}] {name} {what}: one batch enqueued in {enqueue * 1e3:.1f} ms"
                      + (f"; its program holds {nodes} calls, {asserts} of them tensor "
                         f"metadata asserts" if what == "bundle" else ""))
                print_device_profile(f"{name} {what} B={images.shape[0]}", fn, card, top=6)
    return out


# the sweep-and-weights phase: `cli.trainings_loop -a mdn -m enc_deit` over two
# synthetic categories at the root script's MDN defaults (K=100, batch 64,
# lr 7e-4, wd 7e-4; trainings_loop.py:85-87), two epochs; the same sweep through
# one spawned worker; k-means init at K=100 on one category's DeiT-base
# features; the VAE through `run_sweep` at 224 px, one category, two epochs
SWEEP_CATS, SWEEP_TRAIN, SWEEP_TEST, SWEEP_EPOCHS, SWEEP_BATCH, SWEEP_K = \
    ("bottle", "cable"), 20, 4, 2, 64, 100
KMEANS_EPOCHS = 3
# CHIP_SMOKE_KMEANS_IMAGES=N runs the k-means check on a category of N good
# images of its own instead: MVTec's hold 200-400, so N=400 gives 320
# training images x 196 DeiT-base patch tokens = 62720 rows x 768, the host
# cost of k-means at their size
KMEANS_IMAGES_ENV = "CHIP_SMOKE_KMEANS_IMAGES"
VAE_TRAIN, VAE_TEST, VAE_EPOCHS, VAE_BATCH = 40, 4, 2, 16
# results.csv of an MDN sweep: the JAX engine's columns, in its order (the
# CPU tests hold the port's header to the JAX package's)
SWEEP_COLUMNS = ["Name", "dataclass", "model", "epochs_ran", "best_valid_loss",
                 "image_auroc_score", "pixel_auroc_score", "image_prauc_score",
                 "pro_score_0.3fp", "aupro_score_0.3fp", "fp_thres"]
# the spawned worker's rows against the sequential sweep's: the same program,
# inputs and seeds on the same card, so equal but for a library that chose
# another algorithm in the fresh process; metrics absolute, the best
# validation loss relative
FANOUT_ATOL, FANOUT_RTOL = 1e-9, 1e-6


def _mdn_head_expect(n_tr: int, n_va: int, n_te: int, epochs: int, k: int, rows: int,
                     d: int = 768) -> dict:
    """Launches of a frozen-trunk MDN head under the default bf16 policy: B2
    per train and validation step and test batch, B3's two kernels per chunk
    of components per train step (padded batches of `rows` feature rows)."""
    from vit_ad_tpu_torch.config import DtypePolicy
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

    chunks = -(-k // cgmm.backward_chunk(rows, d, k, DtypePolicy().compute_dtype))
    return {**NO_LAUNCHES, "B2": epochs * (n_tr + n_va) + n_te,
            "B3": epochs * n_tr * 2 * chunks}


def _deit_nf_expect(n_enc: int) -> dict:
    """Launches of `n_enc` DeiT-base encoder batches (`DEIT_OFF` each)."""
    return {key: n_enc * v for key, v in DEIT_OFF.items()}


def _deit_mdn_expect(n_tr: int, n_va: int, n_te: int, epochs: int, k: int, batch: int) -> dict:
    """Launches of a frozen-DeiT-base MDN run: B1, B6 and B7 per encoder batch
    (the feature cache over the train, validation and test batches) and the
    head's (`_mdn_head_expect`, `batch` x 196 rows a step)."""
    head = _mdn_head_expect(n_tr, n_va, n_te, epochs, k, batch * 196)
    return {**_deit_nf_expect(n_tr + n_va + n_te), "B2": head["B2"], "B3": head["B3"]}


def _check_mdn_routes(got: dict, expect: dict, what: str) -> None:
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

    check_deit_routes(got, expect, what)
    print(f"{what}: B2 through the wgmma kernel {cgmm.fwd_wgmma_launches}, B3 through its "
          f"wgmma kernels {cgmm.bwd_wgmma_params_launches}")
    if cgmm.fwd_wgmma_launches != expect["B2"] or \
            cgmm.bwd_wgmma_params_launches != expect["B3"]:
        raise AssertionError(f"{what}: B2 or B3 did not take the wgmma kernels")


def _done_rows(out: str, cats) -> list:
    rows = []
    for cat in cats:
        with open(os.path.join(out, cat, "done.json")) as f:
            rows.append(json.load(f))
    return rows


def sweep_weights_main_path(tmp: str, mdn_run: str, esvit: dict, nfres_run: str,
                            nf_pth: str, deit_pth: str, img_dir: str, img: int = 224,
                            device: str = "cuda", k: int = SWEEP_K) -> dict:
    """Phase 13: the sweep engine and the weight CLIs at full width.
    `cli.trainings_loop -a mdn -m enc_deit` over two synthetic categories
    (DeiT-base + MDN K=100, batch 64, bf16, two epochs): no row has an error,
    B1/B6/B7 per encoder batch and B2/B3 per step through their redesigned
    routes, results.csv in the JAX columns; the same command again trains
    nothing (no launch, the same rows); the same sweep through
    `run_sweep_parallel` with one spawned worker pinned to card 0, its rows
    against the sequential ones; `train_mdn(kmeans_init=True)` at K=100 (the
    mu bias at the optimizer's start is the centres, transposed; the loss
    falls; the host seconds of k-means); the VAE through `run_sweep` (no
    launch, the loss falls, f32 image scores card against CPU);
    `cli.export_weights` on phase 6's MDN run scored with `--pth` against
    `-r` (difference 0) and on phase 11's NF-ResNet run (three flow files and
    the encoder file, each strict-loading); `cli.convert_weights --arch deit`
    on a timm-layout DeiT-base file with `module.` and `distillation_token`,
    `-E <dir>` against `-E <file>`, and a `student`-wrapped EsViT file
    against its bare state dict (differences 0), scoring phase 7's head
    (`esvit`: its "pth" and "test_dir"). `img`, `device` and `k` let the
    phase run small on the CPU (a dry run of its checks; the launch counts
    then stay 0)."""
    import dataclasses

    import numpy as np
    import torch
    from vit_ad_tpu_torch.cli import convert_weights as convert_cli
    from vit_ad_tpu_torch.cli import export_weights as export_cli
    from vit_ad_tpu_torch.cli import score as score_cli
    from vit_ad_tpu_torch.cli import trainings_loop as sweep_cli
    from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.data.synthetic import make_mvtec_category
    from vit_ad_tpu_torch.models.resnet import ResNetEncoder
    from vit_ad_tpu_torch.models.vae import VariationalAutoEncoder
    from vit_ad_tpu_torch.pipeline import cluster_init
    from vit_ad_tpu_torch.pipeline import train as train_module
    from vit_ad_tpu_torch.pipeline.eval import score_vae
    from vit_ad_tpu_torch.pipeline.loading import load_run_config
    from vit_ad_tpu_torch.pipeline.sweep import SweepRun, run_sweep, run_sweep_parallel
    from vit_ad_tpu_torch.registry import get_model

    t_phase = time.perf_counter()
    total: dict = {}
    on_card = lambda counts: counts if device == "cuda" else NO_LAUNCHES
    batches = lambda n, b: -(-n // b)

    # the sweep, sequential, through the CLI
    root = os.path.join(tmp, "sweep_data")
    for seed, cat in enumerate(SWEEP_CATS):
        make_mvtec_category(root, cat, img_size=img, n_train=SWEEP_TRAIN, n_test_good=SWEEP_TEST,
                            n_test_defect=SWEEP_TEST, seed=seed)
    out = os.path.join(tmp, "sweep")
    argv = ["-a", "mdn", "-m", "enc_deit", "-d", root, "-o", out, "-c", ",".join(SWEEP_CATS),
            "-e", str(SWEEP_EPOCHS), "-p", str(SWEEP_EPOCHS), "-b", str(SWEEP_BATCH), "-i",
            str(img), "-n", str(k), "--device", device]
    rc, seq, wall = _launches_of(lambda: sweep_cli.main(argv))
    _add(total, seq)
    category_seconds = wall / len(SWEEP_CATS)
    split = DataPipeline(SWEEP_BATCH, img, base_path=os.path.join(root, SWEEP_CATS[0]),
                         data_path="train/good")
    n_tr, n_va = batches(len(split.train_files), SWEEP_BATCH), \
        batches(len(split.valid_files), SWEEP_BATCH)
    one = _deit_mdn_expect(n_tr, n_va, batches(2 * SWEEP_TEST, SWEEP_BATCH), SWEEP_EPOCHS, k,
                           SWEEP_BATCH)
    expect = on_card({key: len(SWEEP_CATS) * v for key, v in one.items()})
    print(f"cli.trainings_loop -a mdn -m enc_deit rc={rc} in {wall:.2f} s ({len(SWEEP_CATS)} "
          f"categories x ({n_tr} train + {n_va} valid batches of {SWEEP_BATCH} x "
          f"{SWEEP_EPOCHS} epochs, 1 test batch), K={k}); per category {on_card(one)}")
    _check_mdn_routes(seq, expect, "the sequential sweep")
    with open(os.path.join(out, "results.csv")) as f:
        table = list(csv.reader(f))
    rows = _done_rows(out, SWEEP_CATS)
    print(f"results.csv columns {table[0]}; rows {[r[:5] for r in table[1:]]}")
    errors = [r for r in rows if "error" in r]
    if rc != 0 or errors or table[0] != SWEEP_COLUMNS or len(table) != 1 + len(SWEEP_CATS) \
            or any(r["epochs_ran"] != SWEEP_EPOCHS for r in rows) \
            or not all(math.isfinite(r[c]) for r in rows for c in SWEEP_COLUMNS[4:]):
        raise AssertionError(f"the sweep failed, or a row holds an error: {errors or table}")

    # resume: the same command trains nothing
    before = open(os.path.join(out, "results.csv")).read()
    rc, again, wall = _launches_of(lambda: sweep_cli.main(argv))
    _add(total, again)
    same = open(os.path.join(out, "results.csv")).read() == before and \
        _done_rows(out, SWEEP_CATS) == rows
    print(f"resume: rc={rc} in {wall:.2f} s, launches {again}, rows equal {same}")
    if rc != 0 or again != NO_LAUNCHES or not same:
        raise AssertionError("the resumed sweep trained again or changed its rows")

    # fan-out: one spawned worker, pinned to card 0
    hp = dataclasses.replace(sweep_cli.base_hp("mdn", "enc_deit"), epochs=SWEEP_EPOCHS,
                             patience=SWEEP_EPOCHS, batch_size=SWEEP_BATCH, img_size=img,
                             num_gaussians=k)
    runs = [SweepRun(category=c, data_root=root) for c in SWEEP_CATS]
    t0 = time.perf_counter()
    par = run_sweep_parallel("mdn", hp, runs, os.path.join(tmp, "sweep_par"), num_workers=1,
                             platform="cuda" if device == "cuda" else "cpu")
    wall = time.perf_counter() - t0
    strip = lambda r: {key: v for key, v in r.items() if key != "_hp"}
    bitwise = [json.dumps(p) == json.dumps(s) for p, s in zip(par, rows)]
    worst = {c: max(abs(p[c] - s[c]) for p, s in zip(par, rows)) for c in SWEEP_COLUMNS[4:]}
    print(f"run_sweep_parallel(num_workers=1) in {wall:.2f} s (a fresh process: its launches are "
          f"its own): rows bitwise equal to the sequential ones {bitwise}; max |worker - "
          f"sequential| {worst}")
    if [strip(p).keys() for p in par] != [strip(s).keys() for s in rows] or \
            any(p["_hp"] != s["_hp"] for p, s in zip(par, rows)) or \
            any(worst[c] > FANOUT_RTOL * max(abs(s["best_valid_loss"]) for s in rows)
                if c == "best_valid_loss" else worst[c] > FANOUT_ATOL for c in worst):
        raise AssertionError("the spawned worker's rows differ from the sequential sweep's")

    # k-means init of the MDN head at K=100 on one category's features
    km_data = split
    if os.environ.get(KMEANS_IMAGES_ENV):
        km_cat = make_mvtec_category(os.path.join(tmp, "kmeans_data"), "kmeans", img_size=img,
                                     n_train=int(os.environ[KMEANS_IMAGES_ENV]), n_test_good=1,
                                     n_test_defect=1)
        km_data = DataPipeline(SWEEP_BATCH, img, base_path=km_cat, data_path="train/good")
    seen: dict = {}
    real_kmeans, real_adam = cluster_init.kmeans_cluster_centers, train_module.torch_adam

    def kmeans(features, num_clusters, max_samples=100_000):
        t = time.perf_counter()
        seen["centers"] = real_kmeans(features, num_clusters, max_samples)
        seen["rows"], seen["seconds"] = features.shape[0] * features.shape[1], \
            time.perf_counter() - t
        return seen["centers"]

    def adam(params, lr, wd=0.0):
        params = list(params)
        seen["at_adam"] = [p.detach().clone() for p in params]
        return real_adam(params, lr, wd)

    cluster_init.kmeans_cluster_centers, train_module.torch_adam = kmeans, adam
    try:
        hp_k = dataclasses.replace(hp, epochs=KMEANS_EPOCHS, patience=KMEANS_EPOCHS,
                                   kmeans_init=True, data_class=SWEEP_CATS[0])
        enc = get_model("enc_deit", img, generator=torch.Generator().manual_seed(hp.seed))
        result, launches, wall = _launches_of(lambda: train_module.train_mdn(
            hp_k, km_data, None, encoder=enc, device=device))
    finally:
        cluster_init.kmeans_cluster_centers, train_module.torch_adam = real_kmeans, real_adam
    _add(total, launches)
    names = [n for n, _ in result.head.named_parameters()]
    bias = dict(zip(names, seen["at_adam"]))["mu.bias"].cpu().numpy()
    seeded = np.array_equal(bias, seen["centers"].T.reshape(-1))
    losses = result.history["train_loss"]
    print(f"train_mdn(kmeans_init=True) K={k} in {wall:.2f} s: k-means on the host "
          f"{seen['seconds']:.3f} s over {seen['rows']} rows x 768; mu bias at the optimizer's "
          f"start equals centers.T {seeded}; train loss {losses}")
    km_tr, km_va = batches(len(km_data.train_files), SWEEP_BATCH), \
        batches(len(km_data.valid_files), SWEEP_BATCH)
    _check_mdn_routes(launches, on_card(_deit_mdn_expect(km_tr, km_va, 0, KMEANS_EPOCHS, k,
                                                         SWEEP_BATCH)), "k-means MDN")
    if not seeded or not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError("the k-means init did not seed the head, or the loss did not fall")

    # the VAE through run_sweep at 224 px
    vae_root = os.path.join(tmp, "vae_data")
    vae_cat = make_mvtec_category(vae_root, "vase", img_size=img, n_train=VAE_TRAIN,
                                  n_test_good=VAE_TEST, n_test_defect=VAE_TEST)
    got: dict = {}

    def vae_trainer(hp, data, test, **kw):
        got["result"] = train_module.train_vae(hp, data, test, **kw)
        return got["result"]

    hp_v = HyperParams(model_name="vae", architecture="vae", epochs=VAE_EPOCHS,
                       patience=VAE_EPOCHS, batch_size=VAE_BATCH, img_size=img)
    (row,), launches, wall = _launches_of(lambda: run_sweep(
        vae_trainer, hp_v, [SweepRun(category="vase", data_root=vae_root)],
        os.path.join(tmp, "sweep_vae"), device=device))
    _add(total, launches)
    losses = got["result"].history["train_loss"]
    print(f"run_sweep(train_vae) at {img} px in {wall:.2f} s: launches {launches}; train loss "
          f"{losses}; row {row}")
    if "error" in row or launches != NO_LAUNCHES or not losses[-1] < losses[0]:
        raise AssertionError("the VAE run failed, launched a kernel, or its loss did not fall")
    files = score_cli.list_images(os.path.join(vae_cat, "test"))
    scores = {}
    for where in (device, "cpu"):
        vae = VariationalAutoEncoder(img, dtypes=DtypePolicy.f32())
        vae.load_state_dict(got["result"].head.state_dict())
        s = score_vae(vae.to(where).eval(), DataPipeline(2, img, files=[files[0], files[-1]]),
                      hp_v, *default_norm_stats())
        scores[where] = s.image_scores
    rel = np.abs(scores[device] - scores["cpu"]) / np.abs(scores["cpu"])
    apart = abs(scores["cpu"][0] - scores["cpu"][1]) / np.abs(scores["cpu"]).max()
    print(f"VAE f32 image scores {device} {scores[device].tolist()} cpu "
          f"{scores['cpu'].tolist()}: max rel diff {rel.max():.3e} (rtol {SCORE_RTOL_F32:.0e}); "
          f"{apart:.3e} of the larger apart")
    if not rel.max() <= SCORE_RTOL_F32 or not apart > SCORE_RTOL_F32:
        raise AssertionError("CUDA f32 VAE scores disagree with the CPU path, or do not tell a "
                             "good image from a defective one")

    # export phase 6's MDN run; --pth on the exported file against -r on the run
    mdn_hp, _ = load_run_config(mdn_run)
    exported = os.path.join(tmp, "exported", f"{mdn_hp.num_gaussians}_gaussians_enc_deit_"
                            f"{mdn_hp.data_class}.pth")
    rc_x = export_cli.main(["--run", mdn_run, "--dst", exported])
    test_dir = os.path.join(mdn_hp.base_path, "test")
    by_run, by_pth = os.path.join(tmp, "export_by_run"), os.path.join(tmp, "export_by_pth")
    rc, r_launch, _ = _launches_of(lambda: score_cli.main(
        ["-r", mdn_run, "-d", test_dir, "-b", str(MDN_SCORE_BATCH), "-o", by_run, "--device",
         device]))
    rc2, p_launch, _ = _launches_of(lambda: score_cli.main(
        ["--pth", exported, "-a", "mdn", "-m", "enc_deit", "-d", test_dir, "-b",
         str(MDN_SCORE_BATCH), "-o", by_pth, "-i", str(img), "--device", device]))
    _add(total, r_launch)
    _add(total, p_launch)
    a, b = _scores_of(by_run), _scores_of(by_pth)
    diff = max(abs(a[key] - b[key]) for key in a) if a.keys() == b.keys() else float("inf")
    print(f"cli.export_weights on the MDN run rc={rc_x}: {os.path.basename(exported)}; "
          f"cli.score --pth <exported> rc={rc2} launches {p_launch} against -r rc={rc} launches "
          f"{r_launch}: max |difference| {diff:.3e}")
    if rc_x or rc or rc2 or diff != 0.0 or p_launch != r_launch:
        raise AssertionError("the exported MDN head does not score as its run directory")

    # export phase 11's NF-ResNet run: three flows and the encoder, strict loads
    res_hp, _ = load_run_config(nfres_run)
    res_out = os.path.join(tmp, "exported_nf_resnet")
    rc = export_cli.main(["--run", nfres_run, "--dst", res_out])
    cls = res_hp.data_class
    want = sorted([f"NormalizingFlow_{i}_{cls}.pth" for i in train_module.NF_RESNET_STAGES]
                  + [f"ResNetEncoder_{cls}.pth"])
    written = sorted(os.listdir(res_out)) if os.path.isdir(res_out) else []
    load = lambda name: torch.load(os.path.join(res_out, name), map_location="cpu",
                                   weights_only=True)
    for i in train_module.NF_RESNET_STAGES:
        train_module.stage_flow(res_hp, i).load_state_dict(load(f"NormalizingFlow_{i}_{cls}.pth"),
                                                           strict=True)
    ResNetEncoder(res_hp.img_size).load_state_dict(load(f"ResNetEncoder_{cls}.pth"), strict=True)
    print(f"cli.export_weights on the NF-ResNet run rc={rc}: {written}, each strict-loads")
    if rc or written != want:
        raise AssertionError(f"the NF-ResNet export wrote {written}, expected {want}")

    # convert a timm-layout DeiT-base file; -E <dir> against -E <file>
    deit = torch.load(deit_pth, map_location="cpu", weights_only=True)
    timm = {f"module.{key}": v for key, v in deit.items() if key != "dist_token"}
    timm["module.distillation_token"] = deit["dist_token"]
    timm["module.head.weight"], timm["module.head.bias"] = torch.zeros(1000, 768), \
        torch.zeros(1000)
    src, conv_dir = os.path.join(tmp, "deit_timm.pth"), os.path.join(tmp, "deit_converted")
    torch.save(timm, src)
    rc_c = convert_cli.main(["--arch", "deit", "--src", src, "--dst", conv_dir, "--img-size",
                             str(img)])
    outs = {}
    for what, ckpt in (("dir", conv_dir), ("file", deit_pth)):
        outs[what] = os.path.join(tmp, f"convert_{what}")
        rc, launches, _ = _launches_of(lambda: score_cli.main(
            ["--pth", nf_pth, "-a", "nf", "-m", "enc_deit", "-E", ckpt, "-d", img_dir, "-b",
             str(SMOKE_BATCH), "-o", outs[what], "-i", str(img), "--device", device]))
        _add(total, launches)
        if rc:
            raise AssertionError(f"cli.score -E <{what}> failed")
    a, b = _scores_of(outs["dir"]), _scores_of(outs["file"])
    diff = max(abs(a[key] - b[key]) for key in a) if a.keys() == b.keys() else float("inf")
    print(f"cli.convert_weights --arch deit rc={rc_c} -> {os.listdir(conv_dir)}; cli.score "
          f"-E <dir> against -E <file> over {len(a)} images: max |difference| {diff:.3e}; "
          f"launches of the second {launches}")
    if rc_c or diff != 0.0:
        raise AssertionError("the converted DeiT-base does not score as its source file")

    # a student-wrapped EsViT file through -E against its bare state dict
    swin = get_model("enc_esvit", img, generator=torch.Generator().manual_seed(3)).state_dict()
    bare, wrapped = os.path.join(tmp, "esvit_bare.pth"), os.path.join(tmp, "checkpoint_best.pth")
    torch.save(swin, bare)
    student = {f"module.{key}": v for key, v in swin.items()}
    torch.save({"student": student, "teacher": student, "epoch": 3}, wrapped)
    for what, ckpt in (("wrapped", wrapped), ("bare", bare)):
        outs[what] = os.path.join(tmp, f"esvit_{what}")
        rc, launches, _ = _launches_of(lambda: score_cli.main(
            ["--pth", esvit["pth"], "-a", "nf", "-m", "enc_esvit", "-E", ckpt, "-d",
             esvit["test_dir"], "-b", str(ESVIT_SCORE_BATCH), "-o", outs[what], "-i", str(img),
             "--device", device]))
        _add(total, launches)
        if rc:
            raise AssertionError(f"cli.score -E <{what} EsViT file> failed")
    a, b = _scores_of(outs["wrapped"]), _scores_of(outs["bare"])
    diff = max(abs(a[key] - b[key]) for key in a) if a.keys() == b.keys() else float("inf")
    print(f"cli.score -m enc_esvit -E <student-wrapped file> against -E <bare state dict> over "
          f"{len(a)} images: max |difference| {diff:.3e}; launches of the second {launches}")
    if diff != 0.0:
        raise AssertionError("the student-wrapped EsViT file does not score as its state dict")
    wall = time.perf_counter() - t_phase
    print(f"phase launches {total}; phase wall {wall:.2f} s")
    return {"launches": total, "seconds": wall, "category_seconds": category_seconds}


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
    """Phase 11, ResNet part: the joint train step (frozen trunk forward, two
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
    B7 at the four Swin-T block norms, B6's LayerNorm step and NesT-T's two
    ConvPool norms (beside `F.layer_norm` on the same bf16 rows, before and
    after the turns), B2 bf16 at `GMM_PATH_SHAPES`, and B3 and B4 bf16 at
    `GMM_BWD_PATH_SHAPES` (`gmm_backward_against`). Prints ms per call, the
    bound, and the change's largest difference from the parent's output."""
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
    for rows, d in LN_PATH_SHAPES + NEST_LN_SHAPES:
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


# the mesh phase: two ranks of an explicit cluster (the VITAD_* variables)
# share card 0 (`CUDA_VISIBLE_DEVICES=0` for both), so their device
# collectives go over gloo. (a) `cli.train_mdn --mesh 1x2` (DeiT-base + MDN
# K=150, batch 64, two epochs) on phase 13's first category, each rank
# holding 75 components, and the first step through the API; (b) the
# ResNet-50 joint MDN step at K=100 on 1x2 through the API (B4's partial dx
# of each shard summed before the stage norms); (c) ae_cnn recon steps on
# 2x1 (global BatchNorm); (d) DeiT-base NF scoring of 100 images at batch
# 128 through `cli.score --mesh 2` (64 rows a rank: rank 0 scores images 0-63,
# rank 1 images 64-99 and 28 padding rows); (e) a bare `--mesh 2x1` on a
# one-card host refuses with the card count.
MESH_K, MESH_BATCH, MESH_EPOCHS = 150, 64, 2
MESH_RESNET_K, MESH_RESNET_BATCH, MESH_RESNET_STEPS, MESH_RESNET_LR = 100, 16, 3, 2e-4
MESH_RECON_BATCH, MESH_RECON_STEPS, MESH_RECON_LR = 16, 3, 1e-3
MESH_SCORE_BATCH, MESH_SCORE_IMAGES = FLAGSHIP_BATCH, 100
# B2, B3 and B4 against their plain versions at the shard shapes of the
# phase, before the ranks start: (a)'s 64 x 196 DeiT-base rows on 75 of 150
# components (a frozen trunk: no dx), (b)'s stage maps of 16 images
# (ResNet-50 stage 2: 196 tokens of 1024, stage 3: 49 of 2048) on 50 of 100
# components, with B4's dx
MESH_GMM_FWD_CASES = [(MESH_BATCH * 196, 768, MESH_K // 2, "bfloat16"),
                      (MESH_RESNET_BATCH * 196, 1024, MESH_RESNET_K // 2, "bfloat16"),
                      (MESH_RESNET_BATCH * 49, 2048, MESH_RESNET_K // 2, "bfloat16")]
MESH_GMM_BWD_CASES = [(*MESH_GMM_FWD_CASES[0], False), (*MESH_GMM_FWD_CASES[1], True),
                      (*MESH_GMM_FWD_CASES[2], True)]
MESH_TIMEOUT = 600
# (a)'s first step through the API against one process (the same features):
# its loss (rtol) and its head gradients (relative to each tensor's largest
# entry: the shards' logsumexp merge and the global softmax sum in other
# orders in f32; the bf16 rounding of the operands is the same); (d)'s scores
# against one process (rtol)
MESH_LOSS_RTOL, MESH_GRAD_RTOL, MESH_SCORE_RTOL = 1e-4, 1e-3, 1e-3
# (b), (c) against the same steps in one process: the losses (rtol) and the
# parameters after the steps, as the L2 norm of their difference over the L2
# norm of what the single-process steps moved them (an early Adam step moves
# every weight by the learning rate in its gradient's sign, and a gradient of
# noise size takes either sign, so a tensor's largest entry is no scale)
MESH_STEP_LOSS_RTOL, MESH_STEP_PARAM_RTOL = 1e-3, 5e-2
# (a) runs its DeiT-base trunk sharded over the two model ranks, whose block
# sums round once where the whole trunk rounds the projection and then the
# residual (bf16), and whose MLP sums its two partials in f32: features part
# from one process by bf16 roundings through 12 blocks, as the fused and the
# stock MLP tails do (FUSED_MLP_SCORE_RTOL). So against one process: the
# first-step loss and the histories (rtol), the scores of the two .pth files
# (rtol), and the metrics (atol: the image-level ones step by 1/16 on the 4 +
# 4 test images, and a pair of images within the scores' tolerance may swap)
MESH_TP_LOSS_RTOL, MESH_TP_HIST_RTOL, MESH_TP_SCORE_RTOL, MESH_TP_METRIC_ATOL = \
    5e-3, 5e-3, 2e-2, 0.07
# (e)-(g): a batch of each trunk sharded over the two model ranks against the
# whole trunk in one process (max |shard - whole| over max |whole| of the
# features, bf16: the roundings above), and the kernel launches a rank of the
# batch: (part, registry key, what, launches, the GEMM steps by epilogue).
# DeiT-base: norm1, norm2 and the final norm through B7, B1 at 6 heads, the
# GEMM step three times a block (fc1 GELU [1536, 768], fc2 and proj f32
# partials [768, 1536] and [768, 384]); EsViT Swin-T: B5 at stage 0 whole (3
# heads), at stages 1-3 on half the heads, the 29 fused LayerNorms, the GEMM
# steps where the widths are multiples of 128 (stages 2 and 3: fc1, fc2;
# stage 3: proj); NesT-T: its attention whole (B1 12), its 27 LayerNorms, the
# GEMM steps at level 2 (fc1, fc2)
MESH_TP_BATCH = FLAGSHIP_BATCH
MESH_TP_FEATURE_RTOL = 5e-2
MESH_TP_TRUNKS = [
    ("e", "enc_deit", "DeiT-base", {"B1": 12, "B7": 25, "GEMM": 36},
     {"gelu": 12, "residual": 0, "partial": 24}),
    ("f", "enc_esvit", "EsViT Swin-T", {"B5": 12, "B7": ESVIT_B7_PER_BATCH, "GEMM": 18},
     {"gelu": 8, "residual": 0, "partial": 10}),
    ("g", "enc_nest", "NesT-T", {"B1": 12, "B7": NEST_B7_PER_BATCH, "GEMM": 16},
     {"gelu": 8, "residual": 0, "partial": 8}),
]
# what a rank holds of one split tensor of each trunk (the full width over
# 2): DeiT-base block 0's and Swin-T stage 3's qkv rows (3 x 768 / 2), NesT-T
# level 2's fc1 rows (1536 / 2)
MESH_TP_SHARD = {"enc_deit": ("blocks.0.attn.qkv.weight", 1152),
                 "enc_esvit": ("layers.3.blocks.0.attn.qkv.weight", 1152),
                 "enc_nest": ("levels.2.transformer_encoder.0.mlp.fc1.weight", 768)}
# the kernels at the shard shapes of (a) and (e)-(g), M = 2, B = 128, bf16:
# B1 on the rank's heads ([B, N, 3C/M], H/M; and M = 4's 3 heads); B5 at
# EsViT stages 1-3 on half the heads, the bias gathered from the rank's
# columns of a whole table: (stage, windows, side, C/M, H/M, windows per
# image under the mask); the GEMM steps of a DeiT-base block, [M, K] x
# [N, K]^T: (what, M, N, K, epilogue)
MESH_B1_CASES = [(MESH_TP_BATCH, 198, 384, 6), (MESH_TP_BATCH, 198, 192, 3)]
MESH_B5_CASES = [("stage 1", 512, 14, 96, 3, 4), ("stage 2", 128, 14, 192, 6, 0),
                 ("stage 3", 128, 7, 384, 12, 0)]
MESH_GEMM_CASES = [("fc1 GELU", MESH_TP_BATCH * 198, 1536, 768, 0),
                   ("fc2 f32 partial", MESH_TP_BATCH * 198, 768, 1536, 2),
                   ("proj f32 partial", MESH_TP_BATCH * 198, 768, 384, 2)]
# the GEMM steps against their plain version, relative to the largest plain
# entry: GELU rounds to bf16 (MLP_TOL); the f32 partial sums the same bf16
# products in another order only
MESH_GEMM_RTOL = {0: MLP_TOL["bfloat16"], 2: 1e-4}


def tp_kernel_checks(card: str, gen) -> dict:
    """Phase 15, before the ranks: B1, B5 and the GEMM steps at the shard
    shapes (`MESH_B1_CASES`, `MESH_B5_CASES`, `MESH_GEMM_CASES`) against
    their plain versions, each timed beside its plain version (order plain,
    kernel, kernel, plain), its library call (SDPA; `torch.matmul` of the
    same product) and its bound. Returns the numbers by kernel: "B1" and
    "B5" lists of shapes, "GEMM" the fc2 partial's numbers with every shape
    in `per_shape`."""
    import torch
    from vit_ad_tpu_torch.ops import mlp as mops
    from vit_ad_tpu_torch.ops import window_attention as wops
    from vit_ad_tpu_torch.ops.cuda import mlp as cmlp
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    out = {"B1": [], "B5": [], "GEMM": None}
    for b, n, c, heads in MESH_B1_CASES:
        qkv = torch.randn(b, n, 3 * c, device=dev, generator=gen).to(bf16)
        kern = lambda: wa.vit_attention_qkv(qkv, heads)
        plain = lambda: wa.vit_attention_qkv_reference(qkv, heads)
        q, k, v = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)
        with torch.no_grad():
            before = wa.launches
            err = (kern().float() - plain().float()).abs().max().item()
            if not err <= TOL["bfloat16"] or wa.launches != before + 1:
                raise AssertionError(f"B1 at {heads} heads disagrees with its plain version: "
                                     f"{err}")
            kern_ms, plain_ms = alternate(kern, plain, TIMED_RUNS, 3)
            lib_ms = median_ms(sdpa, torch)
        nums = {"shape": f"[{b},{n},{3 * c}] H={heads}", "max_abs_err": err,
                "ms": statistics.mean(kern_ms), "plain_ms": statistics.mean(plain_ms),
                "library_ms": lib_ms,
                **bound(tensor_bytes(qkv) + tensor_bytes(qkv) // 3,
                        4 * b * heads * n * n * (c // heads))}
        out["B1"].append(nums)
        print(f"[{card}] vit_attention_qkv (B1) {nums['shape']} bf16 (a rank's heads): kernel "
              f"{kern_ms} ms, plain {plain_ms} ms, SDPA {lib_ms:.4f} ms, bound "
              f"{nums['bound_ms']:.4f} ms by {nums['bound_by']}; max|kernel-plain| {err:.3e} "
              f"(tol {TOL['bfloat16']:.0e})")
        del qkv, q, k, v
    for stage, windows, side, c, heads, n_w in MESH_B5_CASES:
        case = (windows, side, c, heads, windows // n_w if n_w else 0, 0)
        qkv3, _, mask = window_inputs(case, bf16, gen, dev)
        # the rank's columns (the second half) of a table of the whole stage's heads
        table = 0.5 * torch.randn((2 * side - 1) ** 2, 2 * heads, device=dev, generator=gen)
        index = torch.from_numpy(wops.relative_position_index(side, side)).to(dev)
        bias = wops.gather_bias(table[:, heads:], index)
        if not torch.equal(bias, wops.gather_bias(table, index)[heads:]):
            raise AssertionError("the sliced table's bias is not the whole bias's heads")
        q, k, v = wops.split_packed(qkv3, heads)
        additive = (bias[None] if mask is None else bias[None] + mask[:, None]).to(bf16)
        kern = lambda: wa.swin_attention_windows(qkv3, table, heads, side, mask, bias=bias)
        plain = lambda: wops.window_attention_reference(qkv3, bias, mask, heads)
        with torch.no_grad():
            before = wa.window_launches
            got = kern()
            err = (got.float() - plain().float()).abs().max().item()
            if not err <= TOL["bfloat16"] or wa.window_launches != before + 1:
                raise AssertionError(f"B5 at half the heads of {stage} disagrees with its plain "
                                     f"version: {err}")
            kern_ms, plain_ms = alternate(kern, plain, TIMED_RUNS, 3)
            lib_ms, lib_both, _ = sdpa_ms(q, k, v, additive, torch)
        nums = {"shape": f"{stage} [{windows},{side * side},{3 * c}] H={heads} "
                         f"mask={'none' if mask is None else n_w}",
                "max_abs_err": err, "ms": statistics.mean(kern_ms),
                "plain_ms": statistics.mean(plain_ms), "library_ms": lib_ms,
                **bound(tensor_bytes(qkv3, got, bias, mask),
                        4 * windows * heads * side ** 4 * (c // heads))}
        out["B5"].append(nums)
        print(f"[{card}] swin_attention_windows (B5) {nums['shape']} bf16 (half the heads, "
              f"the table's rank columns): kernel {kern_ms} ms, plain {plain_ms} ms, SDPA "
              f"{lib_both} ms, bound {nums['bound_ms']:.4f} ms by {nums['bound_by']}; "
              f"max|kernel-plain| {err:.3e} (tol {TOL['bfloat16']:.0e}), route "
              f"{wa.last_window_route}")
        del qkv3, q, k, v, got
    per_shape = []
    for what, m, n, k, epi in MESH_GEMM_CASES:
        a = (torch.randn(m, k, device=dev, generator=gen) * 0.5).to(bf16)
        w = (torch.randn(n, k, device=dev, generator=gen) * k ** -0.5).to(bf16)
        bias = None if epi == cmlp.EPILOGUE_PARTIAL else \
            0.1 * torch.randn(n, device=dev, generator=gen)
        kern = lambda: cmlp.gemm_step(a, w, bias, epi)
        plain = lambda: mops.gemm_step_reference(a, w, bias, epi)
        lib = lambda: torch.matmul(a, w.t())
        with torch.no_grad():
            before = cmlp.gemm_launches
            got, want = kern(), plain()
            scale = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            route = cmlp.last_gemm_route
            if got.dtype != want.dtype or not err <= MESH_GEMM_RTOL[epi] * scale or \
                    cmlp.gemm_launches != before + 1 or \
                    route != cmlp.GEMM_ROUTE_NAMES[epi + 1]:
                raise AssertionError(f"the GEMM step ({what}) disagrees with its plain version: "
                                     f"{err} of {scale}, route {route!r}")
            kern_ms, plain_ms = alternate(kern, plain, TIMED_RUNS, 3)
            lib_ms = median_ms(lib, torch)
        nums = {"shape": f"{what} [{m},{k}]x[{n},{k}]^T", "max_abs_err": err,
                "max_abs_plain": scale, "ms": statistics.mean(kern_ms),
                "plain_ms": statistics.mean(plain_ms), "library_ms": lib_ms,
                **bound(tensor_bytes(a, w, bias, got), 2 * m * n * k)}
        per_shape.append(nums)
        print(f"[{card}] gemm_step {nums['shape']} bf16, route {route}: kernel {kern_ms} ms "
              f"({2 * m * n * k / nums['ms'] / 1e9:.1f} TFLOP/s), plain {plain_ms} ms, "
              f"torch.matmul (bf16 out) {lib_ms:.4f} ms, bound {nums['bound_ms']:.4f} ms by "
              f"{nums['bound_by']}; max|kernel-plain| {err:.3e} of max|plain| {scale:.3e} "
              f"(rtol {MESH_GEMM_RTOL[epi]:.0e})")
        del a, w, got, want
    out["GEMM"] = {**{k: v for k, v in per_shape[1].items() if k != "shape"},
                   "per_shape": per_shape,
                   "design": "B6's persistent wgmma GEMM behind TMA (128x192 tiles, 4-stage "
                             "ring); the f32-partial epilogue stores the accumulator with "
                             "8-byte stores, no bias"}
    torch.cuda.empty_cache()
    return out


def _sharded_trunks(spec: dict, mc, rank: int) -> dict:
    """(e)-(g): a batch of `spec["tp_batch"]` seeded images through each
    trunk of `MESH_TP_TRUNKS` (seeded weights) sharded over the model ranks
    of `mc`: the kernel launches and GEMM-step routes of the sharded batch,
    its ms (information), the features' digest (the ranks must agree to the
    bit) and, on rank 0, their distance to the whole trunk's features in
    this process."""
    import hashlib

    import torch
    from vit_ad_tpu_torch.config import DtypePolicy
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import preprocess
    from vit_ad_tpu_torch.ops.cuda import mlp as cmlp
    from vit_ad_tpu_torch.parallel.multihost import barrier
    from vit_ad_tpu_torch.registry import get_model

    dev, img = torch.device(spec["device"]), spec["img"]
    mean, std = (torch.as_tensor(a, device=dev) for a in default_norm_stats())
    images = torch.from_numpy(_mesh_images(spec["tp_batch"], img, 9)).to(dev)
    out = {}
    for part, key, _, _, _ in MESH_TP_TRUNKS:
        trunk = get_model(key, img, DtypePolicy(), generator=torch.Generator().manual_seed(24))
        trunk = trunk.to(dev).eval()
        with torch.inference_mode():
            x = preprocess(images, mean, std)
            whole = trunk(x).patch_embedding.float() if rank == 0 else None
        trunk = mc.shard_params(trunk)
        barrier()
        reset_launches()
        t0 = time.perf_counter()
        with torch.inference_mode():
            feats = trunk(x).patch_embedding.float()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        got = {"ms": (time.perf_counter() - t0) * 1e3, "launches": read_launches(),
               "routes": dict(cmlp.gemm_route_launches), "shape": list(feats.shape),
               "finite": bool(torch.isfinite(feats).all()),
               "digest": hashlib.sha256(feats.cpu().numpy().tobytes()).hexdigest(),
               "shard_rows": trunk.state_dict()[MESH_TP_SHARD[key][0]].shape[0]}
        if whole is not None:
            got["rel"] = float((feats - whole).abs().max() / whole.abs().max())
        out[part] = got
        del trunk, x, whole, feats
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _mesh_images(n: int, img: int, seed: int):
    import numpy as np

    return np.random.default_rng(seed).integers(0, 256, (n, img, img, 3), dtype=np.uint8)


def _max_rel(got: dict, want: dict) -> float:
    """The largest |got - want| over each tensor's largest |want|."""
    out = 0.0
    for name, w in want.items():
        w = w.float()
        scale = float(w.abs().max()) or 1.0
        out = max(out, float((got[name].float() - w).abs().max()) / scale)
    return out


def _moved_rel(got: dict, want: dict, init: dict) -> float:
    """||got - want|| / ||want - init|| over every floating tensor of `want`
    (the parameters after the steps against their move from `init`)."""
    diff = moved = 0.0
    for name, w in want.items():
        if w.is_floating_point():
            diff += float((got[name].double() - w.double()).square().sum())
            moved += float((w.double() - init[name].double()).square().sum())
    return math.sqrt(diff / moved) if moved else math.sqrt(diff)


def _mdn_first_step(spec: dict, mc) -> dict:
    """(a) through the API: the trainer's first step (its seeded K-head, the
    first training batch's DeiT-base features, the seeded Gumbel noise) on
    this rank's shard against the full head in this process; the shards'
    gradients gathered to the full layout."""
    import torch
    from vit_ad_tpu_torch.config import DtypePolicy
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import DataPipeline
    from vit_ad_tpu_torch.models.mdn import GaussianMDN
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm
    from vit_ad_tpu_torch.parallel.sharding import gather_mdn_state
    from vit_ad_tpu_torch.pipeline.features import make_feature_extractor
    from vit_ad_tpu_torch.pipeline.train import masked_mdn_loss
    from vit_ad_tpu_torch.registry import get_model

    dev, k, img = torch.device(spec["device"]), spec["k"], spec["img"]
    enc = get_model("enc_deit", img, DtypePolicy(), generator=torch.Generator().manual_seed(24))
    enc = enc.to(dev).eval()
    batch = next(iter(DataPipeline(MESH_BATCH, img, base_path=spec["mdn_cat"],
                                   data_path="train/good").train_batches()))
    feats = make_feature_extractor(enc, 0, *default_norm_stats())(
        torch.from_numpy(batch.images).to(dev)).clone()
    valid = torch.from_numpy(batch.valid).to(device=dev, dtype=torch.float32)
    del enc
    head = lambda: GaussianMDN(feats.shape[-1], k, dtypes=DtypePolicy(),
                               generator=torch.Generator().manual_seed(24)).to(dev)
    full = head()
    ref = masked_mdn_loss(full, feats, valid, torch.Generator(device=dev).manual_seed(24))
    ref.backward()
    want = {n: p.grad.detach().cpu() for n, p in full.named_parameters()}
    del full
    shard = mc.shard_params(head())
    rows = mc.rows(MESH_BATCH // mc.data_size)
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = masked_mdn_loss(shard, feats[rows], valid[rows],
                           torch.Generator(device=dev).manual_seed(24), mc)
    loss.backward()
    mc.sum_gradients(shard.parameters())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    grads = GaussianMDN(shard.features, shard.num_gaussians, dtypes=DtypePolicy())
    with torch.no_grad():
        for name, p in shard.named_parameters():
            grads.get_parameter(name).copy_(p.grad)
    grads.place(mc, shard.components, k)
    got = gather_mdn_state(grads)
    return {"loss": float(mc.data_sum(loss.detach())), "loss_ref": float(ref.detach()),
            "grad_rel": _max_rel(got, want), "components": shard.num_gaussians,
            "launches": launches, "step_ms": step_ms,
            "wgmma": [cgmm.fwd_wgmma_launches, cgmm.bwd_wgmma_params_launches],
            "routes": [cgmm.last_fwd_route, dict(cgmm.last_bwd_routes)]}


def _gradients(module, mc) -> dict:
    """The gradients of `module`'s parameters that have one, on the CPU,
    summed over the data axis and in the full layout (`host_snapshot`): each
    parameter holds its gradient while the snapshot is taken."""
    import torch
    from vit_ad_tpu_torch.parallel.multihost import host_snapshot

    params = {n: p for n, p in module.named_parameters() if p.grad is not None}
    if mc is not None:
        mc.sum_gradients(params.values())
    kept = {n: p.detach().clone() for n, p in params.items()}
    with torch.no_grad():
        for p in params.values():
            p.copy_(p.grad)
    grads = {n: v for n, v in host_snapshot(module).items() if n in params}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(kept[n])
    module.zero_grad(set_to_none=True)
    return grads


def _resnet_steps(spec: dict, mc) -> dict:
    """(b): the ResNet-50 joint step at K=MESH_RESNET_K (the trainer's seeded
    heads and stage norms, seeded images and noise), on the mesh of `mc` or
    (None) in one process: the first step's gradients of the heads and the
    stage norms (before any update), then losses, step ms, launches and peak
    memory of the steps, the state of what trains (full layout) on the CPU."""
    import torch
    from vit_ad_tpu_torch.config import DtypePolicy
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.models.mdn import GaussianMDN
    from vit_ad_tpu_torch.models.resnet import STAGE_CHANNELS, ResNetEncoder
    from vit_ad_tpu_torch.parallel.multihost import host_snapshot
    from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
    from vit_ad_tpu_torch.pipeline.train import (
        RESNET_MDN_STAGES,
        mdn_resnet_loss,
        mdn_resnet_train_step,
    )

    dev, img, k = torch.device(spec["device"]), spec["img"], spec["resnet_k"]
    encoder = ResNetEncoder(img, DtypePolicy(), generator=torch.Generator().manual_seed(24))
    encoder = encoder.to(dev).eval()
    with torch.device(dev):
        init = torch.Generator(device=dev).manual_seed(24)
        heads = torch.nn.ModuleList(GaussianMDN(STAGE_CHANNELS[i], k, dtypes=DtypePolicy(),
                                                generator=init) for i in RESNET_MDN_STAGES)
    if mc is not None:
        heads = mc.shard_params(heads)
    trainable = torch.nn.ModuleDict({"heads": heads, "norms": encoder.norms})
    opt = torch_adam(trainable.parameters(), MESH_RESNET_LR, 1e-4)
    noise = torch.Generator(device=dev).manual_seed(24)
    images = torch.from_numpy(_mesh_images(MESH_RESNET_BATCH, img, 7)).to(dev)
    valid = torch.ones(MESH_RESNET_BATCH, device=dev)
    if mc is not None:
        images, valid = mc.shard_batch(images, valid)
    mean, std = (torch.as_tensor(a, device=dev) for a in default_norm_stats())
    init = host_snapshot(trainable) if mc is None else None
    # the first step's gradients, from a copy of its noise generator
    mdn_resnet_loss(encoder, heads, images, valid, torch.Generator(device=dev).manual_seed(24),
                    mean, std, RESNET_MDN_STAGES, mc).backward()
    grads = _gradients(trainable, mc)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, ms = [], []
    for _ in range(MESH_RESNET_STEPS):
        t0 = time.perf_counter()
        loss = mdn_resnet_train_step(encoder, heads, opt, images, valid, noise, mean, std,
                                     RESNET_MDN_STAGES, mc)
        losses.append(float(loss if mc is None else mc.data_sum(loss)))
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    launches = read_launches()
    state = host_snapshot(trainable)
    return {"losses": losses, "step_ms": ms, "launches": launches, "peak_gib": peak,
            "state": state, "init": init, "grads": grads,
            "components": [h.num_gaussians for h in heads]}


def _recon_steps(spec: dict, mc) -> dict:
    """(c): ae_cnn end to end (its BatchNorms in training), f32, seeded init
    and images, on the mesh of `mc` or (None) in one process: the losses and
    the state after the steps."""
    import torch
    from vit_ad_tpu_torch.config import DtypePolicy
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.models.autoencoder import VanillaAutoEncoder
    from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
    from vit_ad_tpu_torch.pipeline.train import recon_train_step

    dev, img = torch.device(spec["device"]), spec["img"]
    model = VanillaAutoEncoder(img, DtypePolicy.f32(),
                               generator=torch.Generator().manual_seed(24)).to(dev)
    if mc is not None:
        model = mc.shard_params(model)
    opt = torch_adam(model.parameters(), MESH_RECON_LR, 1e-4)
    images = torch.from_numpy(_mesh_images(MESH_RECON_BATCH, img, 8)).to(dev)
    valid = torch.ones(MESH_RECON_BATCH, device=dev)
    if mc is not None:
        images, valid = mc.shard_batch(images, valid)
    mean, std = (torch.as_tensor(a, device=dev) for a in default_norm_stats())
    model.train()
    init = {n: v.detach().cpu().clone() for n, v in model.state_dict().items()}
    losses = []
    for _ in range(MESH_RECON_STEPS):
        loss = recon_train_step(model, opt, images, valid, None, mean, std, mc=mc)
        losses.append(float(loss if mc is None else mc.data_sum(loss)))
    return {"losses": losses, "init": init,
            "state": {n: v.detach().cpu() for n, v in model.state_dict().items()}}


def mesh_rank(spec_path: str) -> int:
    """One rank of the mesh phase (`python3 chip_smoke.py --mesh-rank
    <spec.json>`, in a cluster the environment names): runs (a) to (g),
    compares (b) and (c) with the same steps in one process on rank 0, and
    writes what it saw to <out>/rank<r>.json."""
    import importlib

    import torch
    import torch.distributed as dist
    from vit_ad_tpu_torch import registry
    from vit_ad_tpu_torch.cli import score as score_cli
    from vit_ad_tpu_torch.cli import train_mdn as train_cli
    from vit_ad_tpu_torch.config import HyperParams, MeshConfig, set_numerics_policy
    from vit_ad_tpu_torch.ops.cuda import build
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm
    from vit_ad_tpu_torch.parallel.context import MeshContext
    from vit_ad_tpu_torch.parallel.multihost import barrier, maybe_initialize_distributed

    with open(spec_path) as f:
        spec = json.load(f)
    if spec.get("enc_deit"):  # a dry run's small trunk
        mod, attr = spec["enc_deit"].split(":")
        registry._BUILDERS["enc_deit"] = getattr(importlib.import_module(mod), attr)
    set_numerics_policy()
    dev = spec["device"]
    if dev == "cuda":
        build.load_library()
    maybe_initialize_distributed()
    rank = dist.get_rank()
    mesh = lambda d, m: MeshContext.from_hp(HyperParams(mesh=MeshConfig(d, m)), devices=dev)
    out = {"rank": rank}

    # (a) the MDN CLI on 1x2, then its first step through the API
    argv = ["-d", spec["mdn_cat"], "-t", "train/good", "-v", "test", "-n", str(spec["k"]),
            "-e", str(MESH_EPOCHS), "-p", str(MESH_EPOCHS), "-b", str(MESH_BATCH), "-i",
            str(spec["img"]), "--device", dev, "--out", spec["mdn_out"], "--mesh", "1x2"]
    rc, launches, wall = _launches_of(lambda: train_cli.main(argv))
    m12 = mesh(1, 2)
    out["backend"] = m12.mesh.backend
    out["a"] = {"rc": rc, "launches": launches, "wall": wall,
                "wgmma": [cgmm.fwd_wgmma_launches, cgmm.bwd_wgmma_params_launches],
                "routes": [cgmm.last_fwd_route, dict(cgmm.last_bwd_routes)]}
    out["a_step"] = _mdn_first_step(spec, m12)
    if dev == "cuda":
        torch.cuda.empty_cache()

    # (b) ResNet-50 + two MDN heads on 1x2, then the same steps in one process
    got = _resnet_steps(spec, m12)
    state, grads = got.pop("state"), got.pop("grads")
    out["b"] = got
    if rank == 0:
        if dev == "cuda":
            torch.cuda.empty_cache()
        want = _resnet_steps(spec, None)
        norms = [n for n in want["state"] if n.startswith("norms.")]
        pick = lambda d, prefix: {n: v for n, v in d.items() if n.startswith(prefix)}
        out["b_single"] = {"losses": want["losses"], "step_ms": want["step_ms"],
                           "peak_gib": want["peak_gib"], "launches": want["launches"],
                           "grad_rel": {part: _max_rel(pick(grads, part),
                                                       pick(want["grads"], part))
                                        for part in ("heads.", "norms.")},
                           "grad_names": sorted(grads) == sorted(want["grads"]),
                           "param_rel": _moved_rel(state, want["state"], want["init"]),
                           "norms_rel": _moved_rel(*({n: d[n] for n in norms}
                                                     for d in (state, want["state"],
                                                               want["init"])))}
        del want
    del state, grads
    barrier()
    if dev == "cuda":
        torch.cuda.empty_cache()

    # (c) ae_cnn on 2x1 (global BatchNorm), then the same steps in one process
    got = _recon_steps(spec, mesh(2, 1))
    out["c"] = {"losses": got["losses"]}
    if rank == 0:
        want = _recon_steps(spec, None)
        out["c_single"] = {"losses": want["losses"],
                           "param_rel": _moved_rel(got["state"], want["state"], want["init"])}
    barrier()

    # (d) DeiT-base NF scoring through cli.score --mesh 2
    argv = ["--pth", spec["nf_pth"], "-a", "nf", "-m", "enc_deit", "-E", spec["deit_pth"],
            "-d", spec["img_dir"], "-b", str(MESH_SCORE_BATCH), "-i", str(spec["img"]),
            "--device", dev, "--mesh", "2", "-o", spec["score_out"]]
    rc, launches, wall = _launches_of(lambda: score_cli.main(argv))
    out["d"] = {"rc": rc, "launches": launches, "wall": wall}
    if dev == "cuda":
        torch.cuda.empty_cache()

    # (e)-(g) DeiT-base, EsViT Swin-T and NesT-T sharded on 1x2
    out["tp"] = _sharded_trunks(spec, m12, rank)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    barrier()
    return 0


def mesh_main_path(tmp: str, mdn_cat: str, nf_pth: str, deit_pth: str, img: int = 224,
                   device: str = "cuda", k: int = MESH_K, resnet_k: int = MESH_RESNET_K,
                   enc_deit: str = "", tp_batch: int = MESH_TP_BATCH) -> dict:
    """Phase 15: the mesh on the one card. On the card B2, B3 and B4 are
    first held against their plain versions at the phase's shard shapes,
    and B1, B5 and the GEMM steps at the trunk shards' (`tp_kernel_checks`).
    One process then runs (a)'s and (d)'s commands without --mesh; two ranks
    of an explicit cluster, both on card 0, then run (a) to (g)
    (`mesh_rank`); their results are held against the single-process ones.
    `img`, `device`, `k`, `resnet_k`, `enc_deit` ("module:builder" of a
    small DeiT) and `tp_batch` let the phase run small on the CPU (a dry run
    of its checks; the kernel checks are left out and the launch counts stay
    0)."""
    import glob
    import subprocess

    import numpy as np
    import torch
    from vit_ad_tpu_torch.cli import score as score_cli
    from vit_ad_tpu_torch.cli import train_mdn as train_cli
    from vit_ad_tpu_torch.models.mdn import GaussianMDN
    from vit_ad_tpu_torch.parallel.launch import cluster_env, free_port

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    if on_card:
        gen, dev = torch.Generator(device="cuda").manual_seed(15), torch.device("cuda")
        for case in MESH_GMM_FWD_CASES:
            check_gmm_forward(*case, gen, dev)
        for case in MESH_GMM_BWD_CASES:
            check_gmm_backward(*case, gen, dev)
        torch.cuda.empty_cache()
        tp_nums = tp_kernel_checks(card_line(), gen)
    img_dir = os.path.join(tmp, "mesh_images")
    _write_images(img_dir, 0, MESH_SCORE_IMAGES, img)
    single_run, mesh_run = os.path.join(tmp, "mesh_single"), os.path.join(tmp, "mesh_mdn")
    argv = ["-d", mdn_cat, "-t", "train/good", "-v", "test", "-n", str(k), "-e",
            str(MESH_EPOCHS), "-p", str(MESH_EPOCHS), "-b", str(MESH_BATCH), "-i", str(img),
            "--device", device]
    rc, single_launches, single_wall = _launches_of(
        lambda: train_cli.main([*argv, "--out", single_run]))
    if rc != 0:
        raise AssertionError(f"the single-process MDN run failed: rc {rc}")
    single_scores_dir = os.path.join(tmp, "mesh_single_scores")
    rc = score_cli.main(["--pth", nf_pth, "-a", "nf", "-m", "enc_deit", "-E", deit_pth, "-d",
                         img_dir, "-b", str(MESH_SCORE_BATCH), "-i", str(img), "--device",
                         device, "-o", single_scores_dir])
    if rc != 0:
        raise AssertionError(f"the single-process NF scoring failed: rc {rc}")

    # (h) a bare --mesh on this one-card host
    if on_card:
        try:
            train_cli.main([*argv, "--mesh", "2x1", "--out", os.path.join(tmp, "mesh_refused")])
        except SystemExit as e:
            message = str(e.code)
        else:
            raise AssertionError("--mesh 2x1 on a one-card host did not refuse")
        want = (f"--mesh 2x1 needs 2 cards, one a rank; torch.cuda.device_count() is "
                f"{torch.cuda.device_count()}")
        print(f"(h) cli.train_mdn --mesh 2x1 without a cluster: {message!r}")
        if message != want:
            raise AssertionError(f"(h) expected {want!r}")

    # (a) to (g) on two ranks sharing the card
    out = os.path.join(tmp, "mesh_ranks")
    os.makedirs(out)
    spec = {"out": out, "img": img, "device": device, "k": k, "resnet_k": resnet_k,
            "mdn_cat": mdn_cat, "mdn_out": mesh_run, "nf_pth": nf_pth, "deit_pth": deit_pth,
            "img_dir": img_dir, "score_out": os.path.join(tmp, "mesh_scores"),
            "enc_deit": enc_deit, "tp_batch": tp_batch}
    spec_path = os.path.join(out, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    if on_card:
        torch.cuda.empty_cache()
    coordinator = f"127.0.0.1:{free_port()}"
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in range(2):
        env = {**os.environ, **cluster_env(coordinator, 2, r),
               "CUDA_VISIBLE_DEVICES": "0" if on_card else ""}
        logs.append(open(os.path.join(out, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", spec_path], env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=logs[-1],
            stderr=subprocess.STDOUT))
    try:
        codes = [p.wait(timeout=MESH_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks_wall = time.perf_counter() - t0
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.log")) as f:
            text = f.read()
        print(f"--- rank {r} (exit {codes[r]}), the end of its output:\n{text[-1500:]}")
    if codes != [0, 0]:
        raise AssertionError(f"the mesh ranks exited with {codes}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    card = ""
    if on_card:
        card = card_line()
    print(f"two ranks on {'card 0' if on_card else 'the CPU'} in {ranks_wall:.2f} s; device "
          f"collectives over {ranks[0]['backend']}")
    if ranks[0]["backend"] != "gloo":
        raise AssertionError("ranks sharing a card must take gloo")

    # (a) against one process
    with open(os.path.join(single_run, "history.json")) as f:
        want = json.load(f)
    with open(os.path.join(mesh_run, "history.json")) as f:
        got = json.load(f)
    first = abs(got["train_loss"][0] - want["train_loss"][0]) / abs(want["train_loss"][0])
    hist = max(abs(g - w) / abs(w) for key in ("train_loss", "valid_loss")
               for g, w in zip(got[key], want[key]))
    metric = max(abs(got["metrics"][m] - v) for m, v in want["metrics"].items())
    print(f"(a) cli.train_mdn --mesh 1x2 (K={k}, batch {MESH_BATCH}, {MESH_EPOCHS} epochs, the "
          f"trunk sharded): first-step loss {got['train_loss'][0]} vs {want['train_loss'][0]} "
          f"(rel {first:.3e}, rtol {MESH_TP_LOSS_RTOL:.0e}); histories max rel {hist:.3e} (rtol "
          f"{MESH_TP_HIST_RTOL:.0e}); metrics max abs {metric:.3e} (atol "
          f"{MESH_TP_METRIC_ATOL:.0e}): {got['metrics']} vs {want['metrics']}")
    for r in ranks:
        a, step = r["a"], r["a_step"]
        print(f"(a) rank {r['rank']}: rc {a['rc']}, CLI launches {a['launches']} in "
              f"{a['wall']:.2f} s, B2 / B3 through wgmma {a['wgmma']}, routes {a['routes']}; "
              f"the API step on {step['components']} of {k} components: loss {step['loss']} vs "
              f"{step['loss_ref']}, head gradients max rel {step['grad_rel']:.3e} (tol "
              f"{MESH_GRAD_RTOL:.0e}), launches {step['launches']}, B2 / B3 through wgmma "
              f"{step['wgmma']}, {step['step_ms']:.2f} ms on the shared card (information)")
        if a["rc"] != 0 or step["components"] != k // 2 or \
                not step["grad_rel"] <= MESH_GRAD_RTOL or \
                not abs(step["loss"] - step["loss_ref"]) <= MESH_LOSS_RTOL * abs(step["loss_ref"]):
            raise AssertionError(f"(a) rank {r['rank']} disagrees with one process")
        if on_card and (step["launches"]["B2"] != 1 or step["wgmma"][0] != 1
                        or step["launches"]["B3"] != step["wgmma"][1]
                        or step["launches"]["B3"] < 2 or a["launches"]["B2"] == 0
                        or a["wgmma"][0] != a["launches"]["B2"]
                        or a["wgmma"][1] != a["launches"]["B3"]):
            raise AssertionError(f"(a) rank {r['rank']}: B2 and B3 did not launch on the "
                                 "shard through their wgmma kernels")
        # the sharded DeiT-base trunk, per encoder batch: B1 12, B7 25, the
        # GEMM step 36, B6 never
        n_enc = a["launches"]["B1"] // 12
        if on_card and (n_enc == 0 or a["launches"]["B1"] != 12 * n_enc
                        or a["launches"]["B6"] != 0 or a["launches"]["B7"] != 25 * n_enc
                        or a["launches"]["GEMM"] != 36 * n_enc):
            raise AssertionError(f"(a) rank {r['rank']}: the trunk did not run sharded "
                                 f"({a['launches']})")
    if not (first <= MESH_TP_LOSS_RTOL and hist <= MESH_TP_HIST_RTOL
            and metric <= MESH_TP_METRIC_ATOL):
        raise AssertionError("(a) the mesh run disagrees with one process")
    (pth,) = glob.glob(os.path.join(mesh_run, f"{k}_gaussians_enc_deit_*.pth"))
    state = torch.load(pth)
    GaussianMDN(state["pi.weight"].shape[1], k).load_state_dict(state, strict=True)
    (single_pth,) = glob.glob(os.path.join(single_run, f"{k}_gaussians_enc_deit_*.pth"))
    scored = {}
    for what, p in (("mesh", pth), ("single", single_pth)):
        d = os.path.join(tmp, f"mesh_{what}_pth_scores")
        if score_cli.main(["--pth", p, "-a", "mdn", "-m", "enc_deit", "-d",
                           os.path.join(mdn_cat, "test"), "-b", str(MESH_BATCH), "-i",
                           str(img), "--device", device, "-o", d]) != 0:
            raise AssertionError(f"scoring the {what} run's file failed")
        scored[what] = np.array(list(_scores_of(d).values()))
    rel = np.abs(scored["mesh"] - scored["single"]) / np.abs(scored["single"])
    print(f"(a) the mesh run's .pth strict-loads as a K={k} head; cli.score --pth on it vs on "
          f"the single run's: max rel {rel.max():.3e} (rtol {MESH_TP_SCORE_RTOL:.0e})")
    if not rel.max() <= MESH_TP_SCORE_RTOL:
        raise AssertionError("(a) the mesh run's head scores unlike the single run's")

    # (b) ResNet-50 + MDN K=100 on 1x2
    single = ranks[0]["b_single"]
    for r in ranks:
        b = r["b"]
        print(f"(b) rank {r['rank']}: heads of {b['components']} of {resnet_k} components, "
              f"losses {b['losses']}, launches {b['launches']}, peak "
              f"{b['peak_gib']:.2f} GiB, step ms {[round(x, 2) for x in b['step_ms']]} on the "
              f"shared card (information)")
        if on_card and (b["launches"]["B4"] == 0 or b["launches"]["B2"] == 0
                        or b["launches"]["B3"] == 0):
            raise AssertionError(f"(b) rank {r['rank']}: B2, B3 or B4 did not launch on the "
                                 "shards")
        if b["components"] != [resnet_k // 2] * 2:
            raise AssertionError("(b) the heads are not split over the model axis")
    loss_rel = max(abs(g - w) / abs(w) for g, w in zip(ranks[0]["b"]["losses"],
                                                       single["losses"]))
    grad_rel = single["grad_rel"]
    print(f"(b) one process: losses {single['losses']}, launches {single['launches']}, peak "
          f"{single['peak_gib']:.2f} GiB, step ms {[round(x, 2) for x in single['step_ms']]}; "
          f"mesh vs one process: the first step's gradients (before the update), max "
          f"|mesh - single| / max |single| of a tensor: heads {grad_rel['heads.']:.3e}, stage "
          f"norms {grad_rel['norms.']:.3e} (tol {MESH_GRAD_RTOL:.0e}); losses max rel "
          f"{loss_rel:.3e} (rtol {MESH_STEP_LOSS_RTOL:.0e}), parameters after "
          f"{MESH_RESNET_STEPS} steps: |mesh - single| / |single - init| "
          f"{single['param_rel']:.3e}, of the stage norms {single['norms_rel']:.3e} (tol "
          f"{MESH_STEP_PARAM_RTOL:.0e})")
    if not (single["grad_names"] and max(grad_rel.values()) <= MESH_GRAD_RTOL
            and loss_rel <= MESH_STEP_LOSS_RTOL and single["param_rel"] <= MESH_STEP_PARAM_RTOL
            and single["norms_rel"] <= MESH_STEP_PARAM_RTOL):
        raise AssertionError("(b) the ResNet mesh steps disagree with one process")

    # (c) ae_cnn on 2x1
    c, cs = ranks[0]["c"], ranks[0]["c_single"]
    loss_rel = max(abs(g - w) / abs(w) for g, w in zip(c["losses"], cs["losses"]))
    print(f"(c) ae_cnn {MESH_RECON_STEPS} steps on 2x1 at batch {MESH_RECON_BATCH} (f32): losses "
          f"{c['losses']} vs one process {cs['losses']} (max rel {loss_rel:.3e}, rtol "
          f"{MESH_STEP_LOSS_RTOL:.0e}); parameters and running statistics |mesh - single| / "
          f"|single - init| {cs['param_rel']:.3e} (tol {MESH_STEP_PARAM_RTOL:.0e})")
    if c["losses"] != ranks[1]["c"]["losses"] or not (
            loss_rel <= MESH_STEP_LOSS_RTOL and cs["param_rel"] <= MESH_STEP_PARAM_RTOL):
        raise AssertionError("(c) the recon mesh steps disagree with one process")

    # (d) cli.score --mesh 2
    files = score_cli.list_images(img_dir)
    got = _scores_of(spec["score_out"])
    want = _scores_of(single_scores_dir)
    rel = np.abs(np.array([got[p] for p in files]) - np.array([want[p] for p in files])) / \
        np.abs(np.array([want[p] for p in files]))
    half = MESH_SCORE_BATCH // 2
    for r in ranks:
        print(f"(d) rank {r['rank']}: rc {r['d']['rc']}, launches {r['d']['launches']} "
              f"({half} rows a rank) in {r['d']['wall']:.2f} s")
    print(f"(d) cli.score --mesh 2 at batch {MESH_SCORE_BATCH}: {len(got)} rows vs one "
          f"process: max rel {rel.max():.3e} (rtol {MESH_SCORE_RTOL:.0e}); rank 0's rows "
          f"0-{half - 1} max rel {rel[:half].max():.3e}, rank 1's rows {half}-{len(files) - 1} "
          f"max rel {rel[half:].max():.3e}")
    if len(files) != MESH_SCORE_IMAGES or list(got) != files or \
            not rel.max() <= MESH_SCORE_RTOL or any(r["d"]["rc"] != 0 for r in ranks):
        raise AssertionError("(d) mesh scoring disagrees with one process")
    if on_card:
        if any(r["d"]["launches"]["B1"] != 12 or r["d"]["launches"]["B6"] != 12
               or r["d"]["launches"]["B7"] != DEIT_B7_PER_BATCH for r in ranks):
            raise AssertionError("(d) a rank did not run its half batch through B1, B6, B7")
        print(card)
    # (e)-(g) the trunks sharded on 1x2 against the whole trunk
    for part, key, what, per_batch, routes in MESH_TP_TRUNKS:
        got = [r["tp"][part] for r in ranks]
        for r, g in zip(ranks, got):
            print(f"({part}) {what} B={tp_batch} bf16 sharded on 1x2, rank {r['rank']}: launches "
                  f"{g['launches']}, GEMM steps by epilogue {g['routes']}, {g['ms']:.2f} ms on "
                  f"the shared card (gloo sums; information)")
        print(f"({part}) {what}: features {got[0]['shape']}, max|shard - whole| / max|whole| "
              f"{got[0]['rel']:.3e} (rtol {MESH_TP_FEATURE_RTOL:.0e}); the two ranks' features "
              f"{'equal' if got[0]['digest'] == got[1]['digest'] else 'DIFFER'} to the bit; "
              f"each rank holds {got[0]['shard_rows']} rows of {MESH_TP_SHARD[key][0]}")
        if on_card and any(g["shard_rows"] != MESH_TP_SHARD[key][1] for g in got):
            raise AssertionError(f"({part}) the {what} trunk is not split over the ranks")
        expect = {**NO_LAUNCHES, **per_batch}
        if got[0]["digest"] != got[1]["digest"] or not all(g["finite"] for g in got) or \
                not got[0]["rel"] <= MESH_TP_FEATURE_RTOL:
            raise AssertionError(f"({part}) the sharded {what} disagrees with the whole trunk")
        if on_card and any(g["launches"] != expect or g["routes"] != routes for g in got):
            raise AssertionError(f"({part}) the sharded {what} did not launch {expect}, GEMM "
                                 f"steps {routes}")
    total = dict(NO_LAUNCHES)
    for r in ranks:
        for part in (r["a"]["launches"], r["a_step"]["launches"], r["b"]["launches"],
                     r["d"]["launches"], *(t["launches"] for t in r["tp"].values())):
            _add(total, part)
    wall = time.perf_counter() - t_phase
    print(f"phase launches (both ranks) {total}; single-process launches of (a) "
          f"{single_launches} in {single_wall:.2f} s; phase wall {wall:.2f} s")
    return {"launches": total, **(tp_nums if on_card else {})}


# the levers phase: the JAX package's opt-in model levers, each read from the
# environment at call time, A/B'd on the models of the earlier phases at
# B=128 (B=32 for the NF-ResNet step). Launches of one encoder batch with
# each lever off and on (`NO_LAUNCHES` elsewhere): the EsViT trunk with its
# fused LayerNorm (B5 12, B7 29 off; the split route B5a 12 for B5; the fold
# B7 5: patch norm, 3 merge norms, final norm), DeiT-base with the fused MLP
# (B1 12, B6 12, B7 13 off; the fold B7 1: the final norm; B6 takes norm2)
ESVIT_OFF = {**NO_LAUNCHES, "B5": ESVIT_B5_PER_BATCH, "B7": ESVIT_B7_PER_BATCH}
DEIT_OFF = {**NO_LAUNCHES, "B1": 12, "B6": 12, "B7": DEIT_B7_PER_BATCH}
# B5a on its model path, the split route: the four Swin-T stages of a B=128
# batch as the blocks call it, q, k, v strided views of the packed qkv and
# the bias gathered beforehand (`SWIN_STAGES`)
# reversible against autodiff gradients, |difference| / |autodiff| per tensor
# (Frobenius norms): the f32 roundoff of the inverse, which the stage norms'
# gradients (sums over every position, with cancellation) carry furthest;
# at 224 px on the CPU 3.7e-5 (their max entry 8.2e-4 of the largest)
REVERSIBLE_GRAD_RTOL = 1e-3


def under(var: str, value, fn):
    """`fn` wrapped so that each call runs with the environment variable
    `var` set to `value` (or unset for None), restored after."""
    def call():
        old = os.environ.get(var)
        if value is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = value
        try:
            return fn()
        finally:
            if old is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = old
    return call


def lever_ab(name: str, var: str, value: str, m, images, card: str, expect: dict,
             alone=None) -> dict:
    """Scoring of the RunModels `m` (trunk + NF-20) on the B=128 uint8 batch
    with `var=value` off and on: the launches of one batch each way against
    `expect` ({False: ..., True: ...}), the scores' drift, and the times of
    uint8→scores and of `alone` (what the lever changes, on its own), order
    off, on, on, off, median of 10 by events each."""
    import torch
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa
    from vit_ad_tpu_torch.pipeline.eval import make_nf_batch_fn

    mean, std = (torch.as_tensor(a, device=images.device) for a in default_norm_stats())
    batch_fn = make_nf_batch_fn(*m.parts, m.hp, mean, std)

    def scores():
        with torch.inference_mode():
            return batch_fn(images).amax(dim=(1, 2))

    out, launched, one_pass = {}, {}, {}
    for on in (False, True):
        reset_launches()
        out[on] = under(var, value if on else None, scores)()
        torch.cuda.synchronize()
        launched[on] = read_launches()
        one_pass[on] = wa.window_one_pass_launches + wa.split_one_pass_launches
        if out[on].shape != (FLAGSHIP_BATCH,) or not torch.isfinite(out[on]).all():
            raise AssertionError(f"{name} {var}={value if on else 'unset'}: non-finite or "
                                 f"misshapen scores")
    diff, top = (out[True] - out[False]).abs().max().item(), out[False].abs().max().item()
    drift = diff / top if top > 0 else diff
    print(f"{name} {var}={value}: launches of one B={FLAGSHIP_BATCH} batch off {launched[False]}, "
          f"on {launched[True]} (expected {expect}); window attentions through the one-pass "
          f"kernel off {one_pass[False]}, on {one_pass[True]}; scores on vs off max |diff| "
          f"{diff:.3e}, {drift:.3e} of the largest score {top:.6g}")
    if launched != expect:
        raise AssertionError(f"{name} {var}={value}: launches {launched}, expected {expect}")
    if one_pass[True] != launched[True]["B5"] + launched[True]["B5a"]:
        raise AssertionError(f"{name}: a window attention left the one-pass kernel")
    times = {}
    for what, fn in (("uint8→scores", scores),) + ((alone,) if alone else ()):
        side = {on: under(var, value if on else None, fn) for on in (False, True)}
        off = [median_ms(side[False], torch, runs=10)]
        on = [median_ms(side[True], torch, runs=10), median_ms(side[True], torch, runs=10)]
        off.append(median_ms(side[False], torch, runs=10))
        rate = lambda ms: FLAGSHIP_BATCH / statistics.mean(ms) * 1e3
        change = 100 * (statistics.mean(on) / statistics.mean(off) - 1)
        print(f"[{card}] {name} {what} B={FLAGSHIP_BATCH} bf16, batch on the device: {var} "
              f"unset {off} ms = {rate(off):.1f} img/s, ={value} {on} ms = {rate(on):.1f} img/s "
              f"(order off, on, on, off; {change:+.2f}%)")
        times[what] = {"off": off, "on": on}
    return {"launches": {k: launched[False][k] + launched[True][k] for k in launched[True]},
            "drift": drift, "times": times}


def split_path_times(card: str, gen) -> list:
    """B5a as the split route calls it, at the four Swin-T stages of a B=128
    batch: q, k, v strided views of the packed qkv, the gathered bias and
    the shift mask passed in; against its plain version, then by events
    beside SDPA with the additive mask and the bound (B5's bytes: q, k, v,
    the output, the bias, the mask)."""
    import torch
    from vit_ad_tpu_torch.ops import window_attention as wops
    from vit_ad_tpu_torch.ops.cuda import window_attention as wa

    dev, bf16, per_stage = torch.device("cuda"), torch.bfloat16, []
    for stage, windows, side, c, heads, n_w in SWIN_STAGES:
        case = (windows, side, c, heads, windows // n_w if n_w else 0, 0)
        qkv3, table, mask = window_inputs(case, bf16, gen, dev)
        n, hd = side * side, c // heads
        bias = wops.gather_bias(table, torch.from_numpy(
            wops.relative_position_index(side, side)).to(dev))
        q, k, v = qkv3.reshape(windows, n, 3, heads, hd).unbind(2)  # as models/swin.py
        kern = lambda: wa.window_attention(q, k, v, table, heads, (side, side), mask, bias=bias)
        plain = lambda: wops.window_attention_core_reference(q, k, v, bias, mask)
        additive = (bias[None] if mask is None else bias[None] + mask[:, None]).to(bf16)
        with torch.no_grad():
            before = (wa.window_launches, wa.split_launches)
            before_one_pass = wa.window_one_pass_launches + wa.split_one_pass_launches
            got = kern()
            shape = (f"{stage} [{windows},{n},{heads},{hd}] x3 strided, "
                     f"mask={'none' if mask is None else n_w}")
            err = report_window_check(got, plain(), before, before_one_pass, True, "bfloat16",
                                      f"on the split route, {shape}")
            kern_ms, plain_ms = alternate(kern, plain, TIMED_RUNS, 3)
            lib_ms, lib_both, _ = sdpa_ms(*(t.transpose(1, 2) for t in (q, k, v)), additive,
                                          torch)
        nums = {"shape": shape, "max_abs_err": err, "ms": statistics.mean(kern_ms),
                "plain_ms": statistics.mean(plain_ms), "library_ms": lib_ms,
                **bound(tensor_bytes(q, k, v, got, bias, mask), 4 * windows * heads * n * n * hd)}
        per_stage.append(nums)
        print(f"[{card}] window_attention (B5a) on the split route {shape} bf16: kernel "
              f"{kern_ms} ms (q, k, v copies included), plain {plain_ms} ms (order plain, "
              f"kernel, kernel, plain), SDPA with additive mask (broadcast, expanded) {lib_both} "
              f"ms, bound {nums['bound_ms']:.4f} ms by {nums['bound_by']}")
        del qkv3, q, k, v, got
    return per_stage


def reversible_ab(encoder, flows, batch, images, card: str) -> None:
    """`VITAD_NF_REVERSIBLE=1` on the NF-ResNet joint step at B=32 (ResNet-50
    bf16, three NF-20 flows f32, the stage norms, Adam) on the uint8 `batch`
    (images the flows were trained on): the first step's loss and gradients
    against autodiff from the same weights, checked, and the same on the
    first 32 of `images` (other images: the inverse's conditioning,
    information only); then the step ms (order off, on, on, off) and its
    peak memory above what is held before each side."""
    import torch
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
    from vit_ad_tpu_torch.pipeline.train import nf_resnet_loss, nf_resnet_train_step

    dev, var = torch.device("cuda"), "VITAD_NF_REVERSIBLE"
    flows.train()
    mean, std = (torch.as_tensor(a, device=dev) for a in default_norm_stats())
    valid = torch.ones(NFRES_BATCH, device=dev)
    trainable = torch.nn.ModuleDict({"flows": flows, "norms": encoder.norms})

    def grads(u8):
        trainable.zero_grad(set_to_none=True)
        loss = nf_resnet_loss(encoder, flows, u8, valid, mean, std)
        loss.backward()
        return loss.detach(), {k: p.grad.clone() for k, p in trainable.named_parameters()
                               if p.grad is not None}

    def against_autodiff(u8, what):
        (l_off, g_off), (l_on, g_on) = grads(u8), under(var, "1", lambda: grads(u8))()
        rel = {k: ((g_on[k] - g).norm() / g.norm()).item() for k, g in g_off.items()}
        worst = max(rel, key=rel.get)
        top = max(((g_on[k] - g).abs().max() / g.abs().max()).item() for k, g in g_off.items())
        again = grads(u8)[1]  # autodiff twice: the card's own spread
        floor = max(((again[k] - g).norm() / g.norm()).item() for k, g in g_off.items())
        print(f"NF-ResNet B={NFRES_BATCH} first step on {what}, {var}=1 against autodiff: loss "
              f"{l_on.item()} vs {l_off.item()} (equal: {bool(torch.equal(l_on, l_off))}), "
              f"{len(g_on)} gradients, |reversible - autodiff| / |autodiff| at most "
              f"{rel[worst]:.3e} ({worst}), max entry difference {top:.3e} of the tensor's "
              f"largest; autodiff against itself {floor:.3e}")
        return sorted(g_on) == sorted(g_off) and torch.equal(l_on, l_off), rel[worst]

    same, err = against_autodiff(batch, "training images of the flows")
    print(f"(tol {REVERSIBLE_GRAD_RTOL:.0e} on the training images)")
    if not same or not err <= REVERSIBLE_GRAD_RTOL:
        raise AssertionError(f"the reversible flow backward disagrees with autodiff: {err}")
    against_autodiff(images[:NFRES_BATCH], "other images (information)")
    trainable.zero_grad(set_to_none=True)
    opt = torch_adam(trainable.parameters(), 1e-3, 1e-5)
    step = lambda: nf_resnet_train_step(encoder, flows, opt, batch, valid, mean, std)
    ms, peak = {False: [], True: []}, {}
    for on in (False, True, True, False):
        fn = under(var, "1" if on else None, step)
        fn()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        ms[on].append(median_ms(fn, torch, runs=5, warmup=1))
        peak.setdefault(on, torch.cuda.max_memory_allocated() / 2**30 - held)
    print(f"[{card}] NF-ResNet joint train step B={NFRES_BATCH} (3 NF-20 flows + stage norms, "
          f"Adam): {var} unset {ms[False]} ms, peak {peak[False]:.2f} GiB above what is held; "
          f"=1 {ms[True]} ms, peak {peak[True]:.2f} GiB (order off, on, on, off; "
          f"{100 * (statistics.mean(ms[True]) / statistics.mean(ms[False]) - 1):+.2f}% time)")


def levers_main_path(nf_pth: str, deit_pth: str, esvit_pth: str, effnet_pth: str, nf_resnet,
                     nf_resnet_batch, images, card: str, gen) -> dict:
    """Phase 16: each lever A/B'd through the scoring path of its model (the
    NF heads `nf_pth` on DeiT-base `deit_pth`, `esvit_pth` on EsViT Swin-T,
    `effnet_pth` on EfficientNet-B4, built as `cli.score` builds them), B5a
    on the split route's stage shapes, and the reversible step of the
    NF-ResNet models `nf_resnet` (encoder, flows) on `nf_resnet_batch`, 32
    of their training images. Returns the launches and B5a's numbers."""
    import torch
    from vit_ad_tpu_torch.data.dataset import default_norm_stats
    from vit_ad_tpu_torch.data.loader import preprocess
    from vit_ad_tpu_torch.models.flow import patch_tokens_to_map
    from vit_ad_tpu_torch.pipeline.loading import build_pth_models

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    mean, std = (torch.as_tensor(a, device=dev) for a in default_norm_stats())
    total = dict(NO_LAUNCHES)

    def encoder_alone(m):
        def tokens():
            with torch.inference_mode():
                return m.parts[0](preprocess(images, mean, std)).patch_embedding
        return ("uint8→tokens, the trunk alone", tokens)

    def run(name, var, value, m, expect_on, off, alone):
        r = lever_ab(name, var, value, m, images, card, {False: off, True: expect_on}, alone)
        _add(total, r["launches"])
        return r

    m = build_pth_models(esvit_pth, "enc_esvit", "nf", device=dev)
    enc = encoder_alone(m)
    r = run("EsViT NF", "VITAD_SWIN_PARTITION", "gather", m, ESVIT_OFF, ESVIT_OFF, enc)
    if r["drift"] != 0.0:
        raise AssertionError(f"the gather partition moved the EsViT scores: {r['drift']}")
    run("EsViT NF", "VITAD_SWIN_PACKED", "0", m,
        {**ESVIT_OFF, "B5": 0, "B5a": ESVIT_B5_PER_BATCH}, ESVIT_OFF, enc)
    run("EsViT NF", "VITAD_SWIN_LN_FOLD", "1", m, {**ESVIT_OFF, "B7": 1 + 3 + 1}, ESVIT_OFF, enc)
    del m, enc
    m = build_pth_models(esvit_pth, "enc_esvit", "nf", device=dev, fused_ln=False)
    no_ln = {**ESVIT_OFF, "B7": 0}
    run("EsViT NF, fused LayerNorm off", "VITAD_BF16_LN", "1", m, no_ln, no_ln,
        encoder_alone(m))
    del m
    m = build_pth_models(nf_pth, "enc_deit", "nf", encoder_ckpt=deit_pth, device=dev)
    run("DeiT NF", "VITAD_VIT_LN_FOLD", "1", m, {**DEIT_OFF, "B7": 1}, DEIT_OFF, encoder_alone(m))
    with torch.inference_mode():
        feats = patch_tokens_to_map(m.parts[0](preprocess(images, mean, std)).patch_embedding)

    def flow_alone():
        with torch.inference_mode():
            return m.parts[1](feats).anomaly_score_map
    run("DeiT NF", "VITAD_FOLD_FLOW_PERMS", "1", m, DEIT_OFF, DEIT_OFF,
        ("NF-20 alone on the cached [128,14,14,768] tokens", flow_alone))
    del m, feats
    m = build_pth_models(effnet_pth, "enc_eff_net", "nf", device=dev)
    run("EfficientNet-B4 NF", "VITAD_EFFNET_HARDSWISH", "1", m, NO_LAUNCHES, NO_LAUNCHES,
        encoder_alone(m))
    del m
    torch.cuda.empty_cache()
    split = split_path_times(card, gen)
    torch.cuda.empty_cache()
    reversible_ab(*nf_resnet, nf_resnet_batch, images, card)
    torch.cuda.empty_cache()
    print(f"phase launches {total}; phase wall {time.perf_counter() - t_phase:.2f} s")
    return {"launches": total, "B5a": split}



# the parity phase: the port's quality-parity harness (`cli/parity_matrix.py`)
# gated at the tool's default tolerance, 0.5 pt of image AUROC; (c) runs these
# entries of its matrix with their own models on one synthetic MVTec category
# of phase 13's size, two epochs
PARITY_GATE, PARITY_METRICS = 0.005, ["image_auroc_score"]
PARITY_FULL = ("nf_mvtec_lastblock", "gmm_mvtec_100_gaussians")


def _head_batches(cat_dir: str, batch: int, img: int) -> tuple:
    """(train, validation, test) batches of a category as the sweep reads it."""
    from vit_ad_tpu_torch.data.loader import DataPipeline

    split = DataPipeline(batch, img, base_path=cat_dir, data_path="train/good")
    test = DataPipeline(batch, img, base_path=cat_dir, data_path="test", validation_mode=True)
    n = lambda files: -(-len(files) // batch)
    return n(split.train_files), n(split.valid_files), n(test.test_files)


def _gated(pm, rows, ours_csv: str, ref_rows, ref_csv: str, what: str) -> float:
    """`ours_csv` through the tool's gate against `ref_rows` written as a
    stand-in reference; raises unless it passes with no error row and the same
    categories; returns the largest |Δ image AUROC|."""
    pm._write_stand_in_reference(ref_rows, ref_csv, PARITY_METRICS)
    ok, lines = pm.compare_entry(ours_csv, ref_csv, PARITY_GATE, PARITY_METRICS)
    errors = [r for r in rows + ref_rows if "error" in r]
    same = [r["dataclass"] for r in rows] == [r["dataclass"] for r in ref_rows]
    delta = max(abs(a["image_auroc_score"] - b["image_auroc_score"])
                for a, b in zip(rows, ref_rows)) if same and not errors else float("inf")
    print(f"{what}: gate {'OK' if ok else 'FAIL'}; max |Δ image AUROC| {delta:.3e}")
    for line in lines:
        print("   " + line)
    if not ok or errors or not same:
        raise AssertionError(f"{what}: the parity gate failed, or a row holds an error: "
                             f"{errors or lines}")
    return delta


def parity_main_path(tmp: str, sweep_category_seconds: float = float("nan"), img: int = 224,
                     device: str = "cuda") -> dict:
    """Phase 17: the port's quality-parity harness (`cli/parity_matrix.py`).
    (a) `main(["--rehearse", ...])` on `device`: the six entries of the §6
    matrix on the rehearsal's models (enc_cnn, ae_cnn at 32 px, K=2), exit 0
    with six entries compared, each entry's seconds and launches (B2 and B3
    per MDN step through their wgmma kernels on the two gmm entries, nothing
    on the others); (b) the same six entries through `run_entry` under the
    f32 policy on `device` and on the CPU, on (a)'s folders, the card's
    results.csv gated against the CPU's rows as a stand-in reference, the
    largest |Δ image AUROC| of each; (c) `nf_mvtec_lastblock` and
    `gmm_mvtec_100_gaussians` with their own models (DeiT-base at `img` px,
    bf16, NF-20 and K=100, batch 64, two epochs) through the tool's real-data
    path on one synthetic MVTec category of phase 13's size: B1, B6, B7 per
    encoder batch and B2, B3 per MDN step through their redesigned routes, no
    row with an error, the stand-in gate, each entry's seconds beside phase
    13's per category (`sweep_category_seconds`). On the CPU (`img=32,
    device="cpu"`) a dry run of the checks; the launch counts then stay 0."""
    from vit_ad_tpu_torch.cli import parity_matrix as pm
    from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
    from vit_ad_tpu_torch.data.synthetic import make_mvtec_category
    from vit_ad_tpu_torch.ops.cuda import gmm as cgmm

    t_phase = time.perf_counter()
    total: dict = {}
    on_card = lambda counts: counts if device == "cuda" else NO_LAUNCHES

    # (a) the rehearsal through the tool's main, each entry's launches counted
    out = os.path.join(tmp, "parity_rehearsal")
    seen: dict = {}
    real_run_entry = pm.run_entry

    def counted(entry, *args, **kw):
        result, launches, wall = _launches_of(lambda: real_run_entry(entry, *args, **kw))
        seen[entry["name"]] = (result[1], launches, wall, cgmm.fwd_wgmma_launches,
                               cgmm.bwd_wgmma_params_launches)
        return result

    pm.run_entry = counted
    try:
        rc = pm.main(["--rehearse", "--out", out, "--device", device])
    finally:
        pm.run_entry = real_run_entry
    with open(os.path.join(out, "parity_summary.json")) as f:
        summary = json.load(f)
    data_root = os.path.join(out, "synthetic_data")
    hp = pm.REHEARSAL_HP
    for entry in pm.MATRIX:
        rows, launches, wall, fwd_wgmma, bwd_wgmma = seen[entry["name"]]
        _add(total, launches)
        # as the JAX tool, the rehearsal asks for every category of the
        # dataset; those without a folder end as error rows, out of the gate
        cats, root = pm._dataset_cats_and_root(entry["dataset"], data_root)
        trained = [r for r in rows if os.path.isdir(os.path.join(root, r["dataclass"]))]
        expect = dict(NO_LAUNCHES)
        if entry["arch"] == "mdn":
            for r in trained:  # enc_cnn at 32 px: one token of 768 an image
                head = _mdn_head_expect(*_head_batches(os.path.join(root, r["dataclass"]),
                                                       hp["batch_size"], hp["img_size"]),
                                        r["epochs_ran"], hp["num_gaussians"], hp["batch_size"])
                _add(expect, {key: head[key] for key in ("B2", "B3")})
        expect = on_card(expect)
        print(f"rehearsal {entry['name']} ({len(trained)} categories trained, "
              f"{len(rows) - len(trained)} without data) in {wall:.2f} s: launches {launches}, "
              f"expected {expect}; B2 wgmma {fwd_wgmma}, B3 wgmma {bwd_wgmma}")
        if launches != expect or fwd_wgmma != expect["B2"] or bwd_wgmma != expect["B3"] \
                or [r["dataclass"] for r in trained] != list(cats[:2]) \
                or any("error" in r for r in trained):
            raise AssertionError(f"rehearsal {entry['name']}: a row holds an error, or the "
                                 "MDN head did not launch B2 and B3 through their wgmma "
                                 "kernels as expected")
    if rc != 0 or summary["ok"] is not True or len(summary["entries"]) != len(pm.MATRIX) \
            or not all(e["ok"] for e in summary["entries"]):
        raise AssertionError(f"the rehearsal exited {rc}: {summary}")
    print(f"parity_matrix --rehearse --device {device}: rc={rc}, {len(summary['entries'])} "
          f"entries compared, all ok")

    # (b) the card against the CPU: the same entries, folders and seeds, f32,
    # on the rehearsal's categories
    f32 = {**hp, "dtypes": DtypePolicy.f32()}
    for entry in pm.rehearsal_matrix(pm.MATRIX):
        cats = list(pm._dataset_cats_and_root(entry["dataset"], data_root)[0][:2])
        runs = {}
        for role, where in (("card", device), ("cpu", "cpu")):
            (csv_path, rows), launches, wall = _launches_of(lambda: pm.run_entry(
                entry, data_root, os.path.join(tmp, f"parity_f32_{role}"), f32, cats, where))
            runs[role] = (csv_path, rows, wall)
            if role == "card":
                _add(total, launches)
        ref = os.path.join(tmp, "parity_f32_cpu_refs", entry["name"] + ".csv")
        _gated(pm, runs["card"][1], runs["card"][0], runs["cpu"][1], ref,
               f"f32 {entry['name']}: {device} ({runs['card'][2]:.2f} s) against the CPU "
               f"({runs['cpu'][2]:.2f} s)")

    # (c) full width through the real-data path: its own models, one category
    cat = SWEEP_CATS[0]
    full_root = os.path.join(tmp, "parity_full")
    make_mvtec_category(os.path.join(full_root, pm.MVTEC_DIR), cat, img_size=img,
                        n_train=SWEEP_TRAIN, n_test_good=SWEEP_TEST, n_test_defect=SWEEP_TEST)
    full = {"epochs": SWEEP_EPOCHS, "patience": SWEEP_EPOCHS, "img_size": img}
    seconds = {}
    for entry in (e for e in pm.MATRIX if e["name"] in PARITY_FULL):
        (csv_path, rows), launches, wall = _launches_of(lambda: pm.run_entry(
            entry, full_root, os.path.join(tmp, "parity_full_out"), full, [cat], device))
        _add(total, launches)
        seconds[entry["name"]] = wall
        if [r["dataclass"] for r in rows] != [cat] or "error" in rows[0]:
            raise AssertionError(f"{entry['name']} at full width: {rows}")
        batch = HyperParams().batch_size  # the real-data path's default
        n_tr, n_va, n_te = _head_batches(os.path.join(full_root, pm.MVTEC_DIR, cat), batch, img)
        epochs = rows[0]["epochs_ran"]
        if entry["arch"] == "mdn":
            expect = _deit_mdn_expect(n_tr, n_va, n_te, epochs,
                                      entry["overrides"]["num_gaussians"], batch)
        else:
            expect = _deit_nf_expect(n_tr + n_va + n_te)
        what = (f"{entry['name']} ({entry['overrides']['model_name']}, {img} px, bf16) in "
                f"{wall:.2f} s (phase 13: {sweep_category_seconds:.2f} s a category)")
        (_check_mdn_routes if entry["arch"] == "mdn" else check_deit_routes)(
            launches, on_card(expect), what)
        _gated(pm, rows, csv_path, rows, os.path.join(tmp, "parity_full_refs",
                                                      entry["name"] + ".csv"),
               f"{entry['name']} against its stand-in")
    wall = time.perf_counter() - t_phase
    print(f"phase launches {total}; full-width seconds {seconds}; phase wall {wall:.2f} s")
    return {"launches": total, "seconds": wall}


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

        phase("9 recon path: ae_deit, train the decoder, then score through the CLIs")
        recon = recon_main_path(tmp)

        phase("10 other trunks: NesT-T + NF-20, EfficientFormer-L3 + MDN K=150, "
              "EfficientNet-B4 + NF-20, train then score through the CLIs")
        trunks = trunks_main_path(tmp)

        phase("11 run directories and NF on ResNet: cli.train_nf -m res_net, cli.score -r "
              "(--watch, --heatmaps, --weights-dtype bf16), cli.validate")
        rundir = rundir_main_path(tmp, os.path.dirname(mdn["pth"]))

        phase(f"12 bundles: native serving bundles of the DeiT NF, DeiT MDN, EsViT NF and "
              f"ResNet MDN runs at batch {BUNDLE_BATCH}, each served from a fresh process; the "
              f"portable DeiT NF bundle on the CPU")
        bundles = bundles_main_path(tmp, nf_pth, deit_pth, img_dir, mdn, esvit, resnet)

        phase("13 sweep and weights: cli.trainings_loop (DeiT-base + MDN K=100, two "
              "categories), resume, a spawned worker, k-means init, the VAE, cli.export_weights, "
              "cli.convert_weights, a student-wrapped EsViT file")
        sweep = sweep_weights_main_path(tmp, os.path.dirname(mdn["pth"]), esvit,
                                        rundir["nf_resnet"], nf_pth, deit_pth, img_dir)

        phase("14 times (CUDA events, median of %d after warm-up)" % TIMED_RUNS)
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
        flow_coupling_times(card, gen)
        gmm_times = mdn_times(mdn, images, card, gen)
        wide = resnet_times(resnet, images, card, gen)
        swin = swin_times(card, gen)
        esvit_times(esvit, images, card, gen)
        recon_fns = recon_times(recon, images, card)
        trunk_nums, trunk_fns = trunks_times(trunks, images, card, gen)
        rundir_nums = rundir_times(rundir, images, card)
        bundle_times(bundles, images, card)
        bundle_launches = bundles["launches"]
        del bundles
        # last: the profiler's hooks slow the host down for whatever is timed after it
        print_device_profile(f"DeiT NF uint8→scores B={FLAGSHIP_BATCH} bf16, fused MLP on "
                             f"(the default)", deit_fns[True], card, top=20)
        del deit_fns
        torch.cuda.empty_cache()
        step = resnet_joint_step(RESNET_K, images)[0]
        print_device_profile(f"ResNet-50 + MDN joint train step B={RESNET_BATCH} "
                             f"K={RESNET_K} bf16", step, card, top=24)
        del step
        print_device_profile(f"ae_deit recon uint8→scores B={FLAGSHIP_BATCH} bf16",
                             recon_fns[0], card, top=16)
        print_device_profile(f"ae_deit decoder-only train step B={RECON_STEP_BATCH} bf16",
                             recon_fns[1], card, top=16)
        del recon_fns
        for what, fn in (("NesT-T + NF-20 uint8→scores", trunk_fns["NesT"]),
                         ("EfficientFormer-L3 uint8→tokens", trunk_fns["EfficientFormer-L3"]),
                         ("EfficientNet-B4 uint8→tokens", trunk_fns["EfficientNet-B4"])):
            print_device_profile(f"{what} B={FLAGSHIP_BATCH} bf16", fn, card, top=16)
        del trunk_fns
        print_device_profile(f"NF-ResNet joint train step B={NFRES_BATCH} (ResNet-50 bf16 trunk, "
                             f"3 NF-20 flows f32, stage norms, Adam)", rundir_nums["step"], card,
                             top=24)
        del rundir_nums
        torch.cuda.empty_cache()

        phase("15 mesh: two ranks of an explicit cluster on card 0 (gloo): cli.train_mdn "
              "--mesh 1x2 (DeiT-base sharded + MDN K=150), the ResNet-50 MDN joint step on 1x2 "
              "(K=100), ae_cnn on 2x1, cli.score --mesh 2 (DeiT-base NF, batch 128), DeiT-base, "
              "EsViT Swin-T and NesT-T sharded on 1x2")
        mesh = mesh_main_path(tmp, os.path.join(tmp, "sweep_data", SWEEP_CATS[0]), nf_pth,
                              deit_pth)

        phase("16 levers: the JAX package's opt-in model levers off and on, B=128 bf16 "
              "(EsViT NF: gather, split onto B5a, LN fold; EsViT NF without the fused "
              "LayerNorm: bf16 LN; DeiT NF: ViT LN fold, folded flow; EfficientNet-B4 NF: "
              "hard-swish), B5a on the split route, the reversible NF-ResNet step at B=32")
        from vit_ad_tpu_torch.cli.score import _load_run_cli

        nf_resnet = _load_run_cli(rundir["nf_resnet"], dev, None, None)[0].parts
        train_split = DataPipeline(NFRES_BATCH, 224, base_path=rundir["nf_resnet_data"],
                                   data_path="train/good")
        nf_batch = torch.from_numpy(list(train_split.train_batches())[0].images).to(dev)
        levers = levers_main_path(nf_pth, deit_pth, esvit["pth"], trunks["eff_net"]["pth"],
                                  nf_resnet, nf_batch, images, card, gen)
        del nf_resnet, nf_batch
        torch.cuda.empty_cache()

        phase("17 parity: the quality-parity harness (cli.parity_matrix): the six-entry "
              "rehearsal on the card, its rows on the card against the CPU (f32), and "
              "nf_mvtec_lastblock and gmm_mvtec_100_gaussians with their own models (DeiT-base, "
              "224 px, bf16, K=100) through the real-data path")
        parity = parity_main_path(tmp, sweep["category_seconds"])
    torch.cuda.synchronize()

    phase("18 result")
    kernels = [{
        "name": "vit_attention_qkv",
        "route": "cuda",
        "source": "vit_ad_tpu_torch/csrc/vit_attention_qkv.cu",
        "replaces": "vit_ad_tpu/ops/pallas/window_attention.py:375",
        "launches": nf_launches["B1"] + fused["launches"]["B1"] + mdn["launches"]["B1"]
        + recon["launches"]["B1"] + trunks["nest"]["launches"]["B1"]
        + rundir["launches"]["B1"] + bundle_launches["B1"] + sweep["launches"]["B1"]
        + mesh["launches"]["B1"] + levers["launches"]["B1"] + parity["launches"]["B1"],
        "max_abs_err": err,
        "ms": att_ms,
        "plain_ms": att_plain_ms,
        **att_bound,
        "library_ms": att_lib_ms,
        "per_shape": trunk_nums["B1"] + mesh["B1"],
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
        shapes = [gmm_times[key]] + wide[key] + trunk_nums.get(key, [])
        main = wide[key][0] if key == "B4" else gmm_times[key]
        kernels.append({"name": kernel, "route": "cuda", "source": "vit_ad_tpu_torch/csrc/gmm.cu",
                        "replaces": replaces,
                        "launches": mdn["launches"][key] + resnet["launches"][key]
                        + trunks["eff_former"]["launches"][key] + rundir["launches"][key]
                        + bundle_launches[key] + sweep["launches"][key]
                        + mesh["launches"][key] + parity["launches"][key],
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
    # B5a, the split-input entry, runs on the Swin blocks' split route
    # (`VITAD_SWIN_PACKED=0`), which phase 16 drives; its numbers are phase
    # 14's at stage 0 (the kernel alone), every stage on that route in `per_stage`
    for key, kernel, source, replaces in (
            ("B5", "swin_window_attention", "swin_window_attention.cu",
             "vit_ad_tpu/ops/pallas/window_attention.py:212"),
            ("B5a", "swin_window_attention_split", "swin_window_attention.cu",
             "vit_ad_tpu/ops/pallas/window_attention.py:46"),
            ("B7", "layer_norm", "layer_norm.cu", "vit_ad_tpu/ops/pallas/layer_norm.py:53")):
        kernels.append({"name": kernel, "route": "cuda",
                        "source": f"vit_ad_tpu_torch/csrc/{source}", "replaces": replaces,
                        "launches": esvit["launches"][key] + bundle_launches[key]
                        + sweep["launches"][key] + mesh["launches"][key]
                        + levers["launches"][key] + parity["launches"][key], **swin[key]})
    kernels[-3]["per_stage"] += mesh["B5"]  # B5 at the half-head shard shapes
    kernels[-2]["per_stage"] = levers["B5a"]
    # B7 also runs the DeiT blocks' first norm and the final norm, and every
    # NesT-T LayerNorm
    kernels[-1]["launches"] += (nf_launches["B7"] + fused["launches"]["B7"]
                                + mdn["launches"]["B7"] + recon["launches"]["B7"]
                                + trunks["nest"]["launches"]["B7"] + rundir["launches"]["B7"])
    kernels[-1]["per_stage"] += trunk_nums["B7"]
    kernels[-1]["design"] = ("rows kernel: D = 8 LPR NV, 32 / LPR rows a warp, scale and bias "
                             "in registers, the warps striding over the rows from D = 384 with "
                             "the next group's loads in flight")
    kernels.append({"name": "mlp_block", "route": "cuda",
                    "source": "vit_ad_tpu_torch/csrc/mlp_block.cu",
                    "replaces": "vit_ad_tpu/ops/pallas/mlp.py:44",
                    "launches": nf_launches["B6"] + fused["launches"]["B6"]
                    + mdn["launches"]["B6"] + recon["launches"]["B6"]
                    + rundir["launches"]["B6"] + bundle_launches["B6"]
                    + sweep["launches"]["B6"] + mesh["launches"]["B6"]
                    + levers["launches"]["B6"] + parity["launches"]["B6"], **mlp})
    # B6's products one at a time, on the trunk shards of phase 15: the GELU
    # and the f32-partial epilogues; the numbers of the fc2 partial, the new
    # epilogue, with every shape in `per_shape`
    kernels.append({"name": "mlp_gemm_step", "route": "cuda",
                    "source": "vit_ad_tpu_torch/csrc/mlp_block.cu",
                    "replaces": "vit_ad_tpu/ops/pallas/mlp.py:44",
                    "launches": mesh["launches"]["GEMM"], **mesh["GEMM"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) in (5, 6) and sys.argv[1] == "--serve-bundle":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(serve_bundle(*sys.argv[2:]))
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-rank":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(mesh_rank(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--against":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(against(sys.argv[2]))
    if len(sys.argv) >= 3 and sys.argv[1] == "--gmm-backward-ab":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(gmm_backward_ab(sys.argv[2:]))
    sys.exit(main())
