"""Differentiable GMM per-feature log-likelihood of the MDN head.

Port of `vit_ad_tpu/ops/pallas/gmm_train.py::gmm_log_likelihood_train`
(custom VJP :439-486) and of the scoring forward
`vit_ad_tpu/ops/pallas/gmm.py::gmm_log_likelihood_pallas` (:118). Their TPU
kernels become the hand-written Hopper kernels of
`vit_ad_tpu_torch/csrc/gmm.cu` (its header says what bounds them and how
they are laid out):

  B2  forward                 `gmm_forward`
  B3  gradients of log_pi, weights and biases
                              `gmm_backward_terms` + `gmm_backward_weights`
  B4  gradient of the features `gmm_backward_x` (only when x needs one)

`gmm_log_likelihood` launches them for CUDA tensors and raises where it
cannot; for CPU tensors it runs the plain version,
`ops/gmm.log_likelihood_from_log_pi`, whose autograd is the plain version of
B3 and B4. Weights are taken in the reference nn.Linear layout
([D*K, D_in], row e*K + k = output feature e of component k), which the
kernels read in place.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vit_ad_tpu_torch.ops.gmm import log_likelihood_from_log_pi

# Kernel launches of each group (plain counts, read by chip_smoke.py to show
# that the main path went through the kernels), one per launch: B2 launches
# once per call; the backward launches B3's two kernels (terms, weights) and
# B4's one once per chunk of components (`backward_chunk`).
fwd_launches = 0         # B2
bwd_params_launches = 0  # B3
bwd_x_launches = 0       # B4

TILE = 64
# The backward keeps dmu/dpre of a chunk of components in device memory:
# chunks are sized to stay under this many bytes.
SCRATCH_BYTES = 1 << 30
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def linear_to_jax_layout(w: torch.Tensor, b: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """nn.Linear weight [D*K, D_in] and bias [D*K] → views in the JAX
    layout [D_in, D_out, K] and [D_out, K] (no copy)."""
    return w.t().reshape(w.shape[1], -1, k), b.reshape(-1, k)


def gmm_log_likelihood_reference(x, log_pi, w_sigma, b_sigma, w_mu, b_mu,
                                 matmul_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain PyTorch version: x [B,P,D], log_pi [B,P,K], Linear-layout
    weights → ll [B,P,D]."""
    k = log_pi.shape[-1]
    ws, bs = linear_to_jax_layout(w_sigma, b_sigma, k)
    wm, bm = linear_to_jax_layout(w_mu, b_mu, k)
    return log_likelihood_from_log_pi(x, log_pi, ws, bs.float(), wm, bm.float(),
                                      matmul_dtype=matmul_dtype)


def check_kernel_shape(x, log_pi, w_sigma, b_sigma, w_mu, b_mu,
                       matmul_dtype: torch.dtype) -> Tuple[int, int, int]:
    """Raise unless the kernels take these inputs; return (rows, D, K)."""
    d, k = x.shape[-1], log_pi.shape[-1]
    rows = x.numel() // d if d else 0
    if matmul_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"GMM kernels take bf16 or f32 matmuls, got {matmul_dtype}")
    if d < TILE or d % TILE:
        raise ValueError(f"GMM kernels take a feature width that is a multiple of {TILE}, "
                         f"got {d}")
    if rows < 1 or log_pi.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"x {tuple(x.shape)} and log_pi {tuple(log_pi.shape)} do not "
                         "describe the same rows")
    for name, t, shape in (("w_sigma", w_sigma, (d * k, d)), ("w_mu", w_mu, (d * k, d)),
                           ("b_sigma", b_sigma, (d * k,)), ("b_mu", b_mu, (d * k,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} (nn.Linear layout), got {tuple(t.shape)}")
    for t in (log_pi, w_sigma, b_sigma, w_mu, b_mu):
        if t.device != x.device:
            raise ValueError(f"GMM inputs lie on {x.device} and {t.device}")
    return rows, d, k


def backward_chunk(rows: int, d: int, k: int, matmul_dtype: torch.dtype) -> int:
    """Components per chunk of the backward: dmu and dpre of a chunk stay
    under SCRATCH_BYTES."""
    return max(1, min(k, SCRATCH_BYTES // (2 * rows * d * matmul_dtype.itemsize)))


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


class _GmmLogLikelihood(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, log_pi, w_sigma, b_sigma, w_mu, b_mu, matmul_dtype):
        global fwd_launches
        from vit_ad_tpu_torch.ops.cuda.build import aligned_buffer, device_index, load_library

        rows, d, k = check_kernel_shape(x, log_pi, w_sigma, b_sigma, w_mu, b_mu, matmul_dtype)
        lib = load_library()
        f32 = torch.float32
        xr = aligned_buffer(x.reshape(rows, d), f32)
        lpr = aligned_buffer(log_pi.reshape(rows, k), f32)
        ws, wm = aligned_buffer(w_sigma, matmul_dtype), aligned_buffer(w_mu, matmul_dtype)
        bs, bm = aligned_buffer(b_sigma, f32), aligned_buffer(b_mu, f32)
        ll = torch.empty((rows, d), dtype=torch.float32, device=x.device)
        bf16 = int(matmul_dtype == torch.bfloat16)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(lib.gmm_forward(xr.data_ptr(), lpr.data_ptr(), wm.data_ptr(), ws.data_ptr(),
                               bm.data_ptr(), bs.data_ptr(), ll.data_ptr(), rows, d, k, bf16,
                               device_index(x), stream), "gmm_forward")
        fwd_launches += 1
        ctx.save_for_backward(xr, lpr, ws, bs, wm, bm, ll)
        ctx.shapes = (x.shape, log_pi.shape, x.dtype)
        ctx.matmul_dtype = matmul_dtype
        return ll.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        global bwd_params_launches, bwd_x_launches
        from vit_ad_tpu_torch.ops.cuda.build import aligned_buffer, device_index, load_library

        xr, lpr, ws, bs, wm, bm, ll = ctx.saved_tensors
        x_shape, lp_shape, x_dtype = ctx.shapes
        md = ctx.matmul_dtype
        rows, d = xr.shape
        k = lpr.shape[1]
        lib = load_library()
        dev, stream = device_index(xr), torch.cuda.current_stream(xr.device).cuda_stream
        bf16 = int(md == torch.bfloat16)
        gr = aligned_buffer(g.reshape(rows, d), torch.float32)
        kc = backward_chunk(rows, d, k, md)
        f32 = dict(dtype=torch.float32, device=xr.device)
        dmu = torch.empty((kc, rows, d), dtype=md, device=xr.device)
        dpre = torch.empty_like(dmu)
        row_tiles = -(-rows // TILE)
        bmu_part = torch.empty((row_tiles, k, d), **f32)
        bsig_part = torch.empty_like(bmu_part)
        dlp_part = torch.empty((d // TILE, rows, k), **f32)
        dwm = torch.empty((d * k, d), **f32)
        dws = torch.empty_like(dwm)
        need_x = ctx.needs_input_grad[0]
        dmu_sum = torch.empty((rows, d), **f32) if need_x else None
        dx = torch.empty((rows, d), **f32) if need_x else None
        for k0 in range(0, k, kc):
            n = min(kc, k - k0)
            _check(lib.gmm_backward_terms(
                xr.data_ptr(), lpr.data_ptr(), gr.data_ptr(), ll.data_ptr(), wm.data_ptr(),
                ws.data_ptr(), bm.data_ptr(), bs.data_ptr(), k0, n, dmu.data_ptr(),
                dpre.data_ptr(), bmu_part.data_ptr(), bsig_part.data_ptr(),
                dlp_part.data_ptr(), dmu_sum.data_ptr() if need_x else None, rows, d, k, bf16,
                dev, stream), "gmm_backward_terms")
            bwd_params_launches += 1
            _check(lib.gmm_backward_weights(
                xr.data_ptr(), dmu.data_ptr(), dpre.data_ptr(), dwm.data_ptr(),
                dws.data_ptr(), k0, n, rows, d, k, bf16, dev, stream), "gmm_backward_weights")
            bwd_params_launches += 1
            if need_x:
                _check(lib.gmm_backward_x(
                    dmu.data_ptr(), dpre.data_ptr(), wm.data_ptr(), ws.data_ptr(),
                    dmu_sum.data_ptr(), dx.data_ptr(), k0, n, int(k0 == 0), int(k0 + n >= k),
                    rows, d, k, bf16, dev, stream), "gmm_backward_x")
                bwd_x_launches += 1
        if need_x:
            dx = dx.reshape(x_shape).to(x_dtype)
        # fixed-order reductions of the per-tile partials; biases back to the
        # Linear index e*K + k
        dlp = dlp_part.sum(0).reshape(lp_shape)
        dbm = bmu_part.sum(0).t().reshape(d * k)
        dbs = bsig_part.sum(0).t().reshape(d * k)
        return dx, dlp, dws, dbs, dwm, dbm, None


def gmm_log_likelihood(x: torch.Tensor, log_pi: torch.Tensor, w_sigma: torch.Tensor,
                       b_sigma: torch.Tensor, w_mu: torch.Tensor, b_mu: torch.Tensor,
                       matmul_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Differentiable per-feature log-likelihood [B,P,D] from features x
    [B,P,D] and log mixture weights [B,P,K], with Linear-layout heads
    (w [D*K, D], b [D*K]). Matmul operands are rounded to `matmul_dtype`
    (bf16 on the tensor cores, f32 accumulation; or f32), the density math is
    f32. The Hopper kernels on CUDA tensors, the plain version on CPU
    tensors."""
    if x.device.type == "cuda":
        return _GmmLogLikelihood.apply(x, log_pi, w_sigma, b_sigma, w_mu, b_mu, matmul_dtype)
    if x.device.type == "cpu":
        return gmm_log_likelihood_reference(x, log_pi, w_sigma, b_sigma, w_mu, b_mu,
                                            matmul_dtype)
    raise RuntimeError(f"gmm_log_likelihood has no path for device {x.device}")
