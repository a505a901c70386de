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
kernels read in place. The kernels take the biases and log_pi
component-major ([K, D] and [K, rows], `component_major`) and, under bf16, x
rounded to bf16 beside the f32 x; `kernel_operands` makes the heads' part of
that, which a frozen head caches (`models/mdn.GaussianMDN.kernel_operands`).
`backward_decomposition` is the backward's decomposition (chunks, partials,
split dx, fixed-order reductions) written out in plain torch, for the tests.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from vit_ad_tpu_torch.ops.gmm import log_likelihood_from_log_pi

# Kernel launches of each group (plain counts, read by chip_smoke.py to show
# that the main path went through the kernels), one per entry point call: B2
# once per forward; the backward calls B3's two entries (terms, weights) and
# B4's one once per chunk of components (`backward_chunk`).
fwd_launches = 0         # B2
bwd_params_launches = 0  # B3
bwd_x_launches = 0       # B4
# Launches that the C entries reported as their bf16 wgmma kernels (the routes
# of `forward_route` and `backward_routes`), and the routes the last launches
# reported.
fwd_wgmma_launches = 0
bwd_wgmma_params_launches = 0
bwd_wgmma_x_launches = 0
last_fwd_route: Optional[str] = None
last_bwd_routes: Dict[str, Optional[str]] = {"terms": None, "weights": None, "x": None}

TILE = 64
# B2's bf16 kernel keeps a block's x rows [64, D] in shared memory up to this
# width and streams them beside the weights above it (csrc/gmm.cu).
RESIDENT_X_MAX_D = 1024
# What the entry points report through their `route` out-parameter.
_ROUTES = {1: "wgmma_x_resident", 2: "fma", 3: "wgmma_x_streamed", 4: "wgmma"}
# B4's bf16 kernel tiles dx by 128 rows x 256 features; a chunk's components
# are split into up to MAX_DX_SPLITS ranges, each with its own partial dx,
# where that fills the card's last wave of tiles better (`dx_splits`).
DX_TILE_ROWS, DX_TILE_COLS = 128, 256
MAX_DX_SPLITS = 8
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
    _check_width(d, matmul_dtype)
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


def _check_width(d: int, matmul_dtype: torch.dtype) -> None:
    if matmul_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"GMM kernels take bf16 or f32 matmuls, got {matmul_dtype}")
    if d < TILE or d % TILE:
        raise ValueError(f"GMM kernels take a feature width that is a multiple of {TILE}, "
                         f"got {d}")


def forward_route(d: int, matmul_dtype: torch.dtype) -> str:
    """The kernel B2's C entry launches at feature width `d`: under bf16 the
    wgmma kernel with the x rows resident in shared memory (D <= 1024) or
    streamed with the weights, under f32 the FMA kernel. Raises for a width or
    type the entry refuses."""
    _check_width(d, matmul_dtype)
    if matmul_dtype == torch.float32:
        return "fma"
    return "wgmma_x_resident" if d <= RESIDENT_X_MAX_D else "wgmma_x_streamed"


def backward_routes(d: int, matmul_dtype: torch.dtype) -> Dict[str, str]:
    """The kernels the backward's three C entries launch at width `d`: B3's
    terms (B2's block and x residency: `forward_route`), B3's weight
    gradients and B4's dx (the wgmma GEMMs under bf16); the FMA kernels under
    f32. Raises for a width or type the entries refuse."""
    terms = forward_route(d, matmul_dtype)
    gemm = "fma" if matmul_dtype == torch.float32 else "wgmma"
    return {"terms": terms, "weights": gemm, "x": gemm}


def dx_splits(rows: int, d: int, kc: int, sms: int) -> int:
    """Ranges into which B4's bf16 kernel splits a chunk of `kc` components
    (each range into its own partial dx, summed in order afterwards): the
    count up to MAX_DX_SPLITS (and kc) whose blocks, tiles x ranges, fill the
    waves of the card's `sms` SMs best, the smallest of equals."""
    tiles = -(-rows // DX_TILE_ROWS) * -(-d // DX_TILE_COLS)
    best, best_fill = 1, 0.0
    for s in range(1, min(kc, MAX_DX_SPLITS) + 1):
        blocks = tiles * s
        fill = blocks / (-(-blocks // sms) * sms)
        if fill > best_fill + 1e-9:
            best, best_fill = s, fill
    return best


def component_major(t: torch.Tensor) -> torch.Tensor:
    """[n, K] → a contiguous f32 [K, n] copy: component k's column as a row,
    the layout in which B2 reads the biases ([D, K] views of the Linear
    layout's [D*K]) and log_pi ([rows, K])."""
    return t.detach().float().t().contiguous()


def kernel_operands(w_sigma: torch.Tensor, b_sigma: torch.Tensor, w_mu: torch.Tensor,
                    b_mu: torch.Tensor, matmul_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The heads as B2 takes them, detached: both weight matrices in the
    matmul type, Linear layout (what B3 and B4 read too), and both biases
    component-major [K, D] (`component_major`)."""
    from vit_ad_tpu_torch.ops.cuda.build import aligned_buffer

    k = w_sigma.shape[0] // w_sigma.shape[1]
    return {"w_sigma": aligned_buffer(w_sigma.detach(), matmul_dtype),
            "w_mu": aligned_buffer(w_mu.detach(), matmul_dtype),
            "b_sigma_t": component_major(b_sigma.reshape(-1, k)),
            "b_mu_t": component_major(b_mu.reshape(-1, k))}


def backward_chunk(rows: int, d: int, k: int, matmul_dtype: torch.dtype) -> int:
    """Components per chunk of the backward: dmu and dpre of a chunk stay
    under SCRATCH_BYTES."""
    return max(1, min(k, SCRATCH_BYTES // (2 * rows * d * matmul_dtype.itemsize)))


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


class _GmmLogLikelihood(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, log_pi, w_sigma, b_sigma, w_mu, b_mu, matmul_dtype, operands):
        global fwd_launches, fwd_wgmma_launches, last_fwd_route
        from vit_ad_tpu_torch.ops.cuda.build import aligned_buffer, device_index, load_library

        rows, d, k = check_kernel_shape(x, log_pi, w_sigma, b_sigma, w_mu, b_mu, matmul_dtype)
        want = forward_route(d, matmul_dtype)
        if operands is None:
            operands = kernel_operands(w_sigma, b_sigma, w_mu, b_mu, matmul_dtype)
        ws, wm = operands["w_sigma"], operands["w_mu"]
        if ws.dtype != matmul_dtype or wm.dtype != matmul_dtype:
            raise TypeError(f"kernel operands are {ws.dtype}, the matmuls {matmul_dtype}")
        lib = load_library()
        f32 = torch.float32
        xr = aligned_buffer(x.reshape(rows, d), f32)
        xm = aligned_buffer(xr, matmul_dtype) if matmul_dtype == torch.bfloat16 else None
        lpr = aligned_buffer(log_pi.reshape(rows, k), f32)
        lpt = component_major(lpr)
        ll = torch.empty((rows, d), dtype=torch.float32, device=x.device)
        route = ctypes.c_int(0)
        _check(lib.gmm_forward(xr.data_ptr(), None if xm is None else xm.data_ptr(),
                               lpt.data_ptr(), wm.data_ptr(), ws.data_ptr(),
                               operands["b_mu_t"].data_ptr(), operands["b_sigma_t"].data_ptr(),
                               ll.data_ptr(), rows, d, k, int(matmul_dtype == torch.bfloat16),
                               device_index(x), torch.cuda.current_stream(x.device).cuda_stream,
                               ctypes.byref(route)), "gmm_forward")
        last_fwd_route = _ROUTES.get(route.value)
        if last_fwd_route != want:
            raise RuntimeError(f"gmm_forward launched route {route.value} "
                               f"({last_fwd_route}), expected {want}")
        fwd_launches += 1
        fwd_wgmma_launches += want != "fma"
        ctx.save_for_backward(xr, xm, lpt, ws, wm, operands["b_sigma_t"], operands["b_mu_t"], ll)
        ctx.shapes = (x.shape, log_pi.shape, x.dtype)
        ctx.matmul_dtype = matmul_dtype
        return ll.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        global bwd_params_launches, bwd_x_launches
        global bwd_wgmma_params_launches, bwd_wgmma_x_launches
        from vit_ad_tpu_torch.ops.cuda.build import aligned_buffer, device_index, load_library

        xr, xm, lpt, ws, wm, bst, bmt, ll = ctx.saved_tensors
        x_shape, lp_shape, x_dtype = ctx.shapes
        md = ctx.matmul_dtype
        rows, d = xr.shape
        k = lpt.shape[0]
        want = backward_routes(d, md)
        lib = load_library()
        dev, stream = device_index(xr), torch.cuda.current_stream(xr.device).cuda_stream
        bf16 = int(md == torch.bfloat16)
        ptr = lambda t: None if t is None else t.data_ptr()
        gr = aligned_buffer(g.reshape(rows, d), torch.float32)
        kc = backward_chunk(rows, d, k, md)
        f32 = dict(dtype=torch.float32, device=xr.device)
        dmu = torch.empty((kc, rows, d), dtype=md, device=xr.device)
        dpre = torch.empty_like(dmu)
        bmu_part = torch.empty((-(-rows // TILE), k, d), **f32)
        bsig_part = torch.empty_like(bmu_part)
        dlp_part = torch.empty((d // TILE, k, rows), **f32)
        dwm = torch.empty((d * k, d), **f32)
        dws = torch.empty_like(dwm)
        need_x = ctx.needs_input_grad[0]
        dmu_sum = torch.empty((rows, d), **f32) if need_x else None
        dx = torch.empty((rows, d), **f32) if need_x else None
        chunks = [(k0, min(kc, k - k0)) for k0 in range(0, k, kc)]
        splits = [1] * len(chunks)
        if need_x and bf16:
            sms = torch.cuda.get_device_properties(xr.device).multi_processor_count
            splits = [dx_splits(rows, d, n, sms) for _, n in chunks]
        dx_part = torch.empty((max(splits), rows, d), **f32) if max(splits) > 1 else None
        route = ctypes.c_int(0)

        def launched(what: str, entry: str) -> None:
            last_bwd_routes[what] = _ROUTES.get(route.value)
            if last_bwd_routes[what] != want[what]:
                raise RuntimeError(f"{entry} launched route {route.value} "
                                   f"({last_bwd_routes[what]}), expected {want[what]}")

        for (k0, n), n_splits in zip(chunks, splits):
            _check(lib.gmm_backward_terms(
                xr.data_ptr(), ptr(xm), lpt.data_ptr(), gr.data_ptr(), ll.data_ptr(),
                wm.data_ptr(), ws.data_ptr(), bmt.data_ptr(), bst.data_ptr(), k0, n,
                dmu.data_ptr(), dpre.data_ptr(), bmu_part.data_ptr(), bsig_part.data_ptr(),
                dlp_part.data_ptr(), ptr(dmu_sum), rows, d, k, bf16, dev, stream,
                ctypes.byref(route)), "gmm_backward_terms")
            launched("terms", "gmm_backward_terms")
            _check(lib.gmm_backward_weights(
                xr.data_ptr(), ptr(xm), dmu.data_ptr(), dpre.data_ptr(), dwm.data_ptr(),
                dws.data_ptr(), k0, n, rows, d, k, bf16, dev, stream, ctypes.byref(route)),
                "gmm_backward_weights")
            launched("weights", "gmm_backward_weights")
            bwd_params_launches += 2
            bwd_wgmma_params_launches += 2 * bf16
            if need_x:
                _check(lib.gmm_backward_x(
                    dmu.data_ptr(), dpre.data_ptr(), wm.data_ptr(), ws.data_ptr(),
                    dmu_sum.data_ptr(), dx.data_ptr(), ptr(dx_part), k0, n, int(k0 == 0),
                    int(k0 + n >= k), n_splits, rows, d, k, bf16, dev, stream,
                    ctypes.byref(route)), "gmm_backward_x")
                launched("x", "gmm_backward_x")
                bwd_x_launches += 1
                bwd_wgmma_x_launches += bf16
        if need_x:
            dx = dx.reshape(x_shape).to(x_dtype)
        dlp, dbs, dbm = reduce_partials(bsig_part, bmu_part, dlp_part)
        return dx, dlp.reshape(lp_shape), dws, dbs, dwm, dbm, None, None


def reduce_partials(bsig_part: torch.Tensor, bmu_part: torch.Tensor, dlp_part: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's fixed-order reductions of the per-tile partials: d
    log_pi [rows, K] from dlp_part [D/64, K, rows] (one per 64-feature group),
    the bias gradients [D*K] in the Linear index e*K + k from the per-64-row
    partials [row tiles, K, D]."""
    k, d = bmu_part.shape[1:]
    flat = lambda part: part.sum(0).t().reshape(d * k)
    return dlp_part.sum(0).t(), flat(bsig_part), flat(bmu_part)


def backward_decomposition(x, log_pi, w_sigma, b_sigma, w_mu, b_mu, g, ll,
                           matmul_dtype: torch.dtype, need_x: bool = True,
                           chunk: Optional[int] = None, sms: int = 132):
    """The backward of `gmm_log_likelihood` as the kernels decompose it,
    written out in plain torch (f32): per chunk of `chunk` components
    (`backward_chunk` by default) the terms into the scratch, rounded to the
    matmul type, with their bias partials per 64-row tile and d log_pi
    partials per 64-feature group; the weight gradients from the scratch; dx
    from the scratch in `dx_splits` ranges per chunk under bf16 (the card's
    `sms` SMs), each range its own partial, summed in order with the chunks
    before and, on the last chunk, minus sum_k dmu; then `reduce_partials`.
    x [..., D], log_pi [..., K], g and ll [..., D] (the forward's output),
    Linear-layout heads. Returns the gradients (dx or None, dlog_pi, dw_sigma,
    db_sigma, dw_mu, db_mu) in the shapes of the inputs."""
    from vit_ad_tpu_torch.ops.gmm import log_gaussian_density, sigma_from_pre

    d, k = x.shape[-1], log_pi.shape[-1]
    rows = x.numel() // d
    f = lambda t: t.detach().float()
    rnd = lambda t: f(t) if matmul_dtype == torch.float32 else f(t).to(matmul_dtype).float()
    xf = f(x).reshape(rows, d)
    xm = rnd(xf)
    lp, gr, llr = f(log_pi).reshape(rows, k), f(g).reshape(rows, d), f(ll).reshape(rows, d)
    wsr, wmr = rnd(w_sigma).reshape(d, k, d), rnd(w_mu).reshape(d, k, d)  # [e, k, i]
    bsr, bmr = f(b_sigma).reshape(d, k), f(b_mu).reshape(d, k)
    kc = chunk or backward_chunk(rows, d, k, matmul_dtype)
    row_tiles = -(-rows // TILE)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=xf.device)
    bmu_part, bsig_part = zeros(row_tiles, k, d), zeros(row_tiles, k, d)
    dlp_part = zeros(d // TILE, k, rows)
    dwm, dws = zeros(d, k, d), zeros(d, k, d)
    dmu_sum, dx = zeros(rows, d), zeros(rows, d)
    tile_sums = lambda t: torch.nn.functional.pad(t, (0, 0, 0, row_tiles * TILE - rows)) \
        .reshape(row_tiles, TILE, d).sum(1)
    for k0 in range(0, k, kc):
        n = min(kc, k - k0)
        scratch = []
        for kx in range(k0, k0 + n):
            mu = xm @ wmr[:, kx].t() + bmr[:, kx]
            pre = xm @ wsr[:, kx].t() + bsr[:, kx]
            sigma = sigma_from_pre(pre)
            z = (xf - mu) / sigma
            q = gr * torch.exp(log_gaussian_density(sigma, mu, xf) + lp[:, kx:kx + 1] - llr)
            dm = q * z / sigma
            dp = q * ((z * z - 1.0) / sigma) * torch.where(
                pre > 0, torch.ones_like(pre), torch.exp(torch.clamp(pre, max=0.0)))
            bmu_part[:, kx], bsig_part[:, kx] = tile_sums(dm), tile_sums(dp)
            dlp_part[:, kx] = q.reshape(rows, d // TILE, TILE).sum(-1).t()
            dmu_sum += dm
            sm, sp = rnd(dm), rnd(dp)
            dwm[:, kx], dws[:, kx] = sm.t() @ xm, sp.t() @ xm
            scratch.append((sm, sp))
        if need_x:
            n_splits = dx_splits(rows, d, n, sms) if matmul_dtype == torch.bfloat16 else 1
            total = dx if k0 > 0 else zeros(rows, d)
            for z in range(n_splits):
                part = zeros(rows, d)
                for kk in range(z * n // n_splits, (z + 1) * n // n_splits):
                    sm, sp = scratch[kk]
                    part += sm @ wmr[:, k0 + kk] + sp @ wsr[:, k0 + kk]
                total = total + part
            dx = total - dmu_sum if k0 + n >= k else total
    dlp, dbs, dbm = reduce_partials(bsig_part, bmu_part, dlp_part)
    return (dx.reshape(x.shape) if need_x else None, dlp.reshape(log_pi.shape),
            dws.reshape(d * k, d), dbs, dwm.reshape(d * k, d), dbm)


def gmm_log_likelihood(x: torch.Tensor, log_pi: torch.Tensor, w_sigma: torch.Tensor,
                       b_sigma: torch.Tensor, w_mu: torch.Tensor, b_mu: torch.Tensor,
                       matmul_dtype: torch.dtype = torch.float32,
                       operands: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Differentiable per-feature log-likelihood [B,P,D] from features x
    [B,P,D] and log mixture weights [B,P,K], with Linear-layout heads
    (w [D*K, D], b [D*K]). Matmul operands are rounded to `matmul_dtype`
    (bf16 on the tensor cores, f32 accumulation; or f32), the density math is
    f32. The Hopper kernels on CUDA tensors, the plain version on CPU
    tensors. `operands`: `kernel_operands` of these heads made beforehand (a
    frozen head's cached copy); made per call when None; the plain version
    does not read it."""
    if x.device.type == "cuda":
        return _GmmLogLikelihood.apply(x, log_pi, w_sigma, b_sigma, w_mu, b_mu, matmul_dtype,
                                       operands)
    if x.device.type == "cpu":
        return gmm_log_likelihood_reference(x, log_pi, w_sigma, b_sigma, w_mu, b_mu,
                                            matmul_dtype)
    raise RuntimeError(f"gmm_log_likelihood has no path for device {x.device}")
