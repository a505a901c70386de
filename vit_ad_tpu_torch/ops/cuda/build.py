"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every `*.cu` under `vit_ad_tpu_torch/csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`), one process per source, all started together (the `*.cuh` beside
them are headers the sources include), and the objects are linked into one shared library with a plain C interface. The library
lands in `vit_ad_tpu_torch/_build/` (git-ignored) under a name keyed on a hash
of the sources and flags, so an edited kernel is rebuilt and an unchanged one
is loaded as it is. Nothing here runs at import: the first wrapper call on a
CUDA tensor builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """`nvcc` from PATH, else `$CUDA_HOME/bin` (default `/usr/local/cuda`)."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or in $CUDA_HOME/bin: the port's CUDA kernels "
        f"are compiled from {CSRC_DIR} at first use and need the CUDA toolkit "
        "(12.x, for sm_90a)"
    )


def source_files() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in source_files():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libvitad_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists; return
    its path. The compiler's register and shared-memory report (`-Xptxas=-v`)
    is kept beside it as `<library>.log`."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    srcs = [f for f in source_files() if f.suffix == ".cu"]
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    spawn = lambda cmd: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
    log = []

    def wait(proc: subprocess.Popen) -> None:
        log.append(proc.communicate()[0])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: "
                               f"{' '.join(proc.args)}\n{log[-1]}")

    procs = [spawn([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)])
             for src, o in zip(srcs, objs)]
    try:
        for proc in procs:
            wait(proc)
        wait(spawn([nvcc, "-shared", "-o", str(tmp), *map(str, objs)]))
    finally:
        for proc in procs:  # a failed compile stops the others
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_name(out.name + ".log").write_text("".join(log))
    os.replace(tmp, out)  # atomic: another process never loads a half-written library
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int
_ROUTE = ctypes.POINTER(ctypes.c_int)  # out: which kernel the entry point launched
# Every entry point's argument types; each returns a CUDA error code (int).
ENTRY_POINTS = {
    # qkv, out, batch, n, heads, head_dim, is_bf16, scale, device, stream, route
    "vit_attention_qkv_forward": [_P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P, _ROUTE],
    # q, k, v, out, bias, mask, batch, n, heads, head_dim, row_stride, n_w,
    # defer_norm, is_bf16, scale, device, stream, route
    "swin_window_attention_forward": [_P] * 6 + [_I] * 8 + [ctypes.c_float, _I, _P, _ROUTE],
    # x, scale, bias, out, rows, d, eps, is_bf16, device, stream, route
    "layer_norm_forward": [_P] * 4 + [_I, _I, ctypes.c_float, _I, _I, _P, _ROUTE],
    # x, norm_scale, norm_bias, w1, b1, w2, b2, out, y, hid, rows, d, hidden,
    # eps, is_bf16, device, stream, route
    "mlp_block_forward": [_P] * 10 + [_I] * 3 + [ctypes.c_float, _I, _I, _P, _ROUTE],
    # a, b, bias, resid, out, m, n, k, epilogue, device, stream
    "mlp_gemm_forward": [_P] * 5 + [_I] * 5 + [_P],
    # x, x_m, log_pi_t, w_mu, w_sigma, b_mu_t, b_sigma_t, ll, rows, d, k,
    # is_bf16, device, stream, route
    "gmm_forward": [_P] * 8 + [_I] * 5 + [_P, _ROUTE],
    # x, x_m, log_pi_t, g, ll, w_mu, w_sigma, b_mu_t, b_sigma_t, k0, kc, dmu,
    # dpre, bmu_part, bsig_part, dlp_part, dmu_sum, rows, d, k, is_bf16,
    # device, stream, route
    "gmm_backward_terms": [_P] * 9 + [_I] * 2 + [_P] * 6 + [_I] * 5 + [_P, _ROUTE],
    # x, x_m, dmu, dpre, dw_mu, dw_sigma, k0, kc, rows, d, k, is_bf16, device,
    # stream, route
    "gmm_backward_weights": [_P] * 6 + [_I] * 7 + [_P, _ROUTE],
    # dmu, dpre, w_mu, w_sigma, dmu_sum, dx, dx_part, k0, kc, first, last,
    # splits, rows, d, k, is_bf16, device, stream, route
    "gmm_backward_x": [_P] * 7 + [_I] * 10 + [_P, _ROUTE],
}


def device_index(t) -> int:
    """The CUDA device ordinal of tensor `t` (the entry points select it)."""
    import torch

    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def aligned_buffer(t, dtype):
    """Tensor `t` as a contiguous, 16-byte aligned buffer of `dtype` (no copy
    when it is one already): what every entry point takes. While
    `torch.export` traces, tensors have no storage: the buffer is only made
    contiguous, and the registered op's body aligns it when it runs."""
    import torch

    t = t.to(dtype).contiguous()
    if torch.compiler.is_exporting():
        return t
    return t.clone() if t.data_ptr() % 16 else t


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
