"""ctypes binding of the native C++ image decoder `native/dataio.cpp` (port
of `vit_ad_tpu/data/native.py`).

The port builds the JAX package's one source, unchanged and with the same
`g++ -O3 -shared ... -lpng -ljpeg -lz -lpthread` command, into its own
git-ignored `vit_ad_tpu_torch/_build/` at first use, and rebuilds it when the
source is newer; the library is replaced atomically (a temporary file and
`os.replace`), so a concurrent process never loads a half-written one. Both
packages decode with the same code, so their images agree bit for bit.

Where the library cannot be built or loaded (no compiler, no libpng or
libjpeg headers), or `VITAD_NO_NATIVE=1` is set, the data layer decodes with
PIL (`data/dataset.py`), as the JAX package does; this module says so once,
in one logged line naming the reason. `decoder()` says which decoder runs.
The first answer is kept for the process (`_tried`, `_lib`).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

_PACKAGE = Path(__file__).resolve().parents[1]
SRC = _PACKAGE.parent / "native" / "dataio.cpp"
SO = _PACKAGE / "_build" / "libvitad_dataio.so"

_log = logging.getLogger(__name__)
_lib: Optional[ctypes.CDLL] = None
_tried = False
# why PIL decodes instead ("" while the native library is loaded or untried)
reason = ""


def _build() -> str:
    """Compile SRC into SO; return "" on success, else why it failed."""
    SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = SO.with_name(f"{SO.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", str(tmp), str(SRC), "-lpng", "-ljpeg", "-lz", "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ did not run: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        first = next((ln for ln in proc.stderr.splitlines() if "error" in ln), proc.stderr[-200:])
        return f"g++ failed with exit code {proc.returncode}: {first.strip()}"
    os.replace(tmp, SO)
    return ""


def _without(why: str, level: int = logging.WARNING) -> None:
    global reason
    reason = why
    _log.log(level, "native image decoder not used (%s): decoding with PIL", why)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built if needed; None when PIL decodes."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("VITAD_NO_NATIVE") == "1":
        _without("VITAD_NO_NATIVE=1", logging.INFO)
        return None
    if not SRC.is_file():
        _without(f"{SRC} is missing")
        return None
    if not SO.exists() or SO.stat().st_mtime < SRC.stat().st_mtime:
        why = _build()
        if why:
            _without(why)
            return None
    try:
        lib = ctypes.CDLL(str(SO))
    except OSError as e:
        _without(f"{SO} does not load: {e}")
        return None
    out = ctypes.POINTER(ctypes.c_uint8)
    lib.vitad_load_image.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, out]
    lib.vitad_load_image.restype = ctypes.c_int
    lib.vitad_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, out, ctypes.c_int]
    lib.vitad_load_batch.restype = ctypes.c_int
    lib.vitad_load_mask.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, out]
    lib.vitad_load_mask.restype = ctypes.c_int
    _lib = lib
    return _lib


def decoder() -> str:
    """"native" when the C++ library decodes, else "pil"."""
    return "native" if get_lib() is not None else "pil"


def _out_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def load_image(path: str, img_size: int) -> Optional[np.ndarray]:
    """Decode + bilinear resize → uint8 [img_size, img_size, 3], or None when
    the library is unavailable or rejects the file."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((img_size, img_size, 3), dtype=np.uint8)
    rc = lib.vitad_load_image(path.encode(), img_size, img_size, _out_ptr(out))
    return out if rc == 0 else None


def load_batch(paths: List[str], img_size: int, n_threads: int = 0) -> Optional[np.ndarray]:
    """[N, H, W, 3] uint8 decoded by the library's thread pool (`n_threads`,
    by default one per file up to the host's cores), or None when the library
    is unavailable or any file fails."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, img_size, img_size, 3), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if n_threads <= 0:
        n_threads = min(n, os.cpu_count() or 1)
    failures = lib.vitad_load_batch(arr, n, img_size, img_size, _out_ptr(out), n_threads)
    return out if failures == 0 else None


def load_mask(path: str, img_size: int) -> Optional[np.ndarray]:
    """[H, W] uint8 binary mask, or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((img_size, img_size), dtype=np.uint8)
    rc = lib.vitad_load_mask(path.encode(), img_size, img_size, _out_ptr(out))
    return out if rc == 0 else None
