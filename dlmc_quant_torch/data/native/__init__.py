"""ctypes bindings for the host's native data kernels: batch assembly
(``augment.cpp``) and JPEG decode + crop + resize (``jpegdec.cpp``).

Counterpart of ``dlmc_quant_tpu/data/native`` with its own copies of the
sources.  Each library is built with g++ at first use, from the source
beside this file only, into ``_build/`` (git-ignored), named by a hash of
the source and the build command, so that an edited source is never
served by a stale build.  The compiler writes a temporary file that is
then renamed into place, so that processes building at once never load a
half-written library.  Where the build fails (no g++; for the decoder, no
libjpeg headers) or ``DLMCQ_NO_NATIVE=1`` is set, :func:`available` /
:func:`jpeg_available` say False and the callers take their numpy / PIL
paths.

The batch assembly draws no randomness: the caller passes crop offsets and
flips drawn from its numpy Generator, and the pass computes what the numpy
path computes, operation for operation, so both give the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(source: str, link: str) -> Path:
    """Where the build of ``source`` (a file beside this one), as its text
    stands, linked with ``link``, lives."""
    digest = hashlib.sha256((HERE / source).read_bytes())
    digest.update(" ".join((*FLAGS, link)).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:12]}.so"


def build(source: str, link: str, force: bool = False) -> Path:
    """Compile ``source`` unless a build of its current text exists (or
    ``force``); returns the library's path.  Raises ``RuntimeError`` with
    the compiler's report when g++ is missing or fails."""
    lib = library_path(source, link)
    if lib.exists() and not force:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(HERE / source), link]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib


class _Native:
    """One library, built and loaded once a process; ``error`` says why
    it is unavailable."""

    def __init__(self, source: str, link: str, abi: str,
                 declare: Callable[[ctypes.CDLL], None]):
        self.source, self.link, self.abi, self.declare = (source, link, abi,
                                                          declare)
        self.lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None
        self.tried = False
        self.error: Optional[str] = None

    def load(self) -> Optional[ctypes.CDLL]:
        with self.lock:
            if self.tried:
                return self.lib
            self.tried = True
            if os.environ.get("DLMCQ_NO_NATIVE") == "1":
                self.error = "DLMCQ_NO_NATIVE=1"
                return None
            try:
                try:
                    lib = ctypes.CDLL(str(build(self.source, self.link)))
                except OSError:
                    # a build copied from another host, whose libraries
                    # this one lacks: build it here
                    lib = ctypes.CDLL(str(build(self.source, self.link,
                                                force=True)))
                getattr(lib, self.abi).restype = ctypes.c_int
                if getattr(lib, self.abi)() != 1:
                    raise RuntimeError(f"{self.source}: ABI version "
                                       f"{getattr(lib, self.abi)()}, not 1")
                self.declare(lib)
            except (OSError, RuntimeError) as e:
                self.error = str(e)
                return None
            self.lib = lib
            return lib


def _declare_augment(lib: ctypes.CDLL) -> None:
    lib.dlmcq_augment.restype = ctypes.c_int
    lib.dlmcq_augment.argtypes = [
        ctypes.c_void_p, ctypes.c_int,                      # images, is_u8
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,     # h w c
        ctypes.c_void_p, ctypes.c_int64,                    # idx, n
        ctypes.c_int,                                       # pad
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # oy ox flip
        ctypes.c_void_p, ctypes.c_void_p,                   # mean std
        ctypes.c_int, ctypes.c_int,                         # scale255, threads
        ctypes.c_void_p,                                    # out
    ]


def _declare_jpeg(lib: ctypes.CDLL) -> None:
    lib.dlmcq_jpeg_dims.restype = ctypes.c_int
    lib.dlmcq_jpeg_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.dlmcq_decode_resize.restype = ctypes.c_int
    lib.dlmcq_decode_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


AUGMENT = _Native("augment.cpp", "-lpthread", "dlmcq_abi_version",
                  _declare_augment)
# a library of its own: it needs libjpeg, which may be absent
JPEG = _Native("jpegdec.cpp", "-ljpeg", "dlmcq_jpeg_abi_version",
               _declare_jpeg)


def available() -> bool:
    """Whether the native batch assembly can run here."""
    return AUGMENT.load() is not None


def _ptr(a: Optional[np.ndarray]):
    return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None


def augment_gather(images: np.ndarray, idx: np.ndarray, *,
                   pad: int = 0,
                   oy: Optional[np.ndarray] = None,
                   ox: Optional[np.ndarray] = None,
                   flip: Optional[np.ndarray] = None,
                   mean: Optional[np.ndarray] = None,
                   std: Optional[np.ndarray] = None,
                   scale255: bool = False,
                   n_threads: int = 0) -> np.ndarray:
    """``images[idx]`` → /255 → zero-pad crop → flip →
    ``(x - mean) / std``, float32 NHWC, in one threaded pass.

    ``oy``/``ox`` are crop offsets in [0, 2*pad] (padded coordinates),
    ``flip`` a bool/uint8 mask, each of length ``len(idx)``; the offsets are
    needed when ``pad > 0``.  Raises ``RuntimeError`` when the library is
    unavailable (callers check :func:`available`).
    """
    lib = AUGMENT.load()
    if lib is None:
        raise RuntimeError(f"native batch assembly unavailable: "
                           f"{AUGMENT.error}")
    images = np.ascontiguousarray(images)
    is_u8 = images.dtype == np.uint8
    if not is_u8:
        images = images.astype(np.float32, copy=False)
    n_total, h, w, c = images.shape
    idx = np.ascontiguousarray(idx, np.int64)
    n = len(idx)
    if n and not (0 <= idx.min() and idx.max() < n_total):
        raise IndexError(f"indices outside [0, {n_total})")
    out = np.empty((n, h, w, c), np.float32)
    oy32 = np.ascontiguousarray(oy, np.int32) if oy is not None else None
    ox32 = np.ascontiguousarray(ox, np.int32) if ox is not None else None
    fl8 = np.ascontiguousarray(flip, np.uint8) if flip is not None else None
    mean32 = std32 = None
    if mean is not None:
        mean32 = np.ascontiguousarray(np.broadcast_to(mean, (c,)), np.float32)
        std32 = np.ascontiguousarray(np.broadcast_to(std, (c,)), np.float32)
    if pad > 0 and (oy32 is None or ox32 is None):
        raise ValueError("pad > 0 requires oy/ox offsets")
    for name, a, hi in (("oy", oy32, 2 * pad), ("ox", ox32, 2 * pad),
                        ("flip", fl8, 1)):
        if a is not None and (a.shape != (n,) or (n and not (
                0 <= a.min() and a.max() <= hi))):
            raise ValueError(f"{name} needs {n} values in [0, {hi}]")
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    rc = lib.dlmcq_augment(
        _ptr(images), int(is_u8), h, w, c, _ptr(idx), n, pad,
        _ptr(oy32), _ptr(ox32), _ptr(fl8), _ptr(mean32), _ptr(std32),
        int(scale255), n_threads, _ptr(out))
    if rc != 0:
        raise RuntimeError(f"dlmcq_augment failed with rc={rc}")
    return out


def jpeg_available() -> bool:
    """Whether the native JPEG decoder can run here."""
    return JPEG.load() is not None


def jpeg_dims(data: bytes):
    """(width, height) from a JPEG byte buffer, or None on failure."""
    lib = JPEG.load()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.dlmcq_jpeg_dims(data, len(data), ctypes.byref(w),
                           ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def jpeg_decode_resize(data: bytes, crop, out_size, flip: bool = False):
    """Decode a JPEG buffer, crop, resize bilinearly and flip, natively.

    ``crop`` is (left, top, w, h) in the original image's coordinates, or
    None for the full frame; ``out_size`` is (out_h, out_w).  libjpeg's DCT
    scaling decodes at 1/2..1/8 of the size when the target is that much
    smaller.  Returns u8 RGB (out_h, out_w, 3), or None on failure (the
    caller falls back to PIL).
    """
    lib = JPEG.load()
    if lib is None:
        return None
    oh, ow = out_size
    cl, ct, cw, ch = crop if crop is not None else (0, 0, -1, -1)
    out = np.empty((oh, ow, 3), np.uint8)
    rc = lib.dlmcq_decode_resize(data, len(data), int(cl), int(ct),
                                 int(cw), int(ch), int(ow), int(oh),
                                 int(bool(flip)), _ptr(out))
    return out if rc == 0 else None
