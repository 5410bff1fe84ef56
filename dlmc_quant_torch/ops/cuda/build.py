"""One nvcc builder for every kernel source in ``csrc/``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``_build/lib<name>_<hash>.so`` beside this file, compiled for
``sm_90a`` and loaded through ``ctypes``.  The hash covers the source and
the ``csrc/`` files it includes with ``#include "..."``, theirs too, so an
edited
kernel is never served by a stale build and editing one kernel rebuilds
only that one.  Sources are compiled at first use; :func:`build` starts one
``nvcc`` per source that needs it, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.MULTILINE)
# every kernel source of csrc/: the 3x3 conv (ungrouped, and its grouped
# build), the GEMM, the im2col, the ImageNet stem conv + pool, the
# depthwise 3x3 conv, the window sums of a weight offset's row term and the
# MMA probe
SOURCES = ("int8_conv3x3", "int8_conv3x3_grouped", "int8_gemm",
           "int8_im2col", "int8_stem_pool", "int8_dwconv3x3",
           "int8_window_sum", "int8_mma_probe")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu``, as its text stands, lives."""
    digest, seen = hashlib.sha256(), set()

    def add(file: str) -> None:
        if file in seen:
            return
        seen.add(file)
        text = (CSRC / file).read_bytes()
        digest.update(text)
        for header in _INCLUDE.findall(text):
            add(header.decode())

    add(f"{name}.cu")
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def nvcc_path() -> str:
    """The CUDA compiler; raises where there is none."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "on this machine")
    return nvcc


def build(*names: str, verbose: bool = False) -> list:
    """Compile each ``csrc/<name>.cu`` that has no build of its current text.

    One ``nvcc`` process per source, all started together and all waited
    for.  Returns the libraries' paths in the order of ``names``; with
    ``verbose`` prints each compiler report (registers, spills, shared
    memory).  Raises when ``nvcc`` is missing or a source does not compile.
    """
    libs = [library_path(name) for name in names]
    todo = [(name, lib) for name, lib in zip(names, libs) if not lib.exists()]
    if not todo:
        return libs
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, lib in todo:
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        jobs.append((name, lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, lib, tmp, proc in jobs:
        _, report = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu ({proc.returncode}):"
                            f"\n{report}")
            continue
        if verbose:
            print(f"# nvcc {name}.cu:\n{report.strip()}")
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed.

    Every source exports ``dlmcq_cuda_error_string``; the caller declares
    the types of its own entry points.
    """
    lib = ctypes.CDLL(str(build(name)[0]))
    lib.dlmcq_cuda_error_string.restype = ctypes.c_char_p
    lib.dlmcq_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError()``)."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.dlmcq_cuda_error_string(err).decode())
