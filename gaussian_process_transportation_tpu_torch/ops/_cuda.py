"""Build and load the package's native code.

Each CUDA kernel is one source file ``csrc/<name>.cu`` with a plain
``extern "C"`` entry point.  At first use it is compiled with ``nvcc`` for
Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` and loaded with
ctypes.  The host code (``csrc/<name>.cpp``: the random forest's split
search) is built the same way with ``g++``.  The hash is over the source
and the flags, so a changed source rebuilds and an unchanged one is
reused.  Nothing is built at import, and a missing compiler or a failed
build raises with the compiler's output.  A process that has
``GPT_TORCH_NO_BUILD`` set (the ranks of ``parallel._launch``) only loads:
where the build is missing it raises instead of compiling.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# no FMA contraction: the split search's scores round as its numpy twin's
GXX_FLAGS = ("-std=c++17", "-O3", "-ffp-contract=off", "-shared", "-fPIC")
NO_BUILD_ENV = "GPT_TORCH_NO_BUILD"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _compile(src: Path, compiler: str, flags: tuple) -> Path:
    """``src`` compiled with ``compiler`` and ``flags`` into a shared library
    under ``_build/`` named by a hash of the source and flags, unless that
    build exists; the compiler's output is kept beside it as ``.log``."""
    name = src.stem
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    if lib.exists():
        return lib
    if os.environ.get(NO_BUILD_ENV):
        raise RuntimeError(f"{lib.name} is not built and {NO_BUILD_ENV} forbids building it "
                           "here: build it in the launching process first")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{os.path.basename(compiler)} failed ({proc.returncode}) building {src.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` with nvcc unless a build of the same
    source and flags exists; returns the shared library's path.  nvcc's
    output (register and spill counts from ``-Xptxas -v``) is kept beside
    it as ``.log``."""
    return _compile(SRC_DIR / f"{name}.cu", _nvcc(), NVCC_FLAGS)


def build_host(name: str) -> Path:
    """Compile the host source ``csrc/<name>.cpp`` with g++, as :func:`build`."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: put it on PATH to build the host code")
    return _compile(SRC_DIR / f"{name}.cpp", gxx, GXX_FLAGS)


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    return ctypes.CDLL(str(build(name)))


@functools.lru_cache(maxsize=None)
def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library ``name``, built first if needed."""
    return ctypes.CDLL(str(build_host(name)))
