"""Build the CUDA kernels of ``csrc/`` into one shared library and load it.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) into
``build/kernels/`` beside the package, the first time a kernel is launched
on a CUDA tensor; importing the package builds nothing.  The library has a
plain C interface and is loaded with ``ctypes``, so no PyTorch headers
are compiled.  Its file name carries a hash of the sources and flags, so
an edited kernel is rebuilt and a stale library is never loaded.  Each
entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` turns a nonzero code into an
exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # xi, xp, recip, disc, d, nb, n, p, mixed, stream
    "fs_relief_pass1": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # xi, xp, w, recip, disc, partial, nb, n, p, mixed, stream
    "fs_relief_pass2": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfastselect_kernels_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under $CUDA_HOME (default
    /usr/local/cuda).  Raises RuntimeError when there is none."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
        if (home / "bin" / "nvcc").is_file():
            nvcc = str(home / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc, the CUDA compiler, was not found on PATH or in "
            "$CUDA_HOME/bin (default /usr/local/cuda/bin); it is needed to "
            "build the CUDA kernels in fastselect_tpu_torch/csrc. Install "
            "the CUDA toolkit or put its bin directory on PATH.")
    return nvcc


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for them already exists.

    The library is written under a temporary name and renamed, so a
    concurrent or interrupted build never leaves a partial file behind.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fs_cuda_error_string.argtypes = (ctypes.c_int,)
        lib.fs_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = load().fs_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({msg})")
