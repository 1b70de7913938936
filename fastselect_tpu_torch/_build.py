"""Build the CUDA kernels of ``csrc/`` into one shared library and load it.

``nvcc`` compiles each ``csrc/*.cu`` for Hopper (``sm_90a``), all sources
at once in parallel, and links them into one library in ``build/kernels/``
beside the package, the first time a kernel is launched on a CUDA tensor;
importing the package builds nothing.  The library has a plain C
interface and is loaded with ``ctypes``, so no PyTorch headers are
compiled.  Its file name carries a hash of the sources (headers included)
and flags, so an edited kernel is rebuilt and a stale library is never
loaded.  ``ptxas``'s report of each kernel's registers and spills is
kept beside it (:func:`ptxas_report`).  Each entry point
launches on the stream it is given and returns ``cudaGetLastError()``;
:func:`check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # xi, xp, recip, d, partial, nb, n, p, split, splits, stream
    "fs_relief_pass1_cont": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # xi, xp, recip, disc, d, partial, nb, n, p, split, splits, stream
    "fs_relief_pass1_mixed": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _P),
    # xi, xp, w, recip, partial, nb, n, p, groups, rows, span, stream
    "fs_relief_pass2_cont": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P),
    # xi, xp, w, recip, disc, partial, nb, n, p, p_disc, groups, rows, span,
    # stream
    "fs_relief_pass2_mixed": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _P),
}

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    """The kernel sources and the headers they include."""
    return sorted(CSRC.glob("*.cu*"))


def _units() -> list[Path]:
    """The sources nvcc compiles, one object each."""
    return [src for src in _sources() if src.suffix == ".cu"]


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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


def _start(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(cmd: list[str], proc: subprocess.Popen) -> str:
    """The stderr of ``cmd`` once it has ended; RuntimeError if it
    failed."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{out}{err}")
    return err


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for them already exists.

    One ``nvcc`` per source, all started together, then one link.  The
    library is written under a temporary name and renamed, so a concurrent
    or interrupted build never leaves a partial file behind.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in _units()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for obj, src in zip(objs, _units())]
        jobs = []
        try:
            jobs = [(cmd, _start(cmd)) for cmd in cmds]
            report = "".join(_wait(cmd, proc) for cmd, proc in jobs)
        finally:   # a failed compile stops the others
            for _, proc in jobs:
                proc.kill()
                proc.wait()
        lib = str(Path(tmp) / "lib.so")
        link = [nvcc, *LINK_FLAGS, "-o", lib, *objs]
        _wait(link, _start(link))
        out.with_suffix(".ptxas.txt").write_text(report)
        os.replace(lib, out)
    return out


def ptxas_report() -> list[tuple[str, int, int]]:
    """(mangled kernel name, registers, spill store bytes) of every kernel
    in the built library, from ``ptxas -v``."""
    text = library_path().with_suffix(".ptxas.txt").read_text()
    rows = []
    for block in text.split("Compiling entry function ")[1:]:
        name = re.match(r"'([^']+)'", block).group(1)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        rows.append((name, int(regs.group(1)) if regs else 0,
                     int(spill.group(1)) if spill else 0))
    return rows


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
