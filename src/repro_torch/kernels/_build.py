"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries go to ``_build/`` beside ``csrc/`` (listed in
``.gitignore``) under a name that carries a digest of the sources and flags,
so an edited source is rebuilt and a stale library is never loaded.  The
first kernel call builds every stale source, one ``nvcc`` process per source,
all started together.  Nothing here runs at import: the CPU tests import
every module of the port on hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
SOURCES = ("systolic_mmm", "systolic_qmm", "flash_attn", "grouped_mmm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_build_log: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the one under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels build only on a host with CUDA")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing; returns the seconds taken.

    Raises RuntimeError with the compiler's output if any build fails.
    """
    t0 = time.perf_counter()
    todo = [(n, library_path(n)) for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        _build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log() -> dict[str, str]:
    """The compiler output (ptxas register/shared-memory report) of this process's builds."""
    return dict(_build_log)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, what: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


# ---------------------------------------------------------------------------
# Launch queries: each library's ``<name>_query`` entry point runs its
# launcher with a ``LaunchQuery`` (csrc/common.cuh) instead of launching, and
# reports what that launch would run.  The bindings in ``kernels/*/kernel.py``
# hold these against their Python accounting (``launch_of``), which is what
# ``repro_torch.check.audit`` checks on the card.
# ---------------------------------------------------------------------------

QUERY_FIELDS = 11  # csrc/common.cuh QUERY_FIELDS


class Launch(NamedTuple):
    """What one launch runs: grid (x, y, z), threads per block, dynamic
    shared memory bytes, split-K slices and the contraction per slice (0
    when the contraction is not split)."""

    grid: tuple[int, int, int]
    threads: int
    dyn_smem: int
    splits: int = 1
    k_chunk: int = 0


class Compiled(NamedTuple):
    """``cudaFuncGetAttributes`` of the kernel a launch runs: registers per
    thread, static shared memory bytes, local (spill) bytes per thread and
    the most threads a block of it may have."""

    regs: int
    static_smem: int
    local_bytes: int
    max_threads: int


def query(lib: ctypes.CDLL, fn_name: str, *args: int) -> tuple[Launch, Compiled]:
    """(Launch, Compiled) of library ``lib``'s ``fn_name`` query at ``args``;
    raises with the CUDA error when the launch's own checks refuse them."""
    out = (ctypes.c_longlong * QUERY_FIELDS)()
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    check(lib, fn_name, fn(*args, out))
    v = [int(x) for x in out]
    return Launch((v[0], v[1], v[2]), v[3], v[4], v[5], v[6]), Compiled(*v[7:11])
