"""Builds the CUDA kernels with nvcc and binds them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and includes no PyTorch
header, so a build takes seconds.  The shared library goes into
``covid19uk_tpu_torch/_build/`` (listed in ``.gitignore``) under a name
that carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  A failed build raises
with nvcc's output.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parents[1]
_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = _PKG / "_build"

# -fmad=false: no contraction of a*b+c into one rounding, so the kernel
# rounds each float32 operation as the plain PyTorch version does and the
# two make the same accept/reject decisions.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-fmad=false",
]


class Built(NamedTuple):
    lib: ctypes.CDLL
    log: str  # nvcc's output (ptxas: registers, shared memory, spills)
    seconds: float  # build time, 0.0 when the library was already built


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def build(name, defines=()):
    """Compiles ``csrc/<name>.cu`` (with ``-D`` of each of ``defines``)
    into a shared library and loads it."""
    src = _CSRC / f"{name}.cu"
    text = src.read_bytes()
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    digest = hashlib.sha256(text + " ".join(flags).encode())
    tag = digest.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{tag}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {src}:\n"
                f"{' '.join(cmd)}\n{log}"
            )
        log_path.write_text(log)
        os.replace(tmp, out)
    log = log_path.read_text() if log_path.exists() else ""
    return Built(ctypes.CDLL(str(out)), log, seconds)


def bind_fused_sweep(lib):
    """Declares the C interface of ``csrc/fused_sweep.cu`` on ``lib``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.fused_sweep_launch
    # 12 inputs, 5 outputs, the workspace, 12 ints, the guided flag, the
    # two input layouts and the float4 flag, 2 floats, the stream
    fn.argtypes = [p] * 18 + [i] * 12 + [i] * 4 + [f, f, p]
    fn.restype = ctypes.c_int
    err = lib.fused_sweep_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def bind_block_sparse(lib):
    """Declares the C interface of ``csrc/block_sparse.cu`` on ``lib``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.bsr_matmul_launch
    # values, col_idx, slots, order, perm, x, y, then R, the rows of
    # order to launch, K, M, S, T, the days of a thread block, the stream
    fn.argtypes = [p] * 7 + [i] * 7 + [p]
    fn.restype = ctypes.c_int
    shared = lib.bsr_matmul_shared_bytes  # dynamic shared memory a block
    shared.argtypes = [i, i]
    shared.restype = ctypes.c_longlong
    err = lib.block_sparse_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


_BINDERS = {"fused_sweep": bind_fused_sweep,
            "block_sparse": bind_block_sparse}


@functools.cache
def library(name):
    """The kernel library ``csrc/<name>.cu``, built at first use."""
    built = build(name)
    _BINDERS[name](built.lib)
    return built


def fused_sweep_library():
    """The fused event-sweep kernel (K1)."""
    return library("fused_sweep")


@functools.cache
def fused_sweep_phase_library():
    """K1 built with ``-DK1_PHASES``: it also counts each phase's cycles
    (thread 0's clock64, per block), read and zeroed by
    ``fused_sweep_phase_cycles``; for profile_torch.py."""
    lib = bind_fused_sweep(build("fused_sweep", ("K1_PHASES",)).lib)
    fn = lib.fused_sweep_phase_cycles
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def block_sparse_library():
    """The block-sparse product kernel (K2)."""
    return library("block_sparse")


def build_all():
    """Builds every kernel library at once, one nvcc process per source
    started together; returns ``{name: Built}``."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(_BINDERS)) as pool:
        return dict(zip(_BINDERS, pool.map(library, _BINDERS)))


def error_string(fn, code):
    """CUDA's name for an error code, from a library's ``*_error_string``
    function ``fn``."""
    msg = fn(code)
    return msg.decode() if msg else "unknown"
