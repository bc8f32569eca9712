"""Build and load the CUDA kernels of `csrc/`.

The sources are compiled with nvcc for Hopper (`sm_90a`) into one shared
library with a plain C interface, loaded with `ctypes` (no PyTorch headers:
a build takes seconds, not minutes).  The build runs at the first CUDA call,
never at import, into `onephase_tpu_torch/build/`; the library's name
carries a hash of the sources, so an edited source triggers a rebuild.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
# wall seconds of the build step in this process (0-ish when the library
# for these sources already existed) and the compiler's report (-Xptxas -v:
# registers, shared memory and spills per kernel)
BUILD_SECONDS = None
BUILD_LOG = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# C entry points: name -> argtypes (every one returns cudaGetLastError())
_SIGNATURES = {
    # Jc, jc_bstride, w, H, h_bstride, bnd, Q, B, m, n, lower, stream
    "op_fused_q": [_P, _LL, _P, _P, _LL, _P, _P, _I, _I, _I, _I, _P],
    # Q, L, d, ok, B, n, stream
    "op_chol": [_P, _P, _P, _P, _I, _I, _P],
    # L, Li, B, n, stream
    "op_tri_inv": [_P, _P, _I, _I, _P],
}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash(files) -> str:
    h = hashlib.sha256()
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library():
    """The loaded kernel library, built first if needed."""
    global _LIB, BUILD_SECONDS, BUILD_LOG
    if _LIB is not None:
        return _LIB
    srcs = sorted(CSRC.glob("*.cu"))
    so = BUILD_DIR / f"libonephase_kernels_{_source_hash(srcs + sorted(CSRC.glob('*.cuh')))}.so"
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        BUILD_LOG = proc.stdout + proc.stderr
        os.replace(tmp, so)
    BUILD_SECONDS = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def entry(name: str, dtype):
    """The C entry point `name` for a float32/float64 tensor dtype."""
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: CUDA kernels take float32 or float64, "
                        f"not {dtype}")
    return getattr(library(), name + suffix)


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t):
    return None if t is None else t.data_ptr()
