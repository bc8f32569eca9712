"""Build and load the CUDA kernels of `csrc/`.

The sources are compiled with nvcc for Hopper (`sm_90a`), one nvcc process
per source, all started together, and linked into one shared library with
a plain C interface, loaded with `ctypes` (no PyTorch headers: a build
takes seconds, not minutes).  The build runs at the first CUDA call,
never at import, into `onephase_tpu_torch/build/`; the library's name
carries a hash of the sources, so an edited source triggers a rebuild.
Processes that find no library at once (ranks of one job) build it once,
in turn (`_build`).

`clock_library` builds the measurement-only libraries: "chol",
`csrc/chol.cu` compiled with -DONEPHASE_CHOL_CLOCKS, whose entry points,
`op_chol_clocks_f32` and `op_chol_clocks_f64`, are K2 with clock64()
stamps at its phase boundaries (`ops/cholesky.py:chol_phases`), and
"tridiag", the sources of K7 and K5 compiled with
-DONEPHASE_TRIDIAG_CLOCKS, whose entry points
`op_tridiag_factor_clocks_f32` and `op_tridiag_solve_clocks_f32` stamp
theirs (`ops/tridiag_pallas.py:tridiag_phases`), and "tri_inv", K3's
inverse (`csrc/tri_inv.cu` with `tri_inv_mode.cuh`) compiled with
-DONEPHASE_TRI_INV_CLOCKS, whose entry point `op_tri_inv_clocks_f32`
stamps its phases (`ops/cholesky.py:tri_inv_phases`).  No solver path
calls them.  Each is built apart, at its first use, so that it does not
slow the kernels' build.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
_CLOCK_LIBS = {}
_CLOCK_LOCK = threading.Lock()
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
    # Jc, jc_bstride, w, H, h_bstride, bnd, Q, B, m, n, lower, mode, stream
    # (mode: a matmul mode's code, ops/precision.py Mode.code; 0 = IEEE)
    "op_fused_q": [_P, _LL, _P, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _P],
    # Q, L, d, ok, B, n, mode, stream
    "op_chol": [_P, _P, _P, _P, _I, _I, _I, _P],
    # L, Li, B, n, mode, stream
    "op_tri_inv": [_P, _P, _I, _I, _I, _P],
    # Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb, mode, stream
    "op_tridiag_factor": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # Ci, Ek, b, x, B, K, nb, mode, stream
    "op_tridiag_solve": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
}
# the clocked libraries (clock_library): name -> (sources, flag, {entry
# point: argtypes}); each entry point is its kernel's with the clock buffer
# (int64) before the stream
_CLOCKED = {
    # K2: Q, L, d, ok, B, n, mode, clk (B * 8, 8), stream
    "chol": (("chol.cu",), "-DONEPHASE_CHOL_CLOCKS",
             {"op_chol_clocks_f32": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
              "op_chol_clocks_f64": [_P, _P, _P, _P, _I, _I, _I, _P, _P]}),
    # K7 and K5 (clk (B, 8)), their arguments as op_tridiag_*
    "tridiag": (("tridiag.cu", "tridiag_factor_mode.cu",
                 "tridiag_solve_mode.cu"), "-DONEPHASE_TRIDIAG_CLOCKS",
                {"op_tridiag_factor_clocks_f32":
                     [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
                 "op_tridiag_solve_clocks_f32":
                     [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P]}),
    # K3's inverse: L, Li, B, n, mode, clk (B * ceil(n / 64), 8), stream
    "tri_inv": (("tri_inv.cu",), "-DONEPHASE_TRI_INV_CLOCKS",
                {"op_tri_inv_clocks_f32": [_P, _P, _I, _I, _I, _P, _P]}),
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


def _build(so: Path, srcs, nvcc: str, flags=()) -> str:
    """Compile `srcs` (one compiler process per source, all started
    together; `flags` added to each) and link them into the shared library
    `so`; returns the compiler's report, or "" when another process built
    `so` meanwhile.

    Processes that build one library at once (ranks of one job sharing the
    build directory) take turns on an advisory lock beside it, released
    by the OS if its holder dies; a later one finds the library and
    reuses it.  Objects and the unrenamed library carry the process id and
    are removed whatever happens, and the library appears by an atomic
    rename: no process ever loads a partial file."""
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return ""
        tag = f"{so.stem}.{os.getpid()}"
        objs = [so.with_name(f"{tag}.{src.stem}.o") for src in srcs]
        tmp = so.with_name(f"{tag}.so.tmp")
        outs = [so.with_name(f"{tag}.{src.stem}.log") for src in srcs]
        try:
            t0 = time.perf_counter()
            procs = []
            for src, obj, out in zip(srcs, objs, outs):
                with open(out, "w") as fh:
                    procs.append((
                        f"{src.name}{' ' + ' '.join(flags) if flags else ''}",
                        subprocess.Popen(
                            [nvcc, *NVCC_FLAGS, *flags, "-c", "-o",
                             str(obj), str(src)],
                            stdout=fh, stderr=subprocess.STDOUT)))
            # each compiler's wall seconds (the build waits for the longest)
            seconds = {}
            while len(seconds) < len(procs):
                for name, proc in procs:
                    if name not in seconds and proc.poll() is not None:
                        seconds[name] = time.perf_counter() - t0
                time.sleep(0.05)
            logs, failed = [], []
            for (name, proc), out in zip(procs, outs):
                logs.append(f"{name} ({seconds[name]:.1f} s):\n"
                            f"{out.read_text()}")
                if proc.returncode != 0:
                    failed.append(name)
            log = "\n".join(logs)
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
            cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
        finally:
            for f in (*objs, *outs, tmp):
                f.unlink(missing_ok=True)
    return log


def library():
    """The loaded kernel library, built first if needed."""
    global _LIB, BUILD_SECONDS, BUILD_LOG
    if _LIB is not None:
        return _LIB
    srcs = sorted(CSRC.glob("*.cu"))
    so = BUILD_DIR / f"libonephase_kernels_{_source_hash(srcs + sorted(CSRC.glob('*.cuh')))}.so"
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_LOG = _build(so, srcs, _nvcc())
    BUILD_SECONDS = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def clock_library(name: str = "chol"):
    """The measurement library `name` ("chol", "tridiag" or "tri_inv"; see
    the module
    docstring), built first if needed; safe to call from several threads
    (chip_smoke.py builds the "chol" one in a thread while the card
    works)."""
    files, flag, entries = _CLOCKED[name]
    with _CLOCK_LOCK:
        if name not in _CLOCK_LIBS:
            srcs = [CSRC / f for f in files]
            tag = _source_hash([*srcs, *sorted(CSRC.glob("*.cuh"))])
            so = BUILD_DIR / f"libonephase_{name}_clocks_{tag}.so"
            if not so.exists():
                _build(so, srcs, _nvcc(), flags=[flag])
            lib = ctypes.CDLL(str(so))
            for entry_name, argtypes in entries.items():
                fn = getattr(lib, entry_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _CLOCK_LIBS[name] = lib
    return _CLOCK_LIBS[name]


def entry(name: str, dtype):
    """The C entry point `name` for a float32/float64 tensor dtype."""
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: CUDA kernels take float32 or float64, "
                        f"not {dtype}")
    return getattr(library(), name + suffix)


def launch(name: str, t, *args) -> int:
    """Call the entry point `name` for the dtype of the CUDA tensor `t` with
    `args` and the current stream of t's device; t's device is made
    current for the call only where it is not already.  Returns the
    entry point's error code."""
    fn = entry(name, t.dtype)
    idx = t.get_device()
    if idx == torch.cuda.current_device():
        return fn(*args, _raw_stream(idx))
    with torch.cuda.device(idx):
        return fn(*args, _raw_stream(idx))


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def _raw_stream(idx: int) -> int:
    """The current stream of CUDA device `idx` as an address (torch's raw
    stream query: no Stream object a call)."""
    return torch._C._cuda_getCurrentRawStream(idx)


def stream_ptr(t) -> int:
    return _raw_stream(t.get_device())


def ptr(t):
    return None if t is None else t.data_ptr()
