#!/usr/bin/env python3
"""Which float64 mma.sync shapes the installed nvcc takes for sm_90a, how
fast each runs on the card, and how each rounds.

    python3 tools/dmma_probe.py

For each shape (m8n8k4, the sm_80 DMMA, and Hopper's m16n8k4, m16n8k8 and
m16n8k16) the script compiles a small source with nvcc (a shape the
compiler refuses is reported as such), then:
- throughput: every warp of 132 x 8 blocks runs 4 independent chains of
  the mma on register operands; operations (2 M N K a product) over the
  kernel's CUDA-event time, in TFLOP/s;
- values: one warp forms D = C + A B for random A, B, C (row-major in
  global memory, loaded by the fragment layout the kernels use), and D is
  compared with a plain product in float64 on the card (the layout check:
  it must agree to rounding) and, bit for bit, with two chains of fma on
  the FP64 cores: k ascending (K1's IEEE order, acc = fma(a_k, b_k, acc)
  from acc = C) and the exact sum rounded once.

Prints one line a shape, then one JSON object.  Needs the card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "onephase_tpu_torch" / "build" / "dmma_probe"

# name: (M, N, K, A registers, B registers, C registers)
SHAPES = {"m8n8k4": (8, 8, 4, 1, 1, 2), "m16n8k4": (16, 8, 4, 2, 1, 4),
          "m16n8k8": (16, 8, 8, 4, 2, 4), "m16n8k16": (16, 8, 16, 8, 4, 4)}

SOURCE = r"""
#include <cuda_runtime.h>
constexpr int M = @M@, N = @N@, K = @K@, NA = @NA@, NB = @NB@, NC = @NC@;

__device__ __forceinline__ void mma(double (&d)[NC], const double (&a)[NA],
                                    const double (&b)[NB]) {
  asm(@ASM@);
}

// a_i = A[g + 8 (i % 2)][t + 4 (i / 2)] (m8n8k4: A[g][t]); b_i =
// B[t + 4 i][g]; c: C[g + 8 (i / 2)][2 t + i % 2]
__device__ __forceinline__ int a_row(int g, int i) {
  return M == 8 ? g : g + 8 * (i % 2);
}
__device__ __forceinline__ int a_col(int t, int i) {
  return M == 8 ? t : t + 4 * (i / 2);
}

extern "C" __global__ void thr(double* out, int iters) {
  double a[NA], b[NB], c[4][NC];
  for (int i = 0; i < NA; ++i) a[i] = 1.0 + 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < NB; ++i) b[i] = 1.0 - 1e-3 * (threadIdx.x + i);
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < NC; ++i) c[j][i] = 0.0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma(c[j], a, b);
  double s = 0.0;
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < NC; ++i) s += c[j][i];
  if (s == 12345.0) out[0] = s;
}

extern "C" __global__ void one(const double* A, const double* B,
                               const double* C, double* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[NA], b[NB], d[NC];
  for (int i = 0; i < NA; ++i) a[i] = A[a_row(g, i) * K + a_col(t, i)];
  for (int i = 0; i < NB; ++i) b[i] = B[(t + 4 * i) * N + g];
  for (int i = 0; i < NC; ++i) d[i] = C[(g + 8 * (i / 2)) * N + 2 * t + i % 2];
  mma(d, a, b);
  for (int i = 0; i < NC; ++i) D[(g + 8 * (i / 2)) * N + 2 * t + i % 2] = d[i];
}

extern "C" __global__ void chain(const double* A, const double* B,
                                 const double* C, double* D) {
  const int i = threadIdx.x / N, j = threadIdx.x % N;
  double d = C[i * N + j];
  for (int k = 0; k < K; ++k) d = fma(A[i * K + k], B[k * N + j], d);
  D[i * N + j] = d;
}

extern "C" int run_thr(void* out, int blocks, int iters, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  thr<<<blocks, 256>>>((double*)out, 1);
  cudaEventRecord(e0);
  thr<<<blocks, 256>>>((double*)out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}

extern "C" int run_one(const void* A, const void* B, const void* C, void* D,
                       void* E) {
  one<<<1, 32>>>((const double*)A, (const double*)B, (const double*)C,
                 (double*)D);
  chain<<<1, M * N>>>((const double*)A, (const double*)B, (const double*)C,
                      (double*)E);
  cudaDeviceSynchronize();
  return (int)cudaGetLastError();
}
"""


def _asm(name, na, nb, nc) -> str:
    d = ", ".join(f"%{i}" for i in range(nc))
    a = ", ".join(f"%{nc + i}" for i in range(na))
    b = ", ".join(f"%{nc + na + i}" for i in range(nb))
    outs = ", ".join(f'"+d"(d[{i}])' for i in range(nc))
    ins = ", ".join([f'"d"(a[{i}])' for i in range(na)]
                    + [f'"d"(b[{i}])' for i in range(nb)])
    return (f'"mma.sync.aligned.{name}.row.col.f64.f64.f64.f64 '
            f'{{{d}}}, {{{a}}}, {{{b}}}, {{{d}}};" : {outs} : {ins}')


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    return str(Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else "nvcc"


def _two_sum_rounded(A, B, C):
    """C + A B with every product exact and the sum rounded once (Python
    fractions on the host)."""
    from fractions import Fraction
    M, K = A.shape
    N = B.shape[1]
    D = np.empty((M, N))
    for i in range(M):
        for j in range(N):
            s = Fraction(C[i, j])
            for k in range(K):
                s += Fraction(A[i, k]) * Fraction(B[k, j])
            D[i, j] = float(s)
    return D


def probe(name, dev, rng) -> dict:
    M, N, K, na, nb, nc = SHAPES[name]
    src = SOURCE
    for key, val in (("@M@", M), ("@N@", N), ("@K@", K), ("@NA@", na),
                     ("@NB@", nb), ("@NC@", nc),
                     ("@ASM@", _asm(name, na, nb, nc))):
        src = src.replace(key, str(val))
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    proc = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        return {"compiles": False,
                "error": (proc.stderr or proc.stdout).strip()[-400:]}
    lib = ctypes.CDLL(str(so))
    lib.run_thr.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p]
    lib.run_one.argtypes = [ctypes.c_void_p] * 5
    out = torch.zeros(1, dtype=torch.float64, device=dev)
    ms = ctypes.c_float()
    blocks, iters = 132 * 8, 4096
    err = lib.run_thr(out.data_ptr(), blocks, iters, ctypes.byref(ms))
    if err:
        return {"compiles": True, "launch_error": err}
    flops = 2.0 * M * N * K * 4 * iters * blocks * 8
    tflops = flops / (ms.value * 1e-3) / 1e12
    A = rng.normal(size=(M, K))
    B = rng.normal(size=(K, N))
    C = rng.normal(size=(M, N))
    tA, tB, tC = (torch.as_tensor(x, device=dev) for x in (A, B, C))
    tD, tE = (torch.empty(M, N, dtype=torch.float64, device=dev)
              for _ in range(2))
    err = lib.run_one(tA.data_ptr(), tB.data_ptr(), tC.data_ptr(),
                      tD.data_ptr(), tE.data_ptr())
    D = tD.cpu().numpy()
    plain = C + A @ B
    # the fma chain, k ascending, on the card's FP64 cores
    chain = tE.cpu().numpy()
    once = _two_sum_rounded(A, B, C)
    return {"compiles": True, "tflops": tflops, "ms": ms.value,
            "layout_err": float(np.abs(D - plain).max()),
            "equal_fma_chain": int((D == chain).sum()),
            "equal_rounded_once": int((D == once).sum()),
            "entries": M * N, "launch_error": err}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("dmma_probe: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    ver = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1]
    print(f"card: {card}; nvcc: {ver}", flush=True)
    rng = np.random.default_rng(0)
    report = {"card": card, "nvcc": ver}
    for name in SHAPES:
        report[name] = probe(name, dev, rng)
        print(f"{name}: {json.dumps(report[name])}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
