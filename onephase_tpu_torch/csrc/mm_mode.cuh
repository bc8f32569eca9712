// The float32 product arithmetic of a `matmul_precision` mode on the FP32
// cores, shared by the moded variants of K3's substitution
// (tri_inv_mode.cuh), K5's chains (tridiag.cuh) and the tile Cholesky of
// K2's and K7's diagonal blocks (chol_tile.cuh); K1's products, K2's
// trailing update, K3's update and K7's block products run on the tensor
// cores (mm_tc.cuh), K2's panel on its own split-once routines (chol.cu).  The definition, and the plain twins
// that compute the same values, are in onephase_tpu_torch/ops/precision.py:
//
// - every product of two matrix entries is a product of operands rounded
//   to the mode's input type: TF32 (round to nearest, ties away from zero:
//   cvt.rna.tf32.f32), bf16 or fp16 (round to nearest even);
// - a split mode expands each operand into parts hi = r(x), mid =
//   r(x - hi), lo = r(x - hi - mid) (two parts for 3 products, three for 6
//   and 9) and takes the part products (i, j) with i + j <= 1, <= 2 or all
//   nine, summed smallest first: (2, 2), (2, 1), (1, 2), (2, 0), (1, 1),
//   (0, 2), (1, 0), (0, 1), (0, 0);
// - sums, divisions and square roots stay float32.
//
// A product of two rounded operands is exact in float32 (8 + 8 or 11 + 11
// significand bits), so each FFMA below adds the exact part product to the
// accumulator with one rounding, as a tensor-core product of that type
// would up to the order of its sums.  The kernels that use these routines
// pay the split modes' 3, 6 or 9 FMAs a product on the FP32 cores.
//
// The mode is a runtime value (MmMode) for K2's tile, read once outside the
// inner loops; K3's inverse, K5, K7 and K2's trailing update have one
// instantiation a mode, the kind and the pass set template parameters.
// The IEEE instantiations' arithmetic does not change.  The mode's code
// (ops/precision.py Mode.code): 16 * kind + passes, kind 1 = tf32, 2 =
// bf16, 3 = f16; 0 is IEEE.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace onephase {

struct MmMode {
  int kind;     // 0 none, 1 tf32, 2 bf16, 3 f16
  int passes;   // 1, 3, 6, 9
};

// The mode of a code, and whether the kernels have it.
__host__ __device__ inline MmMode mm_mode(int code) {
  return MmMode{code >> 4, code & 15};
}
inline bool mm_mode_valid(int code) {
  const MmMode m = mm_mode(code);
  if (code == 0) return true;
  if (m.kind < 1 || m.kind > 3) return false;
  if (m.kind == 3) return m.passes == 1;
  if (m.kind == 1) return m.passes == 1 || m.passes == 3;
  return m.passes == 1 || m.passes == 3 || m.passes == 6 || m.passes == 9;
}

// the part pairs (i, j), smallest first
// (2, 2), (2, 1), (1, 2), (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0);
// a pass set of P products takes the last P
__host__ __device__ constexpr int pair_i(int q) {
  return (q == 0 || q == 1 || q == 3) ? 2 : (q == 2 || q == 4 || q == 6) ? 1
                                                                         : 0;
}
__host__ __device__ constexpr int pair_j(int q) {
  return (q == 0 || q == 2 || q == 5) ? 2 : (q == 1 || q == 4 || q == 7) ? 1
                                                                         : 0;
}
// parts of an operand in a pass set of `passes` products
__host__ __device__ constexpr int mode_parts(int passes) {
  return passes == 1 ? 1 : passes == 3 ? 2 : 3;
}

__device__ __forceinline__ float mm_round(float x, int kind) {
  if (kind == 1) {
    unsigned u;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
    // the 13 bits below TF32's fraction: zero them, so the value is the
    // TF32 number itself (a NaN stays a NaN)
    return __uint_as_float(u & 0xffffe000u);
  }
  if (kind == 2) return __bfloat162float(__float2bfloat16_rn(x));
  if (kind == 3) return __half2float(__float2half_rn(x));
  return x;
}

// The parts of x: p[0] = hi, p[1] = mid (or lo), p[2] = lo; unused parts
// are 0.
__device__ __forceinline__ void mm_split(float x, MmMode m, float (&p)[3]) {
  p[0] = mm_round(x, m.kind);
  p[1] = p[2] = 0.0f;
  if (m.passes >= 3) {
    const float r = x - p[0];
    p[1] = mm_round(r, m.kind);
    if (m.passes >= 6) p[2] = mm_round(r - p[1], m.kind);
  }
}

// The PARTS parts of x in kind's input type, as mm_split gives them (a
// constant `kind` folds the rounding's branches).
template <int PARTS>
__device__ __forceinline__ void mm_split_n(float x, int kind,
                                           float (&p)[PARTS]) {
  float rest = x;
#pragma unroll
  for (int q = 0; q < PARTS; ++q) {
    p[q] = mm_round(rest, kind);
    rest = rest - p[q];
  }
}

// sum over the last PASSES part pairs of a's part i times b's part j, from
// +0, smallest first; part q of a at a[q * stride], of b at b[q * stride]
template <int PASSES>
__device__ __forceinline__ float mm_prod_parts(const float* a,
                                               const float* b, int stride) {
  float acc = 0.0f;
#pragma unroll
  for (int q = 9 - PASSES; q < 9; ++q)
    acc = fmaf(a[pair_i(q) * stride], b[pair_j(q) * stride], acc);
  return acc;
}

// acc + a b over the mode's part products, smallest first, a and b split.
__device__ __forceinline__ float mm_fma_parts(const float (&a)[3],
                                              const float (&b)[3], float acc,
                                              int passes) {
  if (passes == 9) {
    acc = fmaf(a[2], b[2], acc);
    acc = fmaf(a[2], b[1], acc);
    acc = fmaf(a[1], b[2], acc);
  }
  if (passes >= 6) {
    acc = fmaf(a[2], b[0], acc);
    acc = fmaf(a[1], b[1], acc);
    acc = fmaf(a[0], b[2], acc);
  }
  if (passes >= 3) {
    acc = fmaf(a[1], b[0], acc);
    acc = fmaf(a[0], b[1], acc);
  }
  return fmaf(a[0], b[0], acc);
}

// acc + a b in mode m (both operands split here).
__device__ __forceinline__ float mode_fma(float a, float b, float acc,
                                          MmMode m) {
  float pa[3], pb[3];
  mm_split(a, m, pa);
  mm_split(b, m, pb);
  return mm_fma_parts(pa, pb, acc, m.passes);
}

}  // namespace onephase
