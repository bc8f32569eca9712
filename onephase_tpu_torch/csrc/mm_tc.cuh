// The tensor-core arithmetic of a `matmul_precision` mode, shared by the
// moded variants of K1 (fused_q.cu), K2's trailing update (chol.cu), K3's
// update (tri_inv_mode.cuh) and K7's block products
// (tridiag_factor_mode.cu); and the FP64 tensor cores' mma (Dmma), shared
// by K1's and K2's float64 routes.
// The mode's definition (mm_mode.cuh, ops/precision.py): every product of
// two entries takes operands rounded to the mode's input type, a split
// mode expands each operand into parts hi, mid, lo and takes the part
// products (i, j) of its pass set, summed smallest first.
//
// Here each operand is rounded and split ONCE, when it is staged in shared
// memory, into one plane a part in the mma's operand type (TF32 as 32 bits
// with the 13 bits below its fraction zero, bf16 and fp16 as 16 bits).  The
// product runs as mma.sync.m16n8k8 (TF32) or m16n8k16 (bf16, fp16), or as
// wgmma m64n128 (Wg below, sm_90a), with float32 accumulation, one
// accumulator a part pair, started at +0.  The
// pairs are summed in float32 afterwards, smallest first in the order of
// ops/precision.py Mode.pairs: a pass set of P products takes the last P
// pairs of pair_i / pair_j (mm_mode.cuh).  A part is exact in the operand type, so a part
// product is exact; only the order of the sums (and a tensor core's
// internal additions, which need not round as a float32 add) differs from
// the twins, and an entry that is one product is that exact product.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mm_mode.cuh"

namespace onephase {

// The mma of one kind: KIND 1 = TF32 (k 8), 2 = bf16, 3 = fp16 (k 16).
// S is the plane's element type; an A fragment is 4 32-bit registers, a B
// fragment 2, an accumulator 4 floats.
template <int KIND> struct Tc;

template <> struct Tc<1> {
  using S = uint32_t;
  static constexpr int K = 8;
  // x rounded to TF32 (ties away, as cvt.rna): its bits, and the float
  // it is in `v`
  static __device__ __forceinline__ S round_bits(float x, float& v) {
    v = mm_round(x, 1);
    return __float_as_uint(v);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t* b) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <> struct Tc<2> {
  using S = unsigned short;
  static constexpr int K = 16;
  static __device__ __forceinline__ S round_bits(float x, float& v) {
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    v = __bfloat162float(h);
    return __bfloat16_as_ushort(h);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t* b) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <> struct Tc<3> {
  using S = unsigned short;
  static constexpr int K = 16;
  static __device__ __forceinline__ S round_bits(float x, float& v) {
    const __half h = __float2half_rn(x);
    v = __half2float(h);
    return __half_as_ushort(h);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t* b) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// The FP64 tensor cores' mma.sync.aligned.m16n8k8.row.col.f64 (Hopper's
// f64 shape; 2 x 16 x 8 x 8 operations an instruction), shared by K1's
// float64 route (fused_q.cu) and K2's float64 trailing update (chol.cu).
// On the H100 its D is the FP64 cores' fma chain over its k, ascending,
// from C, bit for bit (tools/dmma_probe.py), so an accumulator started at
// +0 and carried from one mma to the next is the chain acc = fma(a_k, b_k,
// acc) over every k in order.
struct Dmma {
  static constexpr int K = 8;
  // d += a b: a_i at (row g + 8 (i % 2), k t + 4 (i / 2)), b_i at (k t +
  // 4 i, column g), d_i at (row g + 8 (i / 2), column 2 t + i % 2), with
  // g = lane / 4, t = lane % 4
  static __device__ __forceinline__ void mma(double (&d)[4],
                                             const double (&a)[4],
                                             const double (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};

// x's PARTS parts in KIND's operand type: hi = r(x), mid = r(x - hi),
// lo = r(x - hi - mid), the differences exact in float32 (mm_split)
template <int KIND, int PARTS>
__device__ __forceinline__ void tc_split(float x,
                                         typename Tc<KIND>::S (&p)[PARTS]) {
  float rest = x;
#pragma unroll
  for (int q = 0; q < PARTS; ++q) {
    float part;
    p[q] = Tc<KIND>::round_bits(rest, part);
    rest = rest - part;
  }
}

// 16 bytes of parts (4 TF32 or 8 16-bit values, element 0 lowest) as the
// registers of a fragment
__device__ __forceinline__ uint4 pack16(const uint32_t (&v)[4]) {
  return make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint4 pack16(const unsigned short (&v)[8]) {
  auto w = [&](int i) {
    return (uint32_t)v[2 * i] | ((uint32_t)v[2 * i + 1] << 16);
  };
  return make_uint4(w(0), w(1), w(2), w(3));
}

// ---------------------------------------------------------------------
// Warpgroup products (wgmma, sm_90a): D[64 x 128] += A[64 x K] B[K x 128]
// with A and B read by the tensor cores from shared memory through matrix
// descriptors, both K-major without swizzle: 8-row core matrices of 16
// bytes a row, the 8-row groups SBO bytes apart and the 16-byte K chunks
// LBO bytes apart.  D: a thread of warp w of the warpgroup holds, for n8
// tile j, d[4 j + 0..3] at rows 16 w + g (+ 8 for 2, 3) and columns
// 8 j + 2 t (+ 1 for 1, 3), g = lane / 4, t = lane % 4.
__device__ __forceinline__ uint64_t wg_desc(const void* smem, int lbo,
                                            int sbo) {
  const uint32_t a =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((a >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared memory written by the threads, next read by the tensor cores
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int KIND> struct Wg;
template <> struct Wg<1> {
  static constexpr int K = 8;
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <> struct Wg<2> {
  static constexpr int K = 16;
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(0), "n"(0));
  }
};
template <> struct Wg<3> {
  static constexpr int K = 16;
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(0), "n"(0));
  }
};

}  // namespace onephase
