// K3's inverse in the matmul modes: Li = L^-1 (B, n, n) lower, float32,
// with every product L[r, k] Li[k, c] in a `matmul_precision` mode
// (mm_mode.cuh, ops/precision.py), one kernel a mode (its input type KIND
// and pass count PASSES template parameters, chosen by a switch outside
// the kernel), compiled with the IEEE instantiations in tri_inv.cu, which
// includes this file (one compiler for both: a compiler a source beside
// chol.cu's took the build to 60 s); the wrapper
// (ops/cholesky.py:pallas_tri_inv_gram) follows either with the Gram
// product M = Li^T Li on K1's kernel in its `lower` mode.  Together they
// replace, in these modes, the TPU kernel
// onephase_tpu/ops/cholesky.py:pallas_tri_inv_gram (_tri_inv_gram_kernel
// :131-156), whose dots take no `precision` and so run in the mode.
//
// What bounds it on the H100: the n^3 / 6 products an instance, times the
// mode's pass count, on the tensor cores (TF32 495, bf16 and fp16 989
// TFLOP/s: 0.03-0.2 ms at n = 1024, B = 64) or, with one product an
// entry, on the FP32 cores (67 TFLOP/s: 0.34 ms), and the substitution
// inside each 32-row chunk, a chain of 32 dependent steps on the FP32
// cores.
// The earlier moded kernel, the IEEE kernel with the split taken at each
// use, spent 36-49% of its time in the update (on the FP32 cores,
// both operands split at every product) and 45-54% in the substitution
// (rolled, so its 32 sums lived in local memory, and L split at every
// step) (tools/mode_profile.py --only tri_inv).
//
// What the design does about it:
// - The grid, as in IEEE, is (instance, 64-column tile); a block walks its
//   columns' rows one 32-row chunk at a time.
// - A chunk's update from the rows already solved, sum over k of
//   L[r, k] Li[k, c], runs over 32-deep slabs: each slab entry is rounded
//   and split ONCE as it is staged, into one part plane a part (L's rows
//   k-contiguous, Li's k rows c-contiguous, 16-bit parts two k to a word,
//   rows padded so that the fragment loads are conflict-free); the next
//   slab's entries are on their way (L's by cp.async, Li's into
//   registers) while the current one is multiplied.  Each of the 8 warps
//   holds a 16 x 16 block of the chunk's 32 x 64 sums.
//   - With two or more parts (3, 6 or 9 products an entry) the products
//     run as mma.sync (m16n8k8 TF32, m16n8k16 bf16 and fp16; mm_tc.cuh),
//     one accumulator a part pair from +0 across all slabs, each mma's
//     sum added to it in float32; the pairs are summed smallest first into
//     rhs = delta - sum (the twin's precision.matmul_parts order).
//   - With one product an entry (tf32, bf16, f16) each product is exact in
//     float32, and the twin's sum is one float32 chain over k ascending.
//     No mma rounds as that chain does: summed exactly and rounded once,
//     or in any grouping of 8 or 16 products, a one-pass bf16 inverse at
//     n = 256 turns 3 entries to the other bf16 neighbour of the twin's,
//     and the Gram product carries them to 1.4e-4 of M.  So the planes
//     hold the rounded entries as float32 and the FP32 cores run the
//     chain, k ascending, one FMA a product (update_chain).
//   A 32-row chunk, not the IEEE kernel's 64 rows, keeps the accumulators
//   at 8 registers a pair (72 at nine pairs) and none of them live across
//   a substitution.
// - The substitution stays on the FP32 cores with float32 divisions, one
//   thread a column c < 64 holding its column's 32 sums in registers (the
//   mode is a compile-time constant, so the loops unroll without copying
//   runtime-moded code), right-looking as the IEEE kernel: at step p,
//   x_p = (rhs_p - t_p) / L[p, p], then t_i += m(L[i, p], x_p) for the
//   rows i below.  The sums t start at +0 and meet the right-hand side at
//   the division, as the twin's row sums do.  The chunk's diagonal block
//   of L is split once, when it is staged, into float part planes that
//   every thread reads by broadcast; x_p is split once a step.
// Sums, divisions and stores stay float32; the zeros above the diagonal
// block, the masks at the ragged edge and the reads of solved rows through
// L2 are the IEEE kernel's.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mm_tc.cuh"
#include "tri_inv.cuh"

namespace tri_inv_mode {
namespace {

using onephase::ld_cg;
using onephase::mm_round;
using onephase::mode_parts;
using onephase::pair_i;
using onephase::pair_j;
using onephase::Tc;

constexpr int TC = onephase::TI_TC;        // columns a block
constexpr int RC = onephase::TI_RC;        // rows a chunk, k rows a slab
constexpr int NT = onephase::TI_THREADS;   // 8 warps
constexpr int LDX = TC + 4;                // a row of the rhs tile
constexpr int LDD = RC + 1;                // a row of a diagonal part plane

// The part planes of a slab: L's (32 rows r x 32 k, k contiguous, rows
// LDA elements apart) and Li's (32 k x 64 columns c, c contiguous; a word
// an entry, k rows LDB words apart; 16-bit parts k and k + 1 of a column
// in one word, k pairs LDB words apart).  With one product an entry the
// planes hold the rounded entries as float32, in TF32's layout.  LDA puts
// the rows of a fragment's 8 groups on distinct banks (a word an entry:
// 4 g + t; 16-bit: 20 g + t, mod 32), LDB = 72 the k rows (8 t + g).
template <int KIND, int PASSES>
struct TiPlanes {
  static constexpr bool WIDE = KIND == 1 || PASSES == 1;   // a word an entry
  using Sx = std::conditional_t<PASSES == 1, float, typename Tc<KIND>::S>;
  static constexpr int LDA = WIDE ? RC + 4 : RC + 8;        // elements
  static constexpr int APLANE = RC * LDA;                   // elements
  static constexpr int LDB = TC + 8;                        // words
  static constexpr int BROWS = WIDE ? RC : RC / 2;          // word rows
  static constexpr int BPLANE = BROWS * LDB;                // words
};

// This thread's entries of a slab: L[R + r][k0 + 4 kq + e] (r = tid / 8,
// kq = tid % 8, e < 4), copied by cp.async into its own four places of
// the raw slab Lr (zero past n), and Li[k0 + 2 (kp + 4 j) + e][c0 + c]
// (c = tid % 64, kp = tid / 64, j < 4, e < 2), read into registers
// through L2 (the block's own solved rows): 8 threads read a row's 32 L
// entries, a warp 32 consecutive Li entries.  The copies keep L's entries
// out of the registers while the previous slab is multiplied.
struct SlabRegs {
  float x[4][2];
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void load_slab(const float* __restrict__ Lb,
                                          const float* X, float* Lr, int n,
                                          int R, int k0, int c0, int tc,
                                          SlabRegs& v) {
  const int tid = threadIdx.x;
  const int r = tid >> 3, kq = tid & 7;
  const bool rin = R + r < n;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    cp_async4(Lr + r * RC + 4 * kq + e,
              rin ? Lb + (long long)(R + r) * n + k0 + 4 * kq + e : Lb, rin);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int c = tid & 63, kp = tid >> 6;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      v.x[j][e] = c < tc ? ld_cg(X + (long long)(k0 + 2 * (kp + 4 * j) + e) *
                                         n + c0 + c)
                         : 0.0f;
}

// Round and split this thread's entries of a slab (its own copies of L,
// once they have landed, and its registers of Li) into the part planes.
template <int KIND, int PASSES>
__device__ __forceinline__ void store_slab(
    typename TiPlanes<KIND, PASSES>::Sx* Ap, uint32_t* Bp, const float* Lr,
    const SlabRegs& v) {
  using P = TiPlanes<KIND, PASSES>;
  using Sx = typename P::Sx;
  constexpr int PARTS = mode_parts(PASSES);
  const int tid = threadIdx.x;
  const int r = tid >> 3, kq = tid & 7;
  const int c = tid & 63, kp = tid >> 6;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if constexpr (PASSES == 1) {
    const float* src = Lr + r * RC + 4 * kq;
    *reinterpret_cast<float4*>(Ap + r * P::LDA + 4 * kq) =
        make_float4(mm_round(src[0], KIND), mm_round(src[1], KIND),
                    mm_round(src[2], KIND), mm_round(src[3], KIND));
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        Bp[(2 * (kp + 4 * j) + e) * P::LDB + c] =
            __float_as_uint(mm_round(v.x[j][e], KIND));
  } else {
    Sx lp[4][PARTS];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      onephase::tc_split<KIND, PARTS>(Lr[r * RC + 4 * kq + e], lp[e]);
#pragma unroll
    for (int q = 0; q < PARTS; ++q) {
      Sx* dst = Ap + q * P::APLANE + r * P::LDA + 4 * kq;
      if constexpr (KIND == 1) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(lp[0][q], lp[1][q], lp[2][q], lp[3][q]);
      } else {
        *reinterpret_cast<uint2*>(dst) =
            make_uint2((uint32_t)lp[0][q] | ((uint32_t)lp[1][q] << 16),
                       (uint32_t)lp[2][q] | ((uint32_t)lp[3][q] << 16));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Sx xp[2][PARTS];
#pragma unroll
      for (int e = 0; e < 2; ++e) onephase::tc_split<KIND, PARTS>(v.x[j][e],
                                                                  xp[e]);
      const int k = 2 * (kp + 4 * j);
#pragma unroll
      for (int q = 0; q < PARTS; ++q) {
        uint32_t* plane = Bp + q * P::BPLANE;
        if constexpr (KIND == 1) {
          plane[k * P::LDB + c] = xp[0][q];
          plane[(k + 1) * P::LDB + c] = xp[1][q];
        } else {
          plane[(k / 2) * P::LDB + c] =
              (uint32_t)xp[0][q] | ((uint32_t)xp[1][q] << 16);
        }
      }
    }
  }
}

// One product an entry: acc[c][e] = fma(L[r, k], Li[k, c'], acc[c][e]) over
// the slab's k ascending, on the FP32 cores, for the entries an mma
// fragment would give this lane (rows 16 mi + g + 8 (e / 2), columns
// 8 (2 nq + c) + 2 t + e % 2), so the right-hand side reads both routes
// alike.  Each product is exact in float32, so this is the twin's chain.
// (Rows rg, rg + 16 and 4 consecutive columns a thread, with 16-byte
// loads of Li, took the same time: 0.51 ms at n = 1024, B = 64, two
// thirds of the FP32 cores' rate; tools/mode_profile.py --only tri_inv.)
template <int KIND>
__device__ __forceinline__ void update_chain(const float* Ap,
                                             const uint32_t* Bp,
                                             float (&acc)[2][4], int mi,
                                             int nq, int lane) {
  using P = TiPlanes<KIND, 1>;
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = Ap + (16 * mi + g) * P::LDA;
  const float* a1 = a0 + 8 * P::LDA;
  const float* b = reinterpret_cast<const float*>(Bp) + 16 * nq + 2 * t;
#pragma unroll
  for (int k = 0; k < RC; k += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
    const float u0[4] = {x0.x, x0.y, x0.z, x0.w};
    const float u1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* row = b + (k + j) * P::LDB;
      const float2 p = *reinterpret_cast<const float2*>(row);
      const float2 q = *reinterpret_cast<const float2*>(row + 8);
      acc[0][0] = fmaf(u0[j], p.x, acc[0][0]);
      acc[0][1] = fmaf(u0[j], p.y, acc[0][1]);
      acc[0][2] = fmaf(u1[j], p.x, acc[0][2]);
      acc[0][3] = fmaf(u1[j], p.y, acc[0][3]);
      acc[1][0] = fmaf(u0[j], q.x, acc[1][0]);
      acc[1][1] = fmaf(u0[j], q.y, acc[1][1]);
      acc[1][2] = fmaf(u1[j], q.x, acc[1][2]);
      acc[1][3] = fmaf(u1[j], q.y, acc[1][3]);
    }
  }
}

// Two or more parts: acc[q][t] += the slab's products of pair q for the
// warp's m16 tile mi and n8 tiles 2 nq, 2 nq + 1: A part i (L), B part j
// (Li), each B fragment loaded for its pair.  Each mma adds its k step's
// products to +0, and a float32 add, rounded to nearest, puts that sum
// into the pair's accumulator (an accumulator carried inside the tensor
// core took the inverses 2-4x further from their mode's recurrence).  At
// six and nine pairs the k steps stay rolled, at nine the A parts too
// (unrolled, they outgrow the 128 registers of two blocks an SM).
template <int KIND, int PASSES>
__device__ __forceinline__ void update(const typename Tc<KIND>::S* Ap,
                                       const uint32_t* Bp,
                                       float (&acc)[PASSES][2][4], int mi,
                                       int nq, int lane) {
  using P = TiPlanes<KIND, PASSES>;
  using Sx = typename P::Sx;
  using MMA = Tc<KIND>;
  constexpr int PARTS = mode_parts(PASSES);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll(PASSES >= 6 ? 1 : RC / MMA::K)
  for (int ks = 0; ks < RC; ks += MMA::K) {
#pragma unroll(PASSES == 9 ? 1 : PARTS)
    for (int ip = 0; ip < PARTS; ++ip) {
      uint32_t af[4];
      const Sx* r0 = Ap + ip * P::APLANE + (16 * mi + g) * P::LDA + ks;
      const Sx* r8 = r0 + 8 * P::LDA;
      if constexpr (KIND == 1) {
        af[0] = r0[t];
        af[1] = r8[t];
        af[2] = r0[t + 4];
        af[3] = r8[t + 4];
      } else {
        af[0] = *reinterpret_cast<const uint32_t*>(r0 + 2 * t);
        af[1] = *reinterpret_cast<const uint32_t*>(r8 + 2 * t);
        af[2] = *reinterpret_cast<const uint32_t*>(r0 + 2 * t + 8);
        af[3] = *reinterpret_cast<const uint32_t*>(r8 + 2 * t + 8);
      }
#pragma unroll
      for (int q = 0; q < PASSES; ++q) {
        if (pair_i(9 - PASSES + q) != ip) continue;
        const int jp = pair_j(9 - PASSES + q);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          // TF32: k rows ks + t, ks + t + 4; 16-bit: k pairs ks / 2 + t, + 4
          const uint32_t* col = Bp + jp * P::BPLANE +
                                (KIND == 1 ? ks : ks / 2) * P::LDB +
                                8 * (2 * nq + c) + g;
          const uint32_t bf[2] = {col[t * P::LDB], col[(t + 4) * P::LDB]};
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          MMA::mma(d, af, bf);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][c][e] += d[e];
        }
      }
    }
  }
}

template <int KIND, int PASSES>
__global__ void __launch_bounds__(NT, 2)
tri_inv_mode_kernel(const float* __restrict__ L, float* __restrict__ Li,
                    int n) {
  using P = TiPlanes<KIND, PASSES>;
  using Sx = typename P::Sx;
  constexpr int PARTS = mode_parts(PASSES);
  constexpr onephase::MmMode MD{KIND, PASSES};
  __shared__ __align__(16) Sx Ap[PARTS * P::APLANE];        // L's parts
  __shared__ __align__(16) uint32_t Bp[PARTS * P::BPLANE];  // Li's parts
  __shared__ float Dp[PARTS * RC * LDD];   // the diagonal block's parts
  __shared__ float dg[RC];                 // its diagonal
  __shared__ __align__(16) float Xs[RC * LDX];   // a chunk's rhs
  __shared__ float Lr[RC * RC];   // the raw L slab, each thread's own copies

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * TC;
  const int tc = min(TC, n - c0);
  const long long nn = (long long)n * n;
  const float* Lb = L + (long long)b * nn;
  float* X = Li + (long long)b * nn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mi = warp >> 2, nq = warp & 3;   // the warp's 16 x 16 block
  const int g = lane >> 2, t4 = lane & 3;
  TiClock clk;
  clk.start();
  clk.mark(onephase::TI_STORE);

  // rows above the diagonal block are zero
  for (long long e = tid; e < (long long)c0 * TC; e += NT) {
    const long long r = e / TC;
    const int c = (int)(e % TC);
    if (c < tc) X[r * n + c0 + c] = 0.0f;
  }

  SlabRegs v;
  clk.mark(onephase::TI_LOAD);
  for (int R = c0; R < n; R += RC) {
    const int rb = min(RC, n - R);
    float acc[PASSES][2][4];
#pragma unroll
    for (int q = 0; q < PASSES; ++q)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][c][e] = 0.0f;
    // the update from the solved rows k in [c0, R), k ascending by slab
    if (c0 < R) load_slab(Lb, X, Lr, n, R, c0, c0, tc, v);
    for (int k0 = c0; k0 < R; k0 += RC) {
      store_slab<KIND, PASSES>(Ap, Bp, Lr, v);
      __syncthreads();
      if (k0 + RC < R) load_slab(Lb, X, Lr, n, R, k0 + RC, c0, tc, v);
      clk.mark(onephase::TI_UPDATE);
      if constexpr (PASSES == 1)
        update_chain<KIND>(Ap, Bp, acc[0], mi, nq, lane);
      else
        update<KIND, PASSES>(Ap, Bp, acc, mi, nq, lane);
      clk.mark(onephase::TI_LOAD);
      __syncthreads();
    }
    // the diagonal block L[R + i][R + p], split into float part planes
    // Dp[q][p][i], and its diagonal
    {
      const int i = tid >> 3, pq = tid & 7;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 4 * pq + e;
        const float x = (i < rb && p < rb)
                            ? __ldg(Lb + (long long)(R + i) * n + R + p)
                            : 0.0f;
        float parts[PARTS];
        onephase::mm_split_n<PARTS>(x, KIND, parts);
#pragma unroll
        for (int q = 0; q < PARTS; ++q) Dp[(q * RC + p) * LDD + i] = parts[q];
        if (i == p) dg[p] = x;
      }
    }
    clk.mark(onephase::TI_SOLVE);
    // rhs = delta - (the pairs summed smallest first)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = acc[0][c][e];
#pragma unroll
        for (int q = 1; q < PASSES; ++q) s = s + acc[q][c][e];
        const int i = 16 * mi + g + 8 * (e >> 1);
        const int cc = 8 * (2 * nq + c) + 2 * t4 + (e & 1);
        Xs[i * LDX + cc] = ((R + i == c0 + cc) ? 1.0f : 0.0f) - s;
      }
    clk.mark(onephase::TI_LOAD);
    __syncthreads();
    clk.mark(onephase::TI_SOLVE);
    if (tid < TC) {
      // right-looking: at step p, x_p = (rhs_p - t_p) / L[p, p], split
      // once, then t_i += m(L[i, p], x_p) for the rows i below (independent)
      const int c = tid;
      float s[RC];
#pragma unroll
      for (int i = 0; i < RC; ++i) s[i] = 0.0f;
#pragma unroll
      for (int p = 0; p < RC; ++p) {
        if (p >= rb) break;
        s[p] = (Xs[p * LDX + c] - s[p]) / dg[p];
        float xp[3];
        onephase::mm_split(s[p], MD, xp);
#pragma unroll
        for (int i = p + 1; i < RC; ++i) {
          float lp[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int q = 0; q < PARTS; ++q) lp[q] = Dp[(q * RC + p) * LDD + i];
          s[i] = onephase::mm_fma_parts(lp, xp, s[i], PASSES);
        }
      }
      clk.mark(onephase::TI_STORE);
      if (c < tc) {
#pragma unroll
        for (int i = 0; i < RC; ++i)
          if (i < rb) X[(long long)(R + i) * n + c0 + c] = s[i];
      }
    }
    clk.mark(onephase::TI_LOAD);
    // the solved rows are in Li for the next chunk's slabs, and every
    // thread is done with Dp, dg and Xs
    __syncthreads();
  }
  clk.write();
}

template <int KIND, int PASSES>
int launch_mode(const void* L, void* Li, int B, int n, void* stream) {
  const int nct = (n + TC - 1) / TC;
  if (nct > 65535) return (int)cudaErrorInvalidValue;
  tri_inv_mode_kernel<KIND, PASSES>
      <<<dim3(B, nct), NT, 0, (cudaStream_t)stream>>>((const float*)L,
                                                      (float*)Li, n);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tri_inv_mode

// K3's inverse in the matmul mode of code `mode` (16 kind + passes, one of
// the seven card modes; tri_inv.cu runs 0, IEEE)
inline int tri_inv_mode_launch(const void* L, void* Li, int B, int n,
                               int mode, void* stream) {
  using tri_inv_mode::launch_mode;
  switch (mode) {
    case 0x11: return launch_mode<1, 1>(L, Li, B, n, stream);
    case 0x13: return launch_mode<1, 3>(L, Li, B, n, stream);
    case 0x21: return launch_mode<2, 1>(L, Li, B, n, stream);
    case 0x23: return launch_mode<2, 3>(L, Li, B, n, stream);
    case 0x26: return launch_mode<2, 6>(L, Li, B, n, stream);
    case 0x29: return launch_mode<2, 9>(L, Li, B, n, stream);
    case 0x31: return launch_mode<3, 1>(L, Li, B, n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
