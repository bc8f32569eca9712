// K7's matmul-mode instantiations: the block-tridiagonal factor of
// tridiag.cu (the recursion, the pivot protocol, the outputs) with every
// product of two matrix entries in a `matmul_precision` mode (mm_mode.cuh,
// ops/precision.py; float32 only), one kernel a mode (its input type KIND
// and pass count PASSES template parameters, chosen by a switch outside
// the kernel).  Replaces, in these modes, the TPU kernel
// onephase_tpu/ops/tridiag_pallas.py: pallas_tridiag_factor (_factor_kernel
// :54-78), whose dots take no `precision` and so run in the mode.
//
// What bounds it: as in IEEE, the chain of K dependent stages; inside a
// stage the tile Cholesky and inverse (chol_tile.cuh), nb dependent
// column phases (74-88% of the stage on the H100 before this design; the
// block products 10-13% each, on the FP32 cores with a split at every
// term).  What the design does about it:
// - The block products E_{k-1} E_{k-1}^T and B_k Ci_k^T run on the tensor
//   cores (mm_tc.cuh, mma.sync m16n8k8 for TF32, m16n8k16 for bf16 and
//   fp16): each operand is split once a stage into part planes in shared
//   memory (B_k when its cp.async lands, Ci_k when the tile returns, E_k
//   when it is formed); a warp holds one m16n8 tile of the NB x NB result
//   at NB = 32 (8 warps), two at NB = 64 (16 warps); one accumulator a
//   part pair from +0, the pairs summed smallest first (the twin's
//   precision.matmul order), so an entry that is one product is that
//   exact product.
// - The tile is chol_tile's split-once variant (chol_tile_split): each
//   column and row split once a phase, each slot's part products inline,
//   built once a pass count (not once a mode) and called once a stage.
// Sums, divisions and square roots stay float32; the stores, the ok flag
// and the cp.async ring of A_k and B_k are the IEEE kernel's.
#include <cuda_runtime.h>

#include <cstdint>

#include "mm_tc.cuh"
#include "tridiag.cuh"

namespace {

using onephase::mode_parts;
using onephase::pair_i;
using onephase::pair_j;
using onephase::Tc;

// The part planes of an NB x NB operand: part q's row r at q PLANE + r LDS,
// in KIND's operand type, rows padded so that the 8 rows of a fragment
// load fall on distinct banks (TF32 NB + 4 words; 16-bit NB + 8 halves).
template <int KIND, int NB>
struct Planes {
  using Sx = typename Tc<KIND>::S;
  static constexpr int LDS = KIND == 1 ? NB + 4 : NB + 8;
  static constexpr int PLANE = NB * LDS;
};

// The m16n8 tiles of an NB x NB product a warp of NT / 32 holds: TILES
// consecutive n8 tiles of one m16 row of tiles.
template <int NB, int NT>
struct WarpTiles {
  static constexpr int TILES = (NB / 16) * (NB / 8) / (NT / 32);
  static constexpr int ROW_WARPS = NB / 8 / TILES;   // warps an m16 row
  static_assert(TILES >= 1 && (NB / 8) % TILES == 0, "whole tiles a warp");
};

// x's parts into the planes at (r, c)
template <int KIND, int PARTS, int NB>
__device__ __forceinline__ void put_planes(typename Tc<KIND>::S* planes,
                                           int r, int c, float x) {
  using P = Planes<KIND, NB>;
  typename Tc<KIND>::S p[PARTS];
  onephase::tc_split<KIND, PARTS>(x, p);
#pragma unroll
  for (int q = 0; q < PARTS; ++q) planes[q * P::PLANE + r * P::LDS + c] = p[q];
}

// out[t][e] = sum over the mode's part pairs (i, j), smallest first, of
// sum_p A_i[row][p] Bt_j[col][p] (one mma accumulator a pair, from +0) for
// entry e of the warp's tile t: row 16 mi + g + 8 (e / 2), column
// 8 (ni0 + t) + 2 t4 + e % 2 (g = lane / 4, t4 = lane % 4).
template <int KIND, int PASSES, int NB, int NT>
__device__ __forceinline__ void tc_product(
    const typename Tc<KIND>::S* Ap, const typename Tc<KIND>::S* Bp,
    float (&out)[WarpTiles<NB, NT>::TILES][4], int mi, int ni0, int lane) {
  using P = Planes<KIND, NB>;
  using Sx = typename P::Sx;
  using TC = Tc<KIND>;
  constexpr int TILES = WarpTiles<NB, NT>::TILES, LDS = P::LDS;
  const int g = lane >> 2, t4 = lane & 3;
  // the 9-pair set at NB = 64 rolled: unrolled, its fragment loads outgrow
  // the 128 registers of 512 threads (28 bytes spilled)
#pragma unroll(PASSES == 9 && NB == 64 ? 1 : PASSES)
  for (int q = 0; q < PASSES; ++q) {
    const Sx* A = Ap + pair_i(9 - PASSES + q) * P::PLANE;
    const Sx* Bt = Bp + pair_j(9 - PASSES + q) * P::PLANE;
    float acc[TILES][4];
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NB; kk += TC::K) {
      uint32_t af[4];
      const Sx* r0p = A + (16 * mi + g) * LDS + kk;
      const Sx* r8p = r0p + 8 * LDS;
      if constexpr (KIND == 1) {
        af[0] = r0p[t4];
        af[1] = r8p[t4];
        af[2] = r0p[t4 + 4];
        af[3] = r8p[t4 + 4];
      } else {
        af[0] = *reinterpret_cast<const uint32_t*>(r0p + 2 * t4);
        af[1] = *reinterpret_cast<const uint32_t*>(r8p + 2 * t4);
        af[2] = *reinterpret_cast<const uint32_t*>(r0p + 2 * t4 + 8);
        af[3] = *reinterpret_cast<const uint32_t*>(r8p + 2 * t4 + 8);
      }
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        const Sx* cp = Bt + (8 * (ni0 + t) + g) * LDS + kk;
        uint32_t bf[2];
        if constexpr (KIND == 1) {
          bf[0] = cp[t4];
          bf[1] = cp[t4 + 4];
        } else {
          bf[0] = *reinterpret_cast<const uint32_t*>(cp + 2 * t4);
          bf[1] = *reinterpret_cast<const uint32_t*>(cp + 2 * t4 + 8);
        }
        TC::mma(acc[t], af, bf);
      }
    }
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[t][e] = q == 0 ? acc[t][e] : out[t][e] + acc[t][e];
  }
}

// Shared memory: S, X, A_k, B_k (float, NB x NB at leading dimension
// NB | 1), chol_tile's scratch and part buffers (15 NB + 4), then the
// planes of E, B_k and X (16-byte aligned).
template <int NB>
__host__ __device__ constexpr int mode_floats() {
  return (4 * NB * tile_ld<NB>() + 15 * NB + 4 + 3) / 4 * 4;
}
template <int KIND, int PASSES, int NB>
__host__ __device__ constexpr size_t mode_factor_smem() {
  using P = Planes<KIND, NB>;
  return sizeof(float) * mode_floats<NB>() +
         3 * mode_parts(PASSES) * P::PLANE * sizeof(typename P::Sx);
}

template <int NB, int NT, int KIND, int PASSES>
__global__ void __launch_bounds__(NT)
tridiag_factor_mode_kernel(const float* __restrict__ Ad,
                           const float* __restrict__ Bs,
                           const float* __restrict__ delta,
                           float* __restrict__ Ck, float* __restrict__ Ci,
                           float* __restrict__ Ek, int* __restrict__ ok_out,
                           int K, int nb) {
  using P = Planes<KIND, NB>;
  using Sx = typename P::Sx;
  using WT = WarpTiles<NB, NT>;
  constexpr int PARTS = mode_parts(PASSES);
  constexpr int LD = tile_ld<NB>(), TY = NT / 16;
  constexpr int RA = NB * 16 / NT, RC = NB / 16;
  constexpr int TILES = WT::TILES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);   // A_k + dI - m(E E^T)
  float* X = S + NB * LD;                          // C_k^{-1}
  float* Am = X + NB * LD;                         // A_k
  float* Bm = Am + NB * LD;                        // B_k as it lands
  float* vec = Bm + NB * LD;                       // chol_tile's scratch
  Sx* Ep = reinterpret_cast<Sx*>(S + mode_floats<NB>());   // E_{k-1}'s parts
  Sx* Bp = Ep + PARTS * P::PLANE;                          // B_k's
  Sx* Xp = Bp + PARTS * P::PLANE;                          // Ci_k's

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int mi = warp / WT::ROW_WARPS, ni0 = (warp % WT::ROW_WARPS) * TILES;
  const int g = lane >> 2, t4 = lane & 3;
  const long long blk = (long long)nb * nb;
  const float* A_b = Ad + (long long)b * K * blk;
  const float* B_b = Bs + (long long)b * (K - 1) * blk;
  float* Ck_b = Ck + (long long)b * K * blk;
  float* Ci_b = Ci + (long long)b * K * blk;
  float* Ek_b = Ek + (long long)b * (K - 1) * blk;
  const float dlt = delta[b];

  // X's strict upper triangle zero, and B's padding zero
  for (int e = tid; e < NB * LD; e += NT) {
    X[e] = 0.0f;
    Bm[e] = 0.0f;
  }
  int ok = 1;
  float out[TILES][4];
  TdClock clk;
  clk.start();
  __syncthreads();
  fetch_block<float, NB, NT>(Am, A_b, nb, ty, tx);
  if (K > 1) fetch_block<float, NB, NT>(Bm, B_b, nb, ty, tx);

  for (int k = 0; k < K; ++k) {
    clk.mark(TD_WAIT);
    cp_async_wait_all();
    // B_k's planes, each thread the entries it copied (the padding's zeros
    // too); the barrier publishes them and A_k
    if (k < K - 1) {
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          const int r = ty + TY * a, cc = tx + 16 * c;
          put_planes<KIND, PARTS, NB>(Bp, r, cc, Bm[r * LD + cc]);
        }
    }
    __syncthreads();
    clk.mark(TD_A);
    // 1. S = (A_k + delta I) - m(E_{k-1} E_{k-1}^T) on the lower triangle
    //    (upper zeroed, the identity past nb), at the warp's tiles; E_{-1}
    //    is zero and takes no product
    if (k > 0) {
      tc_product<KIND, PASSES, NB, NT>(Ep, Ep, out, mi, ni0, lane);
    } else {
#pragma unroll
      for (int t = 0; t < TILES; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[t][e] = 0.0f;
    }
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * mi + g + 8 * (e >> 1);
        const int cc = 8 * (ni0 + t) + 2 * t4 + (e & 1);
        float s = 0.0f;
        if (cc <= r)
          s = r < nb ? (Am[r * LD + cc] + (r == cc ? dlt : 0.0f)) - out[t][e]
                     : (r == cc ? 1.0f : 0.0f);
        S[r * LD + cc] = s;
      }
    __syncthreads();
    clk.mark(TD_OTHER);

    // the next stage's blocks, in flight while this stage factors (B_k's
    // float copy is split already)
    if (k + 1 < K)
      fetch_block<float, NB, NT>(Am, A_b + (k + 1) * blk, nb, ty, tx);
    if (k + 2 < K)
      fetch_block<float, NB, NT>(Bm, B_b + (k + 1) * blk, nb, ty, tx);

    // 2. C_k and C_k^{-1} (starts and ends with a barrier), then X's
    //    planes
    clk.mark(TD_B);
    onephase::chol_tile_split<NB, NT, PASSES>(S, X, vec, tid, &ok, KIND);
    if (k < K - 1) {
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          const int r = ty + TY * a, cc = tx + 16 * c;
          put_planes<KIND, PARTS, NB>(Xp, r, cc, X[r * LD + cc]);
        }
      __syncthreads();
    }

    // 3. E_k = m(B_k X^T) at the warp's tiles; C_k, X and E_k out, E_k's
    //    planes for the next stage (E_{k-1}'s were last read in step 1)
    clk.mark(TD_C);
    if (k < K - 1)
      tc_product<KIND, PASSES, NB, NT>(Bp, Xp, out, mi, ni0, lane);
    clk.mark(TD_D);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int r = ty + TY * a, cc = tx + 16 * c;
        if (r < nb && cc < nb) {
          Ck_b[k * blk + r * nb + cc] = S[r * LD + cc];
          Ci_b[k * blk + r * nb + cc] = X[r * LD + cc];
        }
      }
    if (k < K - 1) {
#pragma unroll
      for (int t = 0; t < TILES; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * mi + g + 8 * (e >> 1);
          const int cc = 8 * (ni0 + t) + 2 * t4 + (e & 1);
          if (r < nb && cc < nb) Ek_b[k * blk + r * nb + cc] = out[t][e];
          put_planes<KIND, PARTS, NB>(Ep, r, cc, out[t][e]);
        }
    }
    __syncthreads();
  }
  if (tid == 0) ok_out[b] = ok;
  clk.write();
}

template <int NB, int NT, int KIND, int PASSES>
int launch_nb(const void* Ad, const void* Bs, const void* delta, void* Ck,
              void* Ci, void* Ek, void* ok, int B, int K, int nb,
              void* stream) {
  const auto kernel = tridiag_factor_mode_kernel<NB, NT, KIND, PASSES>;
  const size_t smem = mode_factor_smem<KIND, PASSES, NB>();
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
      (const float*)Ad, (const float*)Bs, (const float*)delta, (float*)Ck,
      (float*)Ci, (float*)Ek, (int*)ok, K, nb);
  return (int)cudaGetLastError();
}

template <int KIND, int PASSES>
int launch_mode(const void* Ad, const void* Bs, const void* delta, void* Ck,
                void* Ci, void* Ek, void* ok, int B, int K, int nb,
                void* stream) {
  if (nb <= 32)
    return launch_nb<32, 256, KIND, PASSES>(Ad, Bs, delta, Ck, Ci, Ek, ok, B,
                                            K, nb, stream);
  return launch_nb<64, 512, KIND, PASSES>(Ad, Bs, delta, Ck, Ci, Ek, ok, B,
                                          K, nb, stream);
}

}  // namespace

namespace onephase {

// One instantiation a code mm_mode_valid accepts (16 kind + passes; the
// card modes of ops/precision.py CARD_MODES); any other is refused.
int tridiag_factor_moded(const void* Ad, const void* Bs, const void* delta,
                         void* Ck, void* Ci, void* Ek, void* ok, int B,
                         int K, int nb, int mode, void* clk, void* stream) {
  if (nb > MAX_NB) return (int)cudaErrorInvalidValue;
  if (int err = set_clocks(clk, stream)) return err;
  switch (mode) {
    case 0x11:
      return launch_mode<1, 1>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb,
                               stream);
    case 0x13:
      return launch_mode<1, 3>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb,
                               stream);
    case 0x21:
      return launch_mode<2, 1>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb,
                               stream);
    case 0x23:
      return launch_mode<2, 3>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb,
                               stream);
    case 0x26:
      return launch_mode<2, 6>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb,
                               stream);
    case 0x29:
      return launch_mode<2, 9>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb,
                               stream);
    case 0x31:
      return launch_mode<3, 1>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb,
                               stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace onephase
