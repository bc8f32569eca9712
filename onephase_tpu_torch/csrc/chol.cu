// Batched blocked Cholesky: Q (B, n, n) -> L (lower, strict upper zeroed),
// d = diag(L) (B, n), ok (B,) = every pivot positive and finite.
//
// Replaces the TPU kernel onephase_tpu/ops/cholesky.py:pallas_chol
// (_chol_kernel :99-128 with _unblocked_chol :48-75 and _tri_inv_unblocked
// :78-96).  Pivot protocol as in _unblocked_chol (see chol_tile.cuh); on
// failure L is garbage and only ok matters.
//
// What bounds it on the H100: FP32 (FP64) FMA rate once enough SMs work
// on each instance.  The work is n^3 / 3 multiply-adds per instance, almost
// all of it in the trailing updates A22 -= L21 L21^T; what stands in the
// way is the serial chain of panels (each 64-column panel must be factored
// before the next starts) and, with one block per instance, the number of
// SMs a batch can use (16 of 132 at the bench's B = 16).
//
// What the design does about it (one launch per call):
// - A thread-block cluster of CS blocks per instance, CS the largest power
//   of two <= 8 with B * CS <= the SM count (8 at B = 16, 2 at B = 64),
//   halved while the card cannot hold B such clusters at once.  The blocks
//   of a cluster split each panel's rows and each trailing update's
//   lower-triangle tiles and meet at a cluster barrier (release / acquire
//   at cluster scope) after each of the two.  L itself is the workspace in
//   global memory: 268 MB at n = 1024, B = 64, more than five times the
//   50 MB L2, so the trailing matrix streams from HBM once per panel and
//   the panel (at most 16 MB) is reread from L2.  Every access to L goes
//   through L2 (ld.global.cg / st.global.cg), never a possibly stale L1.
// - 64-column outer panels, each two 32-column inner panels.  Every block
//   of the cluster factors the 64 x 64 diagonal block itself in shared
//   memory (the two inner tiles by chol_tile.cuh, the block between them
//   by substitution and a small product), so no barrier waits for it; the
//   rows below are solved one row per thread, in registers, against the
//   two inner tiles.  Rank 0 writes the diagonal block and d once every
//   block has read it.
// - The trailing update is a register-tiled SYRK: 64 x 64 tiles, a 4 x 4
//   register block per thread, the two 64 x 64 panel slices in shared
//   memory (rows padded by 16 bytes: vector loads along the depth are
//   conflict-free), the next tile's slices loaded into registers while the
//   current tile's FMAs run.  Each tile takes the two inner panels' updates
//   in turn, (C - acc1) - acc2, so one pass over the trailing matrix does
//   the work of two.
// - The arithmetic is value for value that of the earlier one-block,
//   32-column kernel (the same products summed in the same order, the
//   panel by forward substitution): the f32 bench trajectories, which are
//   sensitive to the last bit of the factor, stay as they were.  A variant
//   with 64-column tiles that multiplied the panel by the inverted diagonal
//   block, as the TPU kernel does, moved the n=256/B=16 f32 bench from
//   16/16 certified to 15/16.
// - f32 stays on the FP32 cores (no TF32), f64 on the FP64 cores.  The
//   ragged last panel is padded with the identity in shared memory; the
//   ragged edge of L is masked.
// - A `matmul_precision` mode (mm_mode.cuh; float32 only) runs in the one
//   moded instantiation, chol_kernel<float, true>: every product of two
//   entries of the factor (the trailing updates, the panel's substitutions
//   and its update, the diagonal tiles' column updates) takes its operands
//   rounded and split, on the FP32 cores.  The IEEE instantiations are
//   unchanged, value for value.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using onephase::chol_tile;
using onephase::MmMode;
using onephase::mode_fma;
using onephase::tile_entries;
using onephase::tile_ld;
using onephase::tile_owner;

constexpr int NB = 64;        // outer panel width and trailing tile edge
constexpr int NI = 32;        // inner panel width (the factored tiles)
constexpr int NT = 256;       // threads per block (16 x 16, 4 x 4 each)
constexpr int MAX_CLUSTER = 8;
constexpr int LDI = tile_ld<NI>();   // the inner tiles' leading dimension

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };
// elements of a 16-byte vector, and the panel slices' leading dimension
template <typename T> __host__ __device__ constexpr int vec_w() { return 16 / sizeof(T); }
template <typename T> __host__ __device__ constexpr int ldp() { return NB + vec_w<T>(); }

__device__ __forceinline__ float comp(const float4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}
__device__ __forceinline__ double comp(const double2& v, int w) {
  return w == 0 ? v.x : v.y;
}

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (3 * NI * LDI + 2 * NB * ldp<T>() + 6 * NI + 2);
}

// acc[a][c] = sum_{p in [p0, p0 + NI)} A[ty + 16 a][p] Bt[tx + 16 c][p],
// p in increasing order, over slices in shared memory (leading dimension
// ldp<T>()); MODED: each entry split once a step, the products in `md`.
template <typename T, bool MODED>
__device__ __forceinline__ void half_product(const T* A, const T* Bt, int p0,
                                             T (&acc)[4][4], int ty, int tx,
                                             MmMode md) {
  using V = typename Vec<T>::type;
  constexpr int W = vec_w<T>(), LD = ldp<T>();
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = T(0);
  // (MODED: one step at a time, so that the moded products are not
  // copied by the unrolling)
#pragma unroll(MODED ? 1 : 4)
  for (int p = p0; p < p0 + NI; p += W) {
    V av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const V*>(A + (ty + 16 * a) * LD + p);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const V*>(Bt + (tx + 16 * c) * LD + p);
#pragma unroll(MODED ? 1 : W)
    for (int w = 0; w < W; ++w) {
      if constexpr (MODED) {
        float pa[4][3], pb[4][3];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          onephase::mm_split(comp(av[a], w), md, pa[a]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          onephase::mm_split(comp(bv[c], w), md, pb[c]);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[a][c] = onephase::mm_fma_parts(pa[a], pb[c], acc[a][c],
                                               md.passes);
      } else {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[a][c] += comp(av[a], w) * comp(bv[c], w);
      }
    }
  }
}

// 64 rows from row0 of the 64 columns from col0 of L into registers
// (rows at or past n read as zero): element (tid / 64 + 4 q, tid % 64).
template <typename T>
__device__ __forceinline__ void load_slice(T (&reg)[16], const T* Lb, int n,
                                           int row0, int col0, int tid) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int r = row0 + (tid >> 6) + 4 * q;
    reg[q] = r < n ? __ldcg(Lb + (long long)r * n + col0 + (tid & 63))
                   : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store_slice(T* dst, const T (&reg)[16],
                                            int tid) {
#pragma unroll
  for (int q = 0; q < 16; ++q)
    dst[((tid >> 6) + 4 * q) * ldp<T>() + (tid & 63)] = reg[q];
}

// (ti, tj) with tj <= ti of the row-major lower-triangle tile index idx
__device__ __forceinline__ void tile_pair(int idx, int& ti, int& tj) {
  int t = (int)((sqrtf(8.0f * idx + 1.0f) - 1.0f) * 0.5f);
  while (t * (t + 1) / 2 > idx) --t;
  while ((t + 1) * (t + 2) / 2 <= idx) ++t;
  ti = t;
  tj = idx - t * (t + 1) / 2;
}

// x := x D^-T for one row x of NI values in registers and a factored
// inner tile D in shared memory, by forward substitution (MODED: each
// product in `md`).
template <typename T, bool MODED>
__device__ __forceinline__ void row_solve(T (&x)[NI], const T* D,
                                          MmMode md) {
  if constexpr (MODED) {
    // not unrolled: x lives in local memory, one moded product a step
#pragma unroll 1
    for (int j = 0; j < NI; ++j) {
      T s = x[j];
#pragma unroll 1
      for (int p = 0; p < j; ++p) s = mode_fma(-x[p], D[j * LDI + p], s, md);
      x[j] = s / D[j * LDI + j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      T s = x[j];
#pragma unroll
      for (int p = 0; p < j; ++p) s -= x[p] * D[j * LDI + p];
      x[j] = s / D[j * LDI + j];
    }
  }
}

// MODED (float32 only): every product of two entries of the factor is
// taken in the matmul mode `mode` (mm_mode.cuh): the trailing updates, the
// panel's substitutions and updates, and the diagonal tiles' column
// updates.  The IEEE instantiations ignore `mode`.
template <typename T, bool MODED>
__global__ void __launch_bounds__(NT)
chol_kernel(const T* __restrict__ Q, T* L, T* __restrict__ d,
            int* __restrict__ ok_out, int n, int mode) {
  static_assert(!MODED || sizeof(T) == 4, "modes are float32 only");
  const MmMode md = onephase::mm_mode(mode);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* D1 = reinterpret_cast<T*>(smem_raw);   // inner tile 1: A11, then L11
  T* W = D1 + NI * LDI;                     // A21, then L21 (of the 64 x 64)
  T* D2 = W + NI * LDI;                     // inner tile 2: A22, then L22
  T* Ps = D2 + NI * LDI;                    // panel slice (row side)
  T* Qs = Ps + NB * ldp<T>();               // panel slice (column side)
  T* vec = Qs + NB * ldp<T>();              // chol_tile's scratch

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long nn = (long long)n * n;
  const T* A = Q + (long long)b * nn;
  T* Lb = L + (long long)b * nn;

  // L := lower triangle of Q, strict upper zeroed (a warp per row, four
  // loads in flight per lane)
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = rank * (NT / 32) + warp; r < n; r += cs * (NT / 32)) {
      const T* src = A + (long long)r * n;
      T* dst = Lb + (long long)r * n;
      for (int c0 = lane; c0 < n; c0 += 4 * 32) {
        T v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + 32 * u;
          v[u] = (c < n && c <= r) ? src[c] : T(0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c0 + 32 * u < n) __stcg(dst + c0 + 32 * u, v[u]);
      }
    }
  }
  int own[tile_entries<NI, NT>()];
  tile_owner<NI, NT>(own, tid);
  int ok = 1;
  cluster.sync();

  for (int k0 = 0; k0 < n; k0 += NB) {
    const int kb = min(NB, n - k0);
    // 1. the 64 x 64 diagonal block as two inner tiles and the block
    //    between them, padded with the identity (zero in W) past kb
    for (int e = tid; e < NI * NI; e += NT) {
      const int r = e >> 5, c = e & 31;
      const T* src = Lb + (long long)(k0 + r) * n + k0 + c;
      const long long down = (long long)NI * n;   // 32 rows further
      D1[r * LDI + c] = c > r ? T(0)
                      : r < kb ? __ldcg(src) : (r == c ? T(1) : T(0));
      W[r * LDI + c] = NI + r < kb ? __ldcg(src + down) : T(0);
      D2[r * LDI + c] = c > r ? T(0)
                      : NI + r < kb ? __ldcg(src + down + NI)
                                    : (r == c ? T(1) : T(0));
    }
    // 2. L11; then L21 = A21 L11^-T and A22 - L21 L21^T in shared memory;
    //    then L22 (every block of the cluster, the same values)
    chol_tile<T, NI, NT, false, MODED>(D1, nullptr, vec, own, tid, ok, md);
    if (kb > NI) {
      if (tid < NI) {
        T x[NI];
#pragma unroll
        for (int p = 0; p < NI; ++p) x[p] = W[tid * LDI + p];
        row_solve<T, MODED>(x, D1, md);
#pragma unroll
        for (int p = 0; p < NI; ++p) W[tid * LDI + p] = x[p];
      }
      __syncthreads();
      for (int e = tid; e < NI * NI; e += NT) {
        const int r = e >> 5, c = e & 31;
        if (c <= r) {
          T acc = T(0);
          if constexpr (MODED) {
#pragma unroll 1
            for (int p = 0; p < NI; ++p)
              acc = mode_fma(W[r * LDI + p], W[c * LDI + p], acc, md);
          } else {
#pragma unroll 8
            for (int p = 0; p < NI; ++p)
              acc += W[r * LDI + p] * W[c * LDI + p];
          }
          D2[r * LDI + c] -= acc;
        }
      }
      chol_tile<T, NI, NT, false, MODED>(D2, nullptr, vec, own, tid, ok,
                                         md);
    }

    // 3. the rows below the block, one per thread, split over the
    //    cluster: the first 32 columns solved against L11, the next 32
    //    updated with them and solved against L22
    for (int i = k0 + NB + rank * NT + tid; i < n; i += cs * NT) {
      T* row = Lb + (long long)i * n + k0;
      T x[NI], y[NI];
#pragma unroll
      for (int p = 0; p < NI; ++p) x[p] = __ldcg(row + p);
#pragma unroll
      for (int p = 0; p < NI; ++p) y[p] = __ldcg(row + NI + p);
      row_solve<T, MODED>(x, D1, md);
      if constexpr (MODED) {
#pragma unroll 1
        for (int c = 0; c < NI; ++c) {
          T acc = T(0);
#pragma unroll 1
          for (int p = 0; p < NI; ++p)
            acc = mode_fma(x[p], W[c * LDI + p], acc, md);
          y[c] -= acc;
        }
      } else {
#pragma unroll
        for (int c = 0; c < NI; ++c) {
          T acc = T(0);
#pragma unroll
          for (int p = 0; p < NI; ++p) acc += x[p] * W[c * LDI + p];
          y[c] -= acc;
        }
      }
      row_solve<T, MODED>(y, D2, md);
#pragma unroll
      for (int p = 0; p < NI; ++p) __stcg(row + p, x[p]);
#pragma unroll
      for (int p = 0; p < NI; ++p) __stcg(row + NI + p, y[p]);
    }
    cluster.sync();   // the panel is complete; the diagonal block was read

    // 4. the diagonal block and d out, once
    if (rank == 0) {
      for (int e = tid; e < NI * NI; e += NT) {
        const int r = e >> 5, c = e & 31;
        T* dst = Lb + (long long)(k0 + r) * n + k0 + c;
        const long long down = (long long)NI * n;
        if (r < kb && c <= r) __stcg(dst, D1[r * LDI + c]);
        if (NI + r < kb) {
          __stcg(dst + down, W[r * LDI + c]);
          if (c <= r) __stcg(dst + down + NI, D2[r * LDI + c]);
        }
      }
      if (tid < kb)
        d[(long long)b * n + k0 + tid] =
            tid < NI ? D1[tid * LDI + tid] : D2[(tid - NI) * (LDI + 1)];
    }

    const int r0 = k0 + NB;   // first row below the panel (kb == NB here)
    if (r0 < n) {
      // 5. trailing update A22 -= L21 L21^T over the lower-triangle tiles,
      //    split over the cluster, as the two inner panels' updates in turn
      //    (C - acc1) - acc2; the next tile's slices load while the current
      //    one's FMAs run, the tile's own entries during its second half
      const int nt = (n - r0 + NB - 1) / NB;
      const int ntiles = nt * (nt + 1) / 2;
      T ra[16], rb[16];
      int ti = 0, tj = 0;
      if (rank < ntiles) {
        tile_pair(rank, ti, tj);
        load_slice(ra, Lb, n, r0 + ti * NB, k0, tid);
        load_slice(rb, Lb, n, r0 + tj * NB, k0, tid);
      }
      for (int idx = rank; idx < ntiles; idx += cs) {
        const int i0 = r0 + ti * NB, j0 = r0 + tj * NB;
        __syncthreads();
        store_slice(Ps, ra, tid);
        store_slice(Qs, rb, tid);
        __syncthreads();
        if (idx + cs < ntiles) {
          tile_pair(idx + cs, ti, tj);
          load_slice(ra, Lb, n, r0 + ti * NB, k0, tid);
          load_slice(rb, Lb, n, r0 + tj * NB, k0, tid);
        }
        T acc[4][4], cv[4][4];
        half_product<T, MODED>(Ps, Qs, 0, acc, ty, tx, md);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = i0 + ty + 16 * a, j = j0 + tx + 16 * c;
            cv[a][c] = (i < n && j <= i)
                           ? __ldcg(Lb + (long long)i * n + j) : T(0);
          }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) cv[a][c] -= acc[a][c];
        half_product<T, MODED>(Ps, Qs, NI, acc, ty, tx, md);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = i0 + ty + 16 * a, j = j0 + tx + 16 * c;
            if (i < n && j <= i)
              __stcg(Lb + (long long)i * n + j, cv[a][c] - acc[a][c]);
          }
      }
      cluster.sync();   // the trailing matrix is up to date
    }
  }
  if (rank == 0 && tid == 0) ok_out[b] = ok;
}

// The cluster size for a batch of B on device dev: the largest power of
// two <= MAX_CLUSTER with B * CS <= the SM count, halved while fewer than B
// clusters of that size fit on the card at once.
template <typename T, bool MODED>
int cluster_size(int B, int dev, cudaLaunchConfig_t& cfg,
                 cudaLaunchAttribute& attr) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  int cs = MAX_CLUSTER;
  while (cs > 1 && (long long)B * cs > sms) cs >>= 1;
  for (; cs > 1; cs >>= 1) {
    attr.val.clusterDim.x = cs;
    cfg.gridDim = dim3(B * cs);
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, chol_kernel<T, MODED>, &cfg);
    if (err != cudaSuccess) return -(int)err;
    if (fit >= B) break;
  }
  return cs;
}

template <typename T, bool MODED>
int launch_chol(const void* Q, void* L, void* d, void* ok, int B, int n,
                int mode, void* stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      chol_kernel<T, MODED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // the choice depends only on (device, B): keep the last one
  thread_local int last_dev = -1, last_B = -1, last_cs = 1;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != last_dev || B != last_B) {
    const int cs = cluster_size<T, MODED>(B, dev, cfg, attr);
    if (cs < 0) return -cs;
    last_dev = dev;
    last_B = B;
    last_cs = cs;
  }
  attr.val.clusterDim.x = last_cs;
  cfg.gridDim = dim3(B * last_cs);
  err = cudaLaunchKernelEx(&cfg, chol_kernel<T, MODED>, (const T*)Q, (T*)L,
                           (T*)d, (int*)ok, n, mode);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// `mode`: a matmul mode's code (mm_mode.cuh), 0 = IEEE; float64 takes 0
// only
extern "C" int op_chol_f32(const void* Q, void* L, void* d, void* ok, int B,
                           int n, int mode, void* stream) {
  if (mode == 0)
    return launch_chol<float, false>(Q, L, d, ok, B, n, 0, stream);
  if (!onephase::mm_mode_valid(mode)) return (int)cudaErrorInvalidValue;
  return launch_chol<float, true>(Q, L, d, ok, B, n, mode, stream);
}

extern "C" int op_chol_f64(const void* Q, void* L, void* d, void* ok, int B,
                           int n, int mode, void* stream) {
  if (mode != 0) return (int)cudaErrorInvalidValue;
  return launch_chol<double, false>(Q, L, d, ok, B, n, 0, stream);
}
