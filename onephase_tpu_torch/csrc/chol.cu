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
//   entries of the factor takes its operands rounded and split in the
//   mode.  The trailing update runs on the tensor cores (mm_tc.cuh): the
//   two panel slices are split once, when they are staged in shared
//   memory, into one plane a part (TF32 32-bit, bf16 / fp16 16-bit, rows
//   padded so that the fragment loads are conflict-free); each inner
//   panel's product is one mma.sync accumulator a part pair from +0 (a
//   warp owns a 32 x 16 block of the 64 x 64 tile), the pairs summed
//   smallest first, and (C - acc1) - acc2 as in IEEE.  The panel's
//   substitutions and products run on the FP32 cores with every entry of
//   the diagonal block and of L21 split once (planes in shared memory) and
//   each row's entries split once a step: the solve right-looking (x[j]
//   takes x[p]'s products in increasing p, as the left-looking IEEE loop
//   sums them), its row in shared memory, one thread a row, the rows dealt
//   round-robin over the cluster's blocks.  These run in one instantiation
//   a mode (kind and pass set), chosen by a switch at each panel; the tile
//   Cholesky of the diagonal blocks (chol_tile.cuh) is K7's, unchanged.
//   The IEEE instantiations are unchanged, value for value.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chol_tile.cuh"
#include "mm_tc.cuh"

namespace cg = cooperative_groups;

// Phase clocks (a measurement build only: ops/_build.py clock_library
// compiles this file with -DONEPHASE_CHOL_CLOCKS, whose one entry point is
// op_chol_clocks_f32).  Thread 0 of each block reads clock64() at every
// phase boundary and adds the cycles since the last one to the phase that
// ended; at the end it writes them, the total and the cluster size to row
// blockIdx.x of the (blocks, CLK_SLOTS) int64 buffer g_chol_clk.
enum CholPhase { PH_OTHER = 0, PH_DIAG, PH_SOLVE, PH_CROSS, PH_TRAIL,
                 CLK_PHASES };
constexpr int CLK_SLOTS = 8;   // the phases, the total, the cluster size
#ifdef ONEPHASE_CHOL_CLOCKS
__device__ long long* g_chol_clk;
#define CLK_DECL                                  \
  long long clk_[CLK_PHASES] = {};                \
  long long clk0_ = clock64(), clk_last_ = clk0_; \
  int clk_cur_ = PH_OTHER;
#define CLK_MARK(ph)                                           \
  do {                                                         \
    if (threadIdx.x == 0) {                                    \
      const long long t_ = clock64();                          \
      _Pragma("unroll") for (int p_ = 0; p_ < CLK_PHASES; ++p_) \
        if (p_ == clk_cur_) clk_[p_] += t_ - clk_last_;        \
      clk_last_ = t_;                                          \
      clk_cur_ = (ph);                                         \
    }                                                          \
  } while (0)
#define CLK_WRITE(cs)                                                  \
  do {                                                                 \
    CLK_MARK(PH_OTHER);                                                \
    if (threadIdx.x == 0) {                                            \
      long long* row_ = g_chol_clk + (long long)blockIdx.x * CLK_SLOTS; \
      _Pragma("unroll") for (int p_ = 0; p_ < CLK_PHASES; ++p_)        \
        row_[p_] = clk_[p_];                                           \
      row_[CLK_PHASES] = clock64() - clk0_;                            \
      row_[CLK_PHASES + 1] = (cs);                                     \
    }                                                                  \
  } while (0)
#else
#define CLK_DECL
#define CLK_MARK(ph) do {} while (0)
#define CLK_WRITE(cs) do {} while (0)
#endif

namespace {

using onephase::chol_tile;
using onephase::MmMode;
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

// acc[a][c] = sum_{p in [p0, p0 + NI)} A[ty + 16 a][p] Bt[tx + 16 c][p],
// p in increasing order, over slices in shared memory (leading dimension
// ldp<T>())
template <typename T>
__device__ __forceinline__ void half_product(const T* A, const T* Bt, int p0,
                                             T (&acc)[4][4], int ty, int tx) {
  using V = typename Vec<T>::type;
  constexpr int W = vec_w<T>(), LD = ldp<T>();
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = T(0);
#pragma unroll 4
  for (int p = p0; p < p0 + NI; p += W) {
    V av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const V*>(A + (ty + 16 * a) * LD + p);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const V*>(Bt + (tx + 16 * c) * LD + p);
#pragma unroll
    for (int w = 0; w < W; ++w) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[a][c] += comp(av[a], w) * comp(bv[c], w);
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
// inner tile D in shared memory, by forward substitution.
template <typename T>
__device__ __forceinline__ void row_solve(T (&x)[NI], const T* D) {
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    T s = x[j];
#pragma unroll
    for (int p = 0; p < j; ++p) s -= x[p] * D[j * LDI + p];
    x[j] = s / D[j * LDI + j];
  }
}

// ---------------------------------------------------------------------
// The moded panel (chol_kernel<float, true>), one instantiation of each
// routine a mode: KIND (1 TF32, 2 bf16, 3 fp16) and PASSES (1, 3, 6, 9).
// Every product m(a, b) is the pass set's part products of a's and b's
// parts (split once), added in the order of Mode.pairs to the running sum
// (as mm_mode.cuh's mode_fma adds them).

// float parts of x (each exact in the mode's input type)
template <int KIND, int PARTS>
__device__ __forceinline__ void split_parts(float x, float (&p)[PARTS]) {
  float rest = x;
#pragma unroll
  for (int q = 0; q < PARTS; ++q) {
    onephase::Tc<KIND>::round_bits(rest, p[q]);
    rest = rest - p[q];
  }
}

// acc + a b over the pass set, a split into ap, b's parts at b[r * stride]
template <int PASSES>
__device__ __forceinline__ float fma_pairs(
    const float (&ap)[onephase::mode_parts(PASSES)], const float* b,
    int stride, float acc) {
#pragma unroll
  for (int q = 0; q < PASSES; ++q) {
    const int i = onephase::pair_i(9 - PASSES + q);
    const int j = onephase::pair_j(9 - PASSES + q);
    acc = fmaf(ap[i], b[j * stride], acc);
  }
  return acc;
}

constexpr int TILE = NI * LDI;   // a 32 x 32 tile in shared memory

// the parts of the 32 x 32 tile S into Sp (part r at Sp + r TILE).  Not
// inlined, as solve_row: seven modes at three call sites each would only
// lengthen the build
template <int KIND, int PASSES>
__device__ __noinline__ void split_tile(const float* S, float* Sp, int tid) {
  constexpr int PARTS = onephase::mode_parts(PASSES);
  for (int e = tid; e < NI * NI; e += NT) {
    const int o = (e >> 5) * LDI + (e & 31);
    float p[PARTS];
    split_parts<KIND, PARTS>(S[o], p);
#pragma unroll
    for (int r = 0; r < PARTS; ++r) Sp[r * TILE + o] = p[r];
  }
}

// v := v D^-T for the row v[0 .. NI) at stride NT in shared memory (this
// thread's), D factored (Dp its parts): right-looking, so every x[p] is
// split once, and each x[j] takes its products in increasing p, then its
// division, as the left-looking loop does
template <int KIND, int PASSES>
__device__ __noinline__ void solve_row(float* v, const float* Dp,
                                       const float* D) {
  constexpr int PARTS = onephase::mode_parts(PASSES);
#pragma unroll 1
  for (int p = 0; p < NI; ++p) {
    const float x = v[p * NT] / D[p * LDI + p];
    v[p * NT] = x;
    float xp[PARTS];
    split_parts<KIND, PARTS>(-x, xp);
#pragma unroll 1
    for (int j = p + 1; j < NI; ++j)
      v[j * NT] = fma_pairs<PASSES>(xp, Dp + j * LDI + p, TILE, v[j * NT]);
  }
}

// acc[c] = sum_p m(v[p], W[c][p]) from +0, p increasing (Wp: W's parts)
template <int KIND, int PASSES>
__device__ __forceinline__ void cross_row(const float* v, const float* Wp,
                                          float (&acc)[NI]) {
  constexpr int PARTS = onephase::mode_parts(PASSES);
#pragma unroll
  for (int c = 0; c < NI; ++c) acc[c] = 0.0f;
#pragma unroll 1
  for (int p = 0; p < NI; ++p) {
    float xp[PARTS];
    split_parts<KIND, PARTS>(v[p * NT], xp);
#pragma unroll
    for (int c = 0; c < NI; ++c)
      acc[c] = fma_pairs<PASSES>(xp, Wp + c * LDI + p, TILE, acc[c]);
  }
}

// D2[r][c] -= sum_p m(W[r][p], W[c][p]) (from +0, p increasing), c <= r
template <int KIND, int PASSES>
__device__ __forceinline__ void cross_w(const float* Wp, float* D2,
                                        int tid) {
  constexpr int PARTS = onephase::mode_parts(PASSES);
  for (int e = tid; e < NI * NI; e += NT) {
    const int r = e >> 5, c = e & 31;
    if (c > r) continue;
    float acc = 0.0f;
#pragma unroll 4
    for (int p = 0; p < NI; ++p) {
      float ap[PARTS];
#pragma unroll
      for (int q = 0; q < PARTS; ++q) ap[q] = Wp[q * TILE + r * LDI + p];
      acc = fma_pairs<PASSES>(ap, Wp + c * LDI + p, TILE, acc);
    }
    D2[r * LDI + c] -= acc;
  }
}

// call FN<KIND, PASSES>(...) for the mode's code (16 kind + passes)
#define MODE_DISPATCH(code, FN, ...)                \
  switch (code) {                                   \
    case 0x11: FN<1, 1>(__VA_ARGS__); break;        \
    case 0x13: FN<1, 3>(__VA_ARGS__); break;        \
    case 0x21: FN<2, 1>(__VA_ARGS__); break;        \
    case 0x23: FN<2, 3>(__VA_ARGS__); break;        \
    case 0x26: FN<2, 6>(__VA_ARGS__); break;        \
    case 0x29: FN<2, 9>(__VA_ARGS__); break;        \
    default: FN<3, 1>(__VA_ARGS__); break;          \
  }

// The trailing update A22 -= L21 L21^T of the moded kernel, on the tensor
// cores of KIND: the lower-triangle 64-tiles of the trailing matrix from
// row r0, split over the cluster; per tile, the two 64 x 64 panel slices
// (rows of L21 from i0 and from j0) split into part planes once (row r
// of part q at planes + (side * PARTS + q) * PLANE + r * LDS), then each
// inner panel's product C - sum_pairs acc, pairs smallest first.  The next
// tile's slices load while the current one's products run.
template <int KIND>
struct TrailPlanes {
  using Sx = typename onephase::Tc<KIND>::S;
  // a row of a plane: 64 entries and a pad that puts the rows of a
  // fragment load on distinct banks (68 words; 72 halves = 36 words)
  static constexpr int LDS = KIND == 1 ? NB + 4 : NB + 8;
  static constexpr int PLANE = NB * LDS;
  static constexpr int PARTS = KIND == 1 ? 2 : 3;   // at most
  static constexpr int BYTES = 2 * PARTS * PLANE * (int)sizeof(Sx);
};

template <int KIND>
__device__ __forceinline__ void trailing_tc(float* Lb, int n, int r0, int k0,
                                            int rank, int cs, int tid,
                                            unsigned char* U, int passes) {
  using TP = TrailPlanes<KIND>;
  using Sx = typename TP::Sx;
  using TC = onephase::Tc<KIND>;
  constexpr int LDS = TP::LDS, PLANE = TP::PLANE;
  const int parts = onephase::mode_parts(passes);
  Sx* Pp = reinterpret_cast<Sx*>(U);        // row side (from i0)
  Sx* Qp = Pp + TP::PARTS * PLANE;          // column side (from j0)
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp >> 2) * 32, wc = (warp & 3) * 16;   // the warp's block
  const int nt = (n - r0 + NB - 1) / NB;
  const int ntiles = nt * (nt + 1) / 2;
  float ra[16], rb[16];
  int ti = 0, tj = 0;
  if (rank < ntiles) {
    tile_pair(rank, ti, tj);
    load_slice(ra, Lb, n, r0 + ti * NB, k0, tid);
    load_slice(rb, Lb, n, r0 + tj * NB, k0, tid);
  }
  for (int idx = rank; idx < ntiles; idx += cs) {
    const int i0 = r0 + ti * NB, j0 = r0 + tj * NB;
    __syncthreads();   // the previous tile's planes are read
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int o = ((tid >> 6) + 4 * q) * LDS + (tid & 63);
      Sx pa[TP::PARTS], pb[TP::PARTS];
      onephase::tc_split<KIND, TP::PARTS>(ra[q], pa);
      onephase::tc_split<KIND, TP::PARTS>(rb[q], pb);
#pragma unroll
      for (int r = 0; r < TP::PARTS; ++r)
        if (r < parts) {
          Pp[r * PLANE + o] = pa[r];
          Qp[r * PLANE + o] = pb[r];
        }
    }
    __syncthreads();
    if (idx + cs < ntiles) {
      tile_pair(idx + cs, ti, tj);
      load_slice(ra, Lb, n, r0 + ti * NB, k0, tid);
      load_slice(rb, Lb, n, r0 + tj * NB, k0, tid);
    }
    // the C fragments: tile row wr + 16 a + g + 8 (r / 2), column
    // wc + 8 c + 2 t4 + r % 2
    float cv[2][2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + wr + 16 * a + g + 8 * (r >> 1);
          const int j = j0 + wc + 8 * c + 2 * t4 + (r & 1);
          cv[a][c][r] = (i < n && j <= i)
                            ? __ldcg(Lb + (long long)i * n + j) : 0.0f;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum[2][2][4];
#pragma unroll 1
      for (int q = 0; q < passes; ++q) {
        const Sx* A = Pp + onephase::pair_i(9 - passes + q) * PLANE;
        const Sx* Bt = Qp + onephase::pair_j(9 - passes + q) * PLANE;
        float acc[2][2][4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[a][c][r] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < NI / TC::K; ++ks) {
          const int kk = NI * h + ks * TC::K;
          uint32_t af[2][4], bf[2][2];
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const Sx* r0p = A + (wr + 16 * a + g) * LDS + kk;
            const Sx* r8p = r0p + 8 * LDS;
            if constexpr (KIND == 1) {
              af[a][0] = r0p[t4];
              af[a][1] = r8p[t4];
              af[a][2] = r0p[t4 + 4];
              af[a][3] = r8p[t4 + 4];
            } else {
              af[a][0] = *reinterpret_cast<const uint32_t*>(r0p + 2 * t4);
              af[a][1] = *reinterpret_cast<const uint32_t*>(r8p + 2 * t4);
              af[a][2] = *reinterpret_cast<const uint32_t*>(r0p + 2 * t4 + 8);
              af[a][3] = *reinterpret_cast<const uint32_t*>(r8p + 2 * t4 + 8);
            }
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const Sx* cp = Bt + (wc + 8 * c + g) * LDS + kk;
            if constexpr (KIND == 1) {
              bf[c][0] = cp[t4];
              bf[c][1] = cp[t4 + 4];
            } else {
              bf[c][0] = *reinterpret_cast<const uint32_t*>(cp + 2 * t4);
              bf[c][1] = *reinterpret_cast<const uint32_t*>(cp + 2 * t4 + 8);
            }
          }
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int c = 0; c < 2; ++c) TC::mma(acc[a][c], af[a], bf[c]);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              sum[a][c][r] = q == 0 ? acc[a][c][r]
                                    : sum[a][c][r] + acc[a][c][r];
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[a][c][r] -= sum[a][c][r];
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + wr + 16 * a + g + 8 * (r >> 1);
          const int j = j0 + wc + 8 * c + 2 * t4 + (r & 1);
          if (i < n && j <= i)
            __stcg(Lb + (long long)i * n + j, cv[a][c][r]);
        }
  }
}

// the moded kernel's shared memory beyond the three inner tiles: the
// trailing update's planes, or (the panel) one row a thread (NI x NT) and
// the parts of L11, L21 of the 64 x 64 block and L22 (3 parts each)
constexpr int PANEL_FLOATS = NI * NT + 3 * 3 * TILE;
constexpr int MODED_UNION_FLOATS =
    PANEL_FLOATS * 4 > TrailPlanes<1>::BYTES
        ? (PANEL_FLOATS * 4 > TrailPlanes<2>::BYTES ? PANEL_FLOATS
                                                    : TrailPlanes<2>::BYTES / 4)
        : (TrailPlanes<1>::BYTES > TrailPlanes<2>::BYTES
               ? TrailPlanes<1>::BYTES / 4 : TrailPlanes<2>::BYTES / 4);

// the inner tiles, the panel slices (MODED: the union above) and
// chol_tile's scratch
template <typename T, bool MODED>
constexpr size_t smem_bytes() {
  return sizeof(T) * (3 * NI * LDI +
                      (MODED ? MODED_UNION_FLOATS : 2 * NB * ldp<T>()) +
                      6 * NI + 2);
}

// MODED (float32 only): every product of two entries of the factor is
// taken in the matmul mode `mode` (mm_mode.cuh): the trailing updates, the
// panel's substitutions and updates, and the diagonal tiles' column
// updates (see the top of this file).  The IEEE instantiations ignore
// `mode`.
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
  // MODED: from Ps on, the trailing planes or the panel's rows (NI x NT,
  // this thread's at V + tid) and the parts of L11, L21, L22
  float* V = reinterpret_cast<float*>(Ps);
  float* D1p = V + NI * NT;
  float* Wp = D1p + 3 * TILE;
  float* D2p = Wp + 3 * TILE;
  T* vec = MODED ? Ps + MODED_UNION_FLOATS
                 : Qs + NB * ldp<T>();      // chol_tile's scratch

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long nn = (long long)n * n;
  const T* A = Q + (long long)b * nn;
  T* Lb = L + (long long)b * nn;
  CLK_DECL

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
    CLK_MARK(PH_DIAG);
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
    if constexpr (MODED) {
      if (kb > NI) {
        // L11's parts; L21 (a thread a row); its parts; A22 - L21 L21^T
        MODE_DISPATCH(mode, split_tile, D1, D1p, tid);
        __syncthreads();
        CLK_MARK(PH_SOLVE);
        if (tid < NI) {
          for (int p = 0; p < NI; ++p) V[p * NT + tid] = W[tid * LDI + p];
          MODE_DISPATCH(mode, solve_row, V + tid, D1p, D1);
          for (int p = 0; p < NI; ++p) W[tid * LDI + p] = V[p * NT + tid];
        }
        __syncthreads();
        CLK_MARK(PH_CROSS);
        MODE_DISPATCH(mode, split_tile, W, Wp, tid);
        __syncthreads();
        MODE_DISPATCH(mode, cross_w, Wp, D2, tid);
        CLK_MARK(PH_DIAG);
        chol_tile<T, NI, NT, false, MODED>(D2, nullptr, vec, own, tid, ok,
                                           md);
        MODE_DISPATCH(mode, split_tile, D2, D2p, tid);
        __syncthreads();
      }
    } else if (kb > NI) {
      CLK_MARK(PH_SOLVE);
      if (tid < NI) {
        T x[NI];
#pragma unroll
        for (int p = 0; p < NI; ++p) x[p] = W[tid * LDI + p];
        row_solve<T>(x, D1);
#pragma unroll
        for (int p = 0; p < NI; ++p) W[tid * LDI + p] = x[p];
      }
      __syncthreads();
      CLK_MARK(PH_CROSS);
      for (int e = tid; e < NI * NI; e += NT) {
        const int r = e >> 5, c = e & 31;
        if (c <= r) {
          T acc = T(0);
#pragma unroll 8
          for (int p = 0; p < NI; ++p)
            acc += W[r * LDI + p] * W[c * LDI + p];
          D2[r * LDI + c] -= acc;
        }
      }
      CLK_MARK(PH_DIAG);
      chol_tile<T, NI, NT, false, MODED>(D2, nullptr, vec, own, tid, ok,
                                         md);
    }

    // 3. the rows below the block, one per thread, split over the
    //    cluster: the first 32 columns solved against L11, the next 32
    //    updated with them and solved against L22 (MODED: a row in shared
    //    memory, the rows dealt round-robin over the cluster's blocks)
    if constexpr (MODED) {
      float* v = V + tid;
      for (int i = k0 + NB + rank + cs * tid; i < n; i += cs * NT) {
        T* row = Lb + (long long)i * n + k0;
        for (int p = 0; p < NI; ++p) v[p * NT] = __ldcg(row + p);
        CLK_MARK(PH_SOLVE);
        MODE_DISPATCH(mode, solve_row, v, D1p, D1);
        CLK_MARK(PH_CROSS);
        float acc[NI];
        MODE_DISPATCH(mode, cross_row, v, Wp, acc);
        CLK_MARK(PH_OTHER);
        for (int p = 0; p < NI; ++p) __stcg(row + p, v[p * NT]);
#pragma unroll
        for (int c = 0; c < NI; ++c) v[c * NT] = __ldcg(row + NI + c) - acc[c];
        CLK_MARK(PH_SOLVE);
        MODE_DISPATCH(mode, solve_row, v, D2p, D2);
        CLK_MARK(PH_OTHER);
        for (int p = 0; p < NI; ++p) __stcg(row + NI + p, v[p * NT]);
      }
    } else {
      for (int i = k0 + NB + rank * NT + tid; i < n; i += cs * NT) {
        T* row = Lb + (long long)i * n + k0;
        T x[NI], y[NI];
#pragma unroll
        for (int p = 0; p < NI; ++p) x[p] = __ldcg(row + p);
#pragma unroll
        for (int p = 0; p < NI; ++p) y[p] = __ldcg(row + NI + p);
        CLK_MARK(PH_SOLVE);
        row_solve<T>(x, D1);
        CLK_MARK(PH_CROSS);
#pragma unroll
        for (int c = 0; c < NI; ++c) {
          T acc = T(0);
#pragma unroll
          for (int p = 0; p < NI; ++p) acc += x[p] * W[c * LDI + p];
          y[c] -= acc;
        }
        CLK_MARK(PH_SOLVE);
        row_solve<T>(y, D2);
        CLK_MARK(PH_OTHER);
#pragma unroll
        for (int p = 0; p < NI; ++p) __stcg(row + p, x[p]);
#pragma unroll
        for (int p = 0; p < NI; ++p) __stcg(row + NI + p, y[p]);
      }
    }
    CLK_MARK(PH_OTHER);
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
    if constexpr (MODED) {
      if (r0 < n) {
        CLK_MARK(PH_TRAIL);
        // 5. the trailing update on the tensor cores
        unsigned char* U = reinterpret_cast<unsigned char*>(Ps);
        switch (md.kind) {
          case 1: trailing_tc<1>(Lb, n, r0, k0, rank, cs, tid, U, md.passes);
                  break;
          case 2: trailing_tc<2>(Lb, n, r0, k0, rank, cs, tid, U, md.passes);
                  break;
          default: trailing_tc<3>(Lb, n, r0, k0, rank, cs, tid, U,
                                  md.passes);
                   break;
        }
        CLK_MARK(PH_OTHER);
        cluster.sync();   // the trailing matrix is up to date
      }
    } else if (r0 < n) {
      CLK_MARK(PH_TRAIL);
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
        half_product<T>(Ps, Qs, 0, acc, ty, tx);
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
        half_product<T>(Ps, Qs, NI, acc, ty, tx);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = i0 + ty + 16 * a, j = j0 + tx + 16 * c;
            if (i < n && j <= i)
              __stcg(Lb + (long long)i * n + j, cv[a][c] - acc[a][c]);
          }
      }
      CLK_MARK(PH_OTHER);
      cluster.sync();   // the trailing matrix is up to date
    }
  }
  if (rank == 0 && tid == 0) ok_out[b] = ok;
  CLK_WRITE(cs);
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
  const size_t smem = smem_bytes<T, MODED>();
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

#ifdef ONEPHASE_CHOL_CLOCKS
// op_chol_f32 with the phase clocks written to `clk` (int64, at least
// (B * MAX_CLUSTER, CLK_SLOTS), zeroed by the caller)
extern "C" int op_chol_clocks_f32(const void* Q, void* L, void* d, void* ok,
                                  int B, int n, int mode, void* clk,
                                  void* stream) {
  const cudaError_t err = cudaMemcpyToSymbolAsync(
      g_chol_clk, &clk, sizeof(clk), 0, cudaMemcpyHostToDevice,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (mode == 0)
    return launch_chol<float, false>(Q, L, d, ok, B, n, 0, stream);
  if (!onephase::mm_mode_valid(mode)) return (int)cudaErrorInvalidValue;
  return launch_chol<float, true>(Q, L, d, ok, B, n, mode, stream);
}
#else
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
#endif
