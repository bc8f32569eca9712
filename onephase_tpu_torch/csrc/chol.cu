// Batched blocked Cholesky: Q (B, n, n) -> L (lower, strict upper zeroed),
// d = diag(L) (B, n), ok (B,) = every pivot positive and finite.
//
// Replaces the TPU kernel onephase_tpu/ops/cholesky.py:pallas_chol
// (_chol_kernel :99-128 with _unblocked_chol :48-75 and _tri_inv_unblocked
// :78-96).  Pivot protocol as in _unblocked_chol (see chol_tile.cuh); on
// failure L is garbage and only ok matters.
//
// What bounds it on the H100, by route (times: PERF.md, K2):
// - All routes: the serial chain of panels (each 64-column panel must be
//   factored before the next starts; its diagonal tiles by one block each),
//   and, with one block per instance, the number of SMs a batch can use
//   (16 of 132 at the bench's B = 16).  At n = 256 the diagonal tiles and
//   the copy of Q take most of the time.
// - IEEE float32: the FP32 FMA rate of the trailing updates A22 -= L21
//   L21^T (n^3 / 3 multiply-adds an instance), fed from shared memory.
// - float64: the trailing updates on the FP64 tensor cores (DMMA), then
//   the trailing matrix's passes through HBM (read and written once a
//   panel) and the panel's substitutions on the FP64 cores.
// - The split matmul modes (3, 6, 9 part products): at n = 1024 the
//   trailing update's part products (about 40%), the diagonal tiles'
//   moded chain on the FP32 cores (chol_tile.cuh, 22-31%) and the panel's
//   substitutions (20-25%); at n = 256 the diagonal tiles (58-66%).
// - At the main path's small shapes a call's host work (the wrapper and
//   the launch) outlasted the kernel: the launch path reads the device's
//   attributes once (launch.cuh) and the wrappers test their operands once.
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
//   two inner tiles (float64: the second half of the row in shared memory,
//   as both halves in registers spilled).  Rank 0 writes the diagonal
//   block and d once every block has read it.
// - The trailing update: 64 x 64 lower-triangle tiles split over the
//   cluster, the two 64 x 64 panel slices in shared memory.  Each tile
//   takes the two inner panels' updates in turn, (C - acc1) - acc2, so one
//   pass over the trailing matrix does the work of two.  IEEE float32: the
//   tiles dealt round-robin, a 4 x 4 register block a thread on the FP32
//   cores, the next tile's slices loaded into registers while the current
//   tile's FMAs run.  float64 and the modes: a contiguous column-major
//   range of tiles a block (tile_range), so a block's consecutive tiles
//   share their column slice, staged once.  float64 runs on the FP64
//   tensor cores, mma.sync m16n8k8 f64 (mm_tc.cuh Dmma), a warp a 32 x 16
//   block of the tile, each inner panel's product an accumulator from +0:
//   an f64 mma's D is the FP64 cores' fma chain over its k, ascending
//   (tools/dmma_probe.py), so the values are those of the FP64-core loop,
//   bit for bit.
// - The IEEE arithmetic is value for value that of the earlier one-block,
//   32-column kernel (the same products summed in the same order, the
//   panel by forward substitution): the f32 bench trajectories, which are
//   sensitive to the last bit of the factor, stay as they were.  A variant
//   with 64-column tiles that multiplied the panel by the inverted diagonal
//   block, as the TPU kernel does, moved the n=256/B=16 f32 bench from
//   16/16 certified to 15/16.  f32 stays on the FP32 cores (no TF32).  The
//   ragged last panel is padded with the identity in shared memory; the
//   ragged edge of L is masked.
// - A `matmul_precision` mode (mm_mode.cuh; float32 only) runs in the one
//   moded instantiation, chol_kernel<float, true>: every product of two
//   entries of the factor takes its operands rounded and split in the
//   mode.  The trailing update runs on the tensor cores (mm_tc.cuh), one
//   instantiation a mode: the panel slices are split when they are staged
//   in shared memory into one plane a part (TF32 32-bit, bf16 / fp16
//   16-bit, rows padded so that the fragment loads are conflict-free);
//   each inner panel's product is one mma.sync accumulator a part pair
//   from +0 (a warp owns a 32 x 16 block of the 64 x 64 tile), the pairs
//   summed smallest first, and (C - acc1) - acc2 as in IEEE.  A warp reads
//   each part's fragments once and runs every pair's mma on them: read
//   again for each pair, they bound the split modes' update.  The panel: in the one-pass modes (tf32, bf16, f16; each
//   product exact in float32) its substitutions and products run on the
//   FP32 cores as the twin's float32 chain does, every entry of the
//   diagonal block and of L21 split once (planes in shared memory), the
//   solve right-looking (x[j] takes x[p]'s products in increasing p), its
//   row in shared memory, one thread a row, dealt round-robin over the
//   cluster's blocks; a sum on the tensor cores cannot meet that chain
//   (PERF.md, F3).  In the split modes the panel runs on the tensor cores
//   too (panel_block, panel_rows): 16 rows a warp, sub-blocks of the mma
//   depth solved on the FP32 cores, every other product an mma part
//   product.  One instantiation of each routine a mode (kind and pass set),
//   chosen by a switch at each panel; the tile Cholesky of the diagonal
//   blocks (chol_tile.cuh) is K7's, unchanged.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chol_tile.cuh"
#include "launch.cuh"
#include "mm_tc.cuh"

namespace cg = cooperative_groups;

// Phase clocks (a measurement build only: ops/_build.py clock_library
// compiles this file with -DONEPHASE_CHOL_CLOCKS, whose entry points are
// op_chol_clocks_f32 and op_chol_clocks_f64).  Thread 0 of each block
// reads clock64() at every phase boundary and adds the cycles since the
// last one to the phase that ended; at the end it writes them, the total
// and the cluster size to row blockIdx.x of the (blocks, CLK_SLOTS) int64
// buffer g_chol_clk.
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
// elements of a 16-byte vector, and the panel slices' leading dimension:
// 64 entries and a pad of 16 bytes (float: the FP32 cores' 16-byte loads
// along the depth are conflict-free) or 32 bytes (double: the FP64 tensor
// cores' fragment loads, row g and depth t over a warp's lanes, fall on
// distinct banks in each half warp, 68 g + t distinct mod 16)
template <typename T> __host__ __device__ constexpr int vec_w() { return 16 / sizeof(T); }
template <typename T> __host__ __device__ constexpr int ldp() { return NB + 4; }

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

// call FN<KIND, PASSES>(...) for a one-pass mode's code (16 kind + 1)
#define ONE_PASS_DISPATCH(code, FN, ...)            \
  switch (code) {                                   \
    case 0x11: FN<1, 1>(__VA_ARGS__); break;        \
    case 0x21: FN<2, 1>(__VA_ARGS__); break;        \
    default: FN<3, 1>(__VA_ARGS__); break;          \
  }

// call FN<KIND, PASSES>(...) for a split mode's code (16 kind + passes)
#define SPLIT_DISPATCH(code, FN, ...)               \
  switch (code) {                                   \
    case 0x13: FN<1, 3>(__VA_ARGS__); break;        \
    case 0x23: FN<2, 3>(__VA_ARGS__); break;        \
    case 0x26: FN<2, 6>(__VA_ARGS__); break;        \
    default: FN<2, 9>(__VA_ARGS__); break;          \
  }

// ---------------------------------------------------------------------
// The split modes' panel (3, 6 or 9 part products: 0x13, 0x23, 0x26,
// 0x29) on the tensor cores.  The diagonal tiles stay chol_tile's; every
// other product of the panel runs as mma.sync part products.
// - Each factored 32 x 32 tile (L11, the block's L21 = W, L22) is split
//   once into part planes in the mma's operand type (rows row-major, the
//   depth contiguous, rows padded so that fragment loads fall on distinct
//   banks).
// - A warp solves 16 rows at a time (an m16 fragment), in a buffer of
//   their 64 floats: an inner panel in sub-blocks of K columns (the mma
//   depth: 8 TF32, 16 bf16).  A sub-block first takes its product with the
//   columns before it (the rows' part planes by the tile's rows in it, one
//   accumulator a part pair from +0, the pairs summed smallest first, as
//   mm_tc.cuh sums them), then lanes 0-15, a row each, solve it on the
//   FP32 cores as the one-pass route's solve_row does (right-looking, each
//   x split once) and write each x's parts into the warp's planes.  The
//   second inner panel first takes the cross product X1 W^T the same way.
// - The rows below the block are dealt to the cluster's warps in 16-row
//   chunks; the block's own W rows take warps 0 and 1 of every block, and
//   A22 - W W^T one m16n8 block a warp.
// Values: within a sub-block the one-pass route's arithmetic; across
// sub-blocks and in the cross products the pairs' sums of mm_tc.cuh
// (held within PREC_TOL of blocked_chol, which sums each column's products
// at once; bit for bit on one-product operands).
template <int KIND>
struct PanelTc {
  using Sx = typename onephase::Tc<KIND>::S;
  static constexpr int K = onephase::Tc<KIND>::K;   // also a sub-block's width
  // a plane row: 32 entries and a pad (36 words; 40 halves = 20 words)
  static constexpr int LDT = KIND == 1 ? NI + 4 : NI + 8;
  static constexpr int PARTS = KIND == 1 ? 2 : 3;   // at most
  static constexpr int DPLANE = NI * LDT;           // a tile's part
  static constexpr int XPLANE = 16 * LDT;           // a warp's 16 rows' part
};
// a warp's row buffer: 16 rows of 64 floats, a row LDV floats apart
constexpr int LDV = NB + 1;
constexpr int VW_FLOATS = 16 * LDV;
// the panel's shared memory (in the moded kernel's union): the planes of
// L11, W and L22, then each warp's planes, then each warp's row buffer;
// sized for TF32 (2 parts of 4 bytes), which bounds bf16 (3 of 2)
constexpr int PANEL_DT_BYTES = 3 * 2 * NI * (NI + 4) * 4;
constexpr int PANEL_XT_BYTES = (NT / 32) * 2 * 16 * (NI + 4) * 4;
constexpr int PANEL_TC_BYTES =
    PANEL_DT_BYTES + PANEL_XT_BYTES + (NT / 32) * VW_FLOATS * 4;
static_assert(3 * 3 * NI * (NI + 8) * 2 <= PANEL_DT_BYTES &&
                  (NT / 32) * 3 * 16 * (NI + 8) * 2 <= PANEL_XT_BYTES,
              "bf16 planes fit the TF32 sizes");

// a part (exact in KIND's type) as its plane bits, and back
template <int KIND>
__device__ __forceinline__ typename onephase::Tc<KIND>::S part_bits(float v) {
  if constexpr (KIND == 1) return __float_as_uint(v);
  else if constexpr (KIND == 2) return (unsigned short)(__float_as_uint(v) >> 16);
  else return __half_as_ushort(__float2half_rn(v));
}
template <int KIND>
__device__ __forceinline__ float part_float(typename onephase::Tc<KIND>::S s) {
  if constexpr (KIND == 1) return __uint_as_float(s);
  else if constexpr (KIND == 2) return __uint_as_float((uint32_t)s << 16);
  else return __half2float(__ushort_as_half(s));
}

// the parts of the 32 x 32 tile S into plane set `which` of the panel's
// (0 L11, 1 W, 2 L22)
template <int KIND, int PASSES>
__device__ __noinline__ void split_planes(const float* S, unsigned char* U,
                                          int which, int tid) {
  using P = PanelTc<KIND>;
  constexpr int PARTS = onephase::mode_parts(PASSES);
  typename P::Sx* Pl =
      reinterpret_cast<typename P::Sx*>(U) + which * P::PARTS * P::DPLANE;
  for (int e = tid; e < NI * NI; e += NT) {
    const int r = e >> 5, c = e & 31;
    float p[PARTS];
    split_parts<KIND, PARTS>(S[r * LDI + c], p);
#pragma unroll
    for (int q = 0; q < PARTS; ++q)
      Pl[q * P::DPLANE + r * P::LDT + c] = part_bits<KIND>(p[q]);
  }
}

// the A (row) or B (column) fragment of the plane rows from p (row 0, k 0
// at p, LDS apart): a_i at (row g + 8 (i % 2), k 2 t + 8 (i / 2)) for
// 16-bit kinds, (row g + 8 (i % 2), k t + 4 (i / 2)) for TF32; b_i at
// (row g, k as a_{2 i})
template <int KIND, int LDS>
__device__ __forceinline__ void frag_a(const typename onephase::Tc<KIND>::S* p,
                                       int g, int t4, uint32_t (&f)[4]) {
  const auto* r0p = p + g * LDS;
  const auto* r8p = r0p + 8 * LDS;
  if constexpr (KIND == 1) {
    f[0] = r0p[t4];
    f[1] = r8p[t4];
    f[2] = r0p[t4 + 4];
    f[3] = r8p[t4 + 4];
  } else {
    f[0] = *reinterpret_cast<const uint32_t*>(r0p + 2 * t4);
    f[1] = *reinterpret_cast<const uint32_t*>(r8p + 2 * t4);
    f[2] = *reinterpret_cast<const uint32_t*>(r0p + 2 * t4 + 8);
    f[3] = *reinterpret_cast<const uint32_t*>(r8p + 2 * t4 + 8);
  }
}
template <int KIND, int LDS>
__device__ __forceinline__ void frag_b(const typename onephase::Tc<KIND>::S* p,
                                       int g, int t4, uint32_t (&f)[2]) {
  const auto* cp = p + g * LDS;
  if constexpr (KIND == 1) {
    f[0] = cp[t4];
    f[1] = cp[t4 + 4];
  } else {
    f[0] = *reinterpret_cast<const uint32_t*>(cp + 2 * t4);
    f[1] = *reinterpret_cast<const uint32_t*>(cp + 2 * t4 + 8);
  }
}

// sum[c][e] = the pass set's part products of the warp's 16 rows of A
// (plane q at A + q AP) and the 8 N8 rows of Bt (plane q at Bt + q BP) over
// the depth [0, kn), one accumulator a pair from +0, the pairs summed
// smallest first; entry e of n8 tile c at row g + 8 (e / 2), column
// 8 c + 2 t + e % 2 (g = lane / 4, t = lane % 4)
template <int KIND, int PASSES, int N8>
__device__ __forceinline__ void warp_product(
    const typename PanelTc<KIND>::Sx* A, int AP,
    const typename PanelTc<KIND>::Sx* Bt, int BP, int kn,
    float (&sum)[N8][4], int lane) {
  using P = PanelTc<KIND>;
  using TC = onephase::Tc<KIND>;
  using Sx = typename P::Sx;
  constexpr int LDT = P::LDT;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int q = 0; q < PASSES; ++q) {
    const Sx* Ai = A + onephase::pair_i(9 - PASSES + q) * AP;
    const Sx* Bj = Bt + onephase::pair_j(9 - PASSES + q) * BP;
    float acc[N8][4];
#pragma unroll
    for (int c = 0; c < N8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
    for (int kk = 0; kk < kn; kk += TC::K) {
      uint32_t af[4], bf[N8][2];
      frag_a<KIND, LDT>(Ai + kk, g, t4, af);
#pragma unroll
      for (int c = 0; c < N8; ++c)
        frag_b<KIND, LDT>(Bj + 8 * c * LDT + kk, g, t4, bf[c]);
#pragma unroll
      for (int c = 0; c < N8; ++c) TC::mma(acc[c], af, bf[c]);
    }
#pragma unroll
    for (int c = 0; c < N8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sum[c][e] = q == 0 ? acc[c][e] : sum[c][e] + acc[c][e];
  }
}

// this lane's row v[c0 .. c0 + K) (after the products with the columns
// before c0) solved against the diagonal block [c0, c0 + K) of the factored
// tile D (its planes Dt), as the one-pass route's solve_row: right-looking,
// each x split once (its parts of -x, negated, into the lane's plane row
// Xr), x[j] taking x[p]'s products in increasing p, then its division
template <int KIND, int PASSES>
__device__ __forceinline__ void sub_solve(
    float* v, const float* D, const typename PanelTc<KIND>::Sx* Dt,
    typename PanelTc<KIND>::Sx* Xr, int c0) {
  using P = PanelTc<KIND>;
  constexpr int S = P::K, PARTS = onephase::mode_parts(PASSES);
  float R[S];
#pragma unroll
  for (int j = 0; j < S; ++j) R[j] = v[c0 + j];
#pragma unroll
  for (int p = 0; p < S; ++p) {
    const float x = R[p] / D[(c0 + p) * LDI + c0 + p];
    R[p] = x;
    float xp[PARTS];
    split_parts<KIND, PARTS>(-x, xp);
#pragma unroll
    for (int q = 0; q < PARTS; ++q)
      Xr[q * P::XPLANE + c0 + p] = part_bits<KIND>(-xp[q]);
#pragma unroll
    for (int j = p + 1; j < S; ++j) {
      float dp[PARTS];   // D[c0 + j][c0 + p]'s parts, read once
#pragma unroll
      for (int q = 0; q < PARTS; ++q)
        dp[q] = part_float<KIND>(
            Dt[q * P::DPLANE + (c0 + j) * P::LDT + c0 + p]);
#pragma unroll
      for (int q = 0; q < PASSES; ++q)
        R[j] = fmaf(xp[onephase::pair_i(9 - PASSES + q)],
                    dp[onephase::pair_j(9 - PASSES + q)], R[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < S; ++j) v[c0 + j] = R[j];
}

// the warp's 16 rows (buffer v), columns [col, col + NI), solved against the
// factored tile D (planes Dt), sub-block by sub-block; the rows' parts into
// the warp's planes Xt (row r at Xt + r LDT, columns 0 .. NI)
template <int KIND, int PASSES>
__device__ __noinline__ void warp_solve(
    float* v, int col, const float* D, const typename PanelTc<KIND>::Sx* Dt,
    typename PanelTc<KIND>::Sx* Xt, int lane) {
  using P = PanelTc<KIND>;
  constexpr int S = P::K, N8 = S / 8;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll 1
  for (int c0 = 0; c0 < NI; c0 += S) {
    if (c0 > 0) {
      float sum[N8][4];
      warp_product<KIND, PASSES, N8>(Xt, P::XPLANE, Dt + c0 * P::LDT,
                                     P::DPLANE, c0, sum, lane);
#pragma unroll
      for (int c = 0; c < N8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[(g + 8 * (e >> 1)) * LDV + col + c0 + 8 * c + 2 * t4 + (e & 1)] -=
              sum[c][e];
      __syncwarp();
    }
    if (lane < 16)
      sub_solve<KIND, PASSES>(v + lane * LDV + col, D, Dt, Xt + lane * P::LDT,
                              c0);
    __syncwarp();
  }
}

// The block's part of the 64 x 64 diagonal block after L11 (D1) is factored:
// L11's planes; W := A21 L11^-T (warps 0 and 1, 16 rows each); W's planes;
// D2 := A22 - W W^T (lower triangle), a warp an m16n8 block of the 32 x 32
template <int KIND, int PASSES>
__device__ __noinline__ void panel_block(const float* D1, float* W, float* D2,
                                         unsigned char* U, int tid) {
  using P = PanelTc<KIND>;
  using Sx = typename P::Sx;
  const Sx* D1t = reinterpret_cast<const Sx*>(U);
  const Sx* Wt = D1t + P::PARTS * P::DPLANE;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  split_planes<KIND, PASSES>(D1, U, 0, tid);
  __syncthreads();
  if (warp < 2) {
    Sx* Xt = reinterpret_cast<Sx*>(U + PANEL_DT_BYTES) +
             warp * P::PARTS * P::XPLANE;
    float* v = reinterpret_cast<float*>(U + PANEL_DT_BYTES + PANEL_XT_BYTES) +
               warp * VW_FLOATS;
    for (int r = 0; r < 16; ++r) v[r * LDV + lane] = W[(16 * warp + r) * LDI + lane];
    __syncwarp();
    warp_solve<KIND, PASSES>(v, 0, D1, D1t, Xt, lane);
    for (int r = 0; r < 16; ++r) W[(16 * warp + r) * LDI + lane] = v[r * LDV + lane];
  }
  __syncthreads();
  split_planes<KIND, PASSES>(W, U, 1, tid);
  __syncthreads();
  const int mt = warp >> 2, n8 = warp & 3;
  float sum[1][4];
  warp_product<KIND, PASSES, 1>(Wt + 16 * mt * P::LDT, P::DPLANE,
                                Wt + 8 * n8 * P::LDT, P::DPLANE, NI, sum,
                                lane);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 16 * mt + g + 8 * (e >> 1), c = 8 * n8 + 2 * t4 + (e & 1);
    if (c <= r) D2[r * LDI + c] -= sum[0][e];
  }
  __syncthreads();
}

// The rows below the diagonal block (from k0 + NB), in 16-row chunks dealt
// to the cluster's warps: the first 32 columns solved against L11, the next
// 32 less X1 W^T, then solved against L22 (planes from panel_block and
// split_planes)
template <int KIND, int PASSES>
__device__ __noinline__ void panel_rows(float* Lb, int n, int k0, int rank,
                                        int cs, int tid, const float* D1,
                                        const float* D2, unsigned char* U) {
  using P = PanelTc<KIND>;
  using Sx = typename P::Sx;
  const Sx* D1t = reinterpret_cast<const Sx*>(U);
  const Sx* Wt = D1t + P::PARTS * P::DPLANE;
  const Sx* D2t = Wt + P::PARTS * P::DPLANE;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  Sx* Xt = reinterpret_cast<Sx*>(U + PANEL_DT_BYTES) +
           warp * P::PARTS * P::XPLANE;
  float* v = reinterpret_cast<float*>(U + PANEL_DT_BYTES + PANEL_XT_BYTES) +
             warp * VW_FLOATS;
  constexpr int WARPS = NT / 32;
  for (int i0 = k0 + NB + 16 * (rank * WARPS + warp); i0 < n;
       i0 += 16 * cs * WARPS) {
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const float* row = Lb + (long long)(i0 + r) * n + k0;
      const bool in = i0 + r < n;
      v[r * LDV + lane] = in ? __ldcg(row + lane) : 0.0f;
      v[r * LDV + NI + lane] = in ? __ldcg(row + NI + lane) : 0.0f;
    }
    __syncwarp();
    warp_solve<KIND, PASSES>(v, 0, D1, D1t, Xt, lane);
    float sum[NI / 8][4];
    warp_product<KIND, PASSES, NI / 8>(Xt, P::XPLANE, Wt, P::DPLANE, NI, sum,
                                       lane);
#pragma unroll
    for (int c = 0; c < NI / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[(g + 8 * (e >> 1)) * LDV + NI + 8 * c + 2 * t4 + (e & 1)] -=
            sum[c][e];
    __syncwarp();
    warp_solve<KIND, PASSES>(v, NI, D2, D2t, Xt, lane);
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      float* row = Lb + (long long)(i0 + r) * n + k0;
      if (i0 + r < n) {
        __stcg(row + lane, v[r * LDV + lane]);
        __stcg(row + NI + lane, v[r * LDV + NI + lane]);
      }
    }
    __syncwarp();
  }
}

// A block's tiles of a trailing update over nt x nt lower-triangle
// 64-tiles: a contiguous range [lo, hi) of them in column-major order (a
// tile column tj, then its rows ti = tj .. nt - 1), the cluster's ranges
// equal within one tile, and the first one's (ti, tj).  Consecutive tiles
// of a block share their column side, whose slice is then staged once.
__device__ __forceinline__ void tile_range(int nt, int rank, int cs, int& lo,
                                           int& hi, int& ti, int& tj) {
  const int ntiles = nt * (nt + 1) / 2;
  lo = (int)((long long)ntiles * rank / cs);
  hi = (int)((long long)ntiles * (rank + 1) / cs);
  ti = lo;
  tj = 0;
  while (ti >= nt - tj) {   // column tj holds nt - tj tiles
    ti -= nt - tj;
    ++tj;
  }
  ti += tj;
}

// the tile after (ti, tj) in column-major order
__device__ __forceinline__ void next_tile(int nt, int& ti, int& tj) {
  if (++ti == nt) {
    ++tj;
    ti = tj;
  }
}

// The trailing update A22 -= L21 L21^T of the moded kernel, on the tensor
// cores of KIND, one instantiation a mode (KIND, PASSES): the
// lower-triangle 64-tiles of the trailing matrix from row r0; per tile,
// the two 64 x 64 panel slices (rows of L21 from i0 and from j0) split into
// part planes (row r of part q at planes + (side * PARTS + q) * PLANE + r *
// LDS), then each inner panel's product C - sum_pairs acc, pairs smallest
// first.  Each block takes a contiguous column-major range of the tiles
// (tile_range), so consecutive tiles share their column side, loaded and
// split once a column; the next tile's row slice loads while the current
// one's products run.  A warp owns a 32 x 16 block of the tile: per inner
// panel it loads each part's column fragments once, then, for each of its
// two 16-row halves, each part's row fragments once a k step, and runs
// every pair's mma on them (one accumulator a pair, k ascending), so a
// split mode reads each fragment once, not once a pair.
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

template <int KIND, int PASSES>
__device__ __forceinline__ void trailing_tc(float* Lb, int n, int r0, int k0,
                                            int rank, int cs, int tid,
                                            unsigned char* U) {
  using TP = TrailPlanes<KIND>;
  using Sx = typename TP::Sx;
  using TC = onephase::Tc<KIND>;
  constexpr int LDS = TP::LDS, PLANE = TP::PLANE;
  constexpr int PARTS = onephase::mode_parts(PASSES);
  constexpr int KS = NI / TC::K;     // k steps an inner panel
  constexpr int Q0 = 9 - PASSES;     // the pass set's first pair
  Sx* Pp = reinterpret_cast<Sx*>(U);        // row side (from i0)
  Sx* Qp = Pp + TP::PARTS * PLANE;          // column side (from j0)
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp >> 2) * 32, wc = (warp & 3) * 16;   // the warp's block
  const int nt = (n - r0 + NB - 1) / NB;
  int lo, hi, ti, tj;
  tile_range(nt, rank, cs, lo, hi, ti, tj);
  float ra[16];
  if (lo < hi) load_slice(ra, Lb, n, r0 + ti * NB, k0, tid);
  int qcol = -1;   // the tile column whose planes Qp hold
  for (int idx = lo; idx < hi; ++idx) {
    const int i0 = r0 + ti * NB, j0 = r0 + tj * NB;
    const bool new_col = tj != qcol;
    qcol = tj;
    __syncthreads();   // the previous tile's planes are read
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int o = ((tid >> 6) + 4 * q) * LDS + (tid & 63);
      Sx pa[PARTS];
      onephase::tc_split<KIND, PARTS>(ra[q], pa);
#pragma unroll
      for (int r = 0; r < PARTS; ++r) Pp[r * PLANE + o] = pa[r];
    }
    if (new_col) {
      float rb[16];
      load_slice(rb, Lb, n, j0, k0, tid);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int o = ((tid >> 6) + 4 * q) * LDS + (tid & 63);
        Sx pb[PARTS];
        onephase::tc_split<KIND, PARTS>(rb[q], pb);
#pragma unroll
        for (int r = 0; r < PARTS; ++r) Qp[r * PLANE + o] = pb[r];
      }
    }
    __syncthreads();
    if (idx + 1 < hi) {
      next_tile(nt, ti, tj);
      load_slice(ra, Lb, n, r0 + ti * NB, k0, tid);
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
      uint32_t bf[PARTS][KS][2][2];   // each part's column fragments
#pragma unroll
      for (int p = 0; p < PARTS; ++p)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            frag_b<KIND, LDS>(Qp + p * PLANE + (wc + 8 * c) * LDS + NI * h +
                                  ks * TC::K,
                              g, t4, bf[p][ks][c]);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float acc[PASSES][2][4];
#pragma unroll
        for (int q = 0; q < PASSES; ++q)
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[q][c][r] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t af[PARTS][4];   // each part's row fragment
#pragma unroll
          for (int p = 0; p < PARTS; ++p)
            frag_a<KIND, LDS>(Pp + p * PLANE + (wr + 16 * a) * LDS + NI * h +
                                  ks * TC::K,
                              g, t4, af[p]);
#pragma unroll
          for (int q = 0; q < PASSES; ++q)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              TC::mma(acc[q][c], af[onephase::pair_i(Q0 + q)],
                      bf[onephase::pair_j(Q0 + q)][ks][c]);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float sum = acc[0][c][r];
#pragma unroll
            for (int q = 1; q < PASSES; ++q) sum += acc[q][c][r];
            cv[a][c][r] -= sum;
          }
      }
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

// The float64 trailing update A22 -= L21 L21^T on the FP64 tensor cores:
// the lower-triangle 64-tiles of the trailing matrix from row r0, a
// contiguous column-major range of them a block (tile_range); per tile, the
// two 64 x 64 panel slices (rows of L21 from i0 and from j0) staged in Ps
// and Qs (Qs only with a new tile column), then each warp's 32 x 16 block
// of the tile (2 x 2 m16n8 accumulators) takes each inner panel's product,
// an accumulator from +0 over its 32 columns in four k8 steps, as
// (C - acc1) - acc2.  The slices load at the tile's start (loading the
// next tile's while the current one's products run spilled registers).
// Value for value the FP64-core loop it replaced (a 4 x 4 register block a
// thread, acc += a b over p ascending from 0, contracted to fma): an f64
// mma's D is that fma chain, k ascending, from its C (mm_tc.cuh, Dmma).
__device__ __forceinline__ void trailing_dmma(double* Lb, int n, int r0,
                                              int k0, int rank, int cs,
                                              int tid, double* Ps,
                                              double* Qs) {
  using onephase::Dmma;
  constexpr int LD = ldp<double>();
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp >> 2) * 32, wc = (warp & 3) * 16;   // the warp's block
  const int nt = (n - r0 + NB - 1) / NB;
  int lo, hi, ti, tj;
  tile_range(nt, rank, cs, lo, hi, ti, tj);
  int qcol = -1;   // the tile column whose slice Qs holds
  for (int idx = lo; idx < hi; ++idx, next_tile(nt, ti, tj)) {
    const int i0 = r0 + ti * NB, j0 = r0 + tj * NB;
    const bool new_col = tj != qcol;
    qcol = tj;
    {
      double ra[16];
      load_slice(ra, Lb, n, i0, k0, tid);
      __syncthreads();   // the previous tile's slices are read
      store_slice(Ps, ra, tid);
    }
    if (new_col) {
      double rb[16];
      load_slice(rb, Lb, n, j0, k0, tid);
      store_slice(Qs, rb, tid);
    }
    __syncthreads();
    // the C fragments: tile row wr + 16 a + g + 8 (r / 2), column
    // wc + 8 c + 2 t4 + r % 2
    double cv[2][2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + wr + 16 * a + g + 8 * (r >> 1);
          const int j = j0 + wc + 8 * c + 2 * t4 + (r & 1);
          cv[a][c][r] = (i < n && j <= i)
                            ? __ldcg(Lb + (long long)i * n + j) : 0.0;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double acc[2][2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[a][c][r] = 0.0;
#pragma unroll
      for (int ks = 0; ks < NI / Dmma::K; ++ks) {
        const int kk = NI * h + ks * Dmma::K + t4;
        double af[2][4], bf[2][2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const double* p = Ps + (wr + 16 * a + g) * LD + kk;
          af[a][0] = p[0];
          af[a][1] = p[8 * LD];
          af[a][2] = p[4];
          af[a][3] = p[8 * LD + 4];
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const double* p = Qs + (wc + 8 * c + g) * LD + kk;
          bf[c][0] = p[0];
          bf[c][1] = p[4];
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 2; ++c) Dmma::mma(acc[a][c], af[a], bf[c]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[a][c][r] -= acc[a][c][r];
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

// the moded kernel's shared memory beyond the three inner tiles, the
// largest of: the trailing update's planes; the one-pass panel's rows (one
// a thread, NI x NT) and the parts of L11, L21 of the 64 x 64 block and L22
// (3 parts each); the split modes' panel (PANEL_TC_BYTES)
constexpr int PANEL_FLOATS = NI * NT + 3 * 3 * TILE;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int MODED_UNION_FLOATS =
    cmax(cmax(PANEL_FLOATS, PANEL_TC_BYTES / 4),
         cmax(TrailPlanes<1>::BYTES, TrailPlanes<2>::BYTES) / 4);

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
            bool* __restrict__ ok_out, int n, int mode) {
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
  unsigned char* U = reinterpret_cast<unsigned char*>(Ps);
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
      if (kb > NI && md.passes == 1) {
        // L11's parts; L21 (a thread a row); its parts; A22 - L21 L21^T
        ONE_PASS_DISPATCH(mode, split_tile, D1, D1p, tid);
        __syncthreads();
        CLK_MARK(PH_SOLVE);
        if (tid < NI) {
          for (int p = 0; p < NI; ++p) V[p * NT + tid] = W[tid * LDI + p];
          ONE_PASS_DISPATCH(mode, solve_row, V + tid, D1p, D1);
          for (int p = 0; p < NI; ++p) W[tid * LDI + p] = V[p * NT + tid];
        }
        __syncthreads();
        CLK_MARK(PH_CROSS);
        ONE_PASS_DISPATCH(mode, split_tile, W, Wp, tid);
        __syncthreads();
        ONE_PASS_DISPATCH(mode, cross_w, Wp, D2, tid);
        CLK_MARK(PH_DIAG);
        chol_tile<T, NI, NT, false, MODED>(D2, nullptr, vec, own, tid, ok,
                                           md);
        ONE_PASS_DISPATCH(mode, split_tile, D2, D2p, tid);
        __syncthreads();
      } else if (kb > NI) {
        // the split modes: L11's and W's planes, W, A22 - W W^T on the
        // tensor cores (panel_block); then L22 and its planes
        CLK_MARK(PH_SOLVE);
        SPLIT_DISPATCH(mode, panel_block, D1, W, D2, U, tid);
        CLK_MARK(PH_DIAG);
        chol_tile<T, NI, NT, false, MODED>(D2, nullptr, vec, own, tid, ok,
                                           md);
        SPLIT_DISPATCH(mode, split_planes, D2, U, 2, tid);
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
      if (md.passes == 1) {
        float* v = V + tid;
        for (int i = k0 + NB + rank + cs * tid; i < n; i += cs * NT) {
          T* row = Lb + (long long)i * n + k0;
          for (int p = 0; p < NI; ++p) v[p * NT] = __ldcg(row + p);
          CLK_MARK(PH_SOLVE);
          ONE_PASS_DISPATCH(mode, solve_row, v, D1p, D1);
          CLK_MARK(PH_CROSS);
          float acc[NI];
          ONE_PASS_DISPATCH(mode, cross_row, v, Wp, acc);
          CLK_MARK(PH_OTHER);
          for (int p = 0; p < NI; ++p) __stcg(row + p, v[p * NT]);
#pragma unroll
          for (int c = 0; c < NI; ++c)
            v[c * NT] = __ldcg(row + NI + c) - acc[c];
          CLK_MARK(PH_SOLVE);
          ONE_PASS_DISPATCH(mode, solve_row, v, D2p, D2);
          CLK_MARK(PH_OTHER);
          for (int p = 0; p < NI; ++p) __stcg(row + NI + p, v[p * NT]);
        }
      } else {
        // the split modes: 16 rows a warp on the tensor cores (their solves
        // and cross products both clocked as the solve)
        CLK_MARK(PH_SOLVE);
        SPLIT_DISPATCH(mode, panel_rows, Lb, n, k0, rank, cs, tid, D1, D2, U);
      }
    } else if constexpr (sizeof(T) == 8) {
      // float64: x in registers, y in shared memory (this thread's at
      // Ys + tid, NT apart; the panel slices' space): the two 32-entry rows
      // in registers at once spilled.  The same operations in the same
      // order as the float32 loop below.
      T* Ys = Ps + tid;
      for (int i = k0 + NB + rank * NT + tid; i < n; i += cs * NT) {
        T* row = Lb + (long long)i * n + k0;
        T x[NI];
#pragma unroll
        for (int p = 0; p < NI; ++p) x[p] = __ldcg(row + p);
        CLK_MARK(PH_SOLVE);
        row_solve<T>(x, D1);
#pragma unroll
        for (int p = 0; p < NI; ++p) __stcg(row + p, x[p]);
        CLK_MARK(PH_CROSS);
#pragma unroll 4
        for (int c = 0; c < NI; ++c) {
          T acc = T(0);
#pragma unroll
          for (int p = 0; p < NI; ++p) acc += x[p] * W[c * LDI + p];
          Ys[c * NT] = __ldcg(row + NI + c) - acc;
        }
        CLK_MARK(PH_SOLVE);
#pragma unroll 1
        for (int j = 0; j < NI; ++j) {
          T s = Ys[j * NT];
#pragma unroll 4
          for (int p = 0; p < j; ++p) s -= Ys[p * NT] * D2[j * LDI + p];
          Ys[j * NT] = s / D2[j * LDI + j];
        }
        CLK_MARK(PH_OTHER);
#pragma unroll 4
        for (int p = 0; p < NI; ++p) __stcg(row + NI + p, Ys[p * NT]);
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
        switch (mode) {
          case 0x11: trailing_tc<1, 1>(Lb, n, r0, k0, rank, cs, tid, U); break;
          case 0x13: trailing_tc<1, 3>(Lb, n, r0, k0, rank, cs, tid, U); break;
          case 0x21: trailing_tc<2, 1>(Lb, n, r0, k0, rank, cs, tid, U); break;
          case 0x23: trailing_tc<2, 3>(Lb, n, r0, k0, rank, cs, tid, U); break;
          case 0x26: trailing_tc<2, 6>(Lb, n, r0, k0, rank, cs, tid, U); break;
          case 0x29: trailing_tc<2, 9>(Lb, n, r0, k0, rank, cs, tid, U); break;
          default: trailing_tc<3, 1>(Lb, n, r0, k0, rank, cs, tid, U); break;
        }
        CLK_MARK(PH_OTHER);
        cluster.sync();   // the trailing matrix is up to date
      }
    } else if (r0 < n) {
      CLK_MARK(PH_TRAIL);
      // 5. trailing update A22 -= L21 L21^T over the lower-triangle tiles,
      //    split over the cluster, as the two inner panels' updates in turn
      //    (C - acc1) - acc2; the next tile's slices load while the current
      //    one's products run
      if constexpr (sizeof(T) == 8) {
        trailing_dmma(Lb, n, r0, k0, rank, cs, tid, Ps, Qs);
      } else {
        // the FP32 cores, a 4 x 4 register block a thread; the tile's own
        // entries load during its second half
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
      }
      CLK_MARK(PH_OTHER);
      cluster.sync();   // the trailing matrix is up to date
    }
  }
  if (rank == 0 && tid == 0) ok_out[b] = ok != 0;
  CLK_WRITE(cs);
}

// The cluster size for a batch of B on a device of `sms` SMs: the largest
// power of two <= MAX_CLUSTER with B * CS <= sms, halved while fewer than B
// clusters of that size fit on the card at once.
template <typename T, bool MODED>
int cluster_size(int B, int sms, cudaLaunchConfig_t& cfg,
                 cudaLaunchAttribute& attr) {
  int cs = MAX_CLUSTER;
  while (cs > 1 && (long long)B * cs > sms) cs >>= 1;
  for (; cs > 1; cs >>= 1) {
    attr.val.clusterDim.x = cs;
    cfg.gridDim = dim3(B * cs);
    int fit = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&fit, chol_kernel<T, MODED>, &cfg);
    if (err != cudaSuccess) return -(int)err;
    if (fit >= B) break;
  }
  return cs;
}

// One launch: the shared memory attribute set and the SM count read once
// a device (launch.cuh), the cluster size once a (device, B)
template <typename T, bool MODED>
int launch_chol(const void* Q, void* L, void* d, void* ok, int B, int n,
                int mode, void* stream) {
  constexpr int smem = (int)smem_bytes<T, MODED>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = onephase::smem_once(chol_kernel<T, MODED>, smem,
                                        smem_set);
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
  int dev = 0, sms = 0;
  err = onephase::device_sms(dev, sms);
  if (err != cudaSuccess) return (int)err;
  if (dev != last_dev || B != last_B) {
    const int cs = cluster_size<T, MODED>(B, sms, cfg, attr);
    if (cs < 0) return -cs;
    last_dev = dev;
    last_B = B;
    last_cs = cs;
  }
  attr.val.clusterDim.x = last_cs;
  cfg.gridDim = dim3(B * last_cs);
  err = cudaLaunchKernelEx(&cfg, chol_kernel<T, MODED>, (const T*)Q, (T*)L,
                           (T*)d, (bool*)ok, n, mode);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef ONEPHASE_CHOL_CLOCKS
// op_chol_f32 / op_chol_f64 with the phase clocks written to `clk` (int64,
// at least (B * MAX_CLUSTER, CLK_SLOTS), zeroed by the caller)
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

extern "C" int op_chol_clocks_f64(const void* Q, void* L, void* d, void* ok,
                                  int B, int n, int mode, void* clk,
                                  void* stream) {
  if (mode != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemcpyToSymbolAsync(
      g_chol_clk, &clk, sizeof(clk), 0, cudaMemcpyHostToDevice,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return launch_chol<double, false>(Q, L, d, ok, B, n, 0, stream);
}
#else
// Q (B, n, n) -> L (B, n, n), d (B, n), ok (B,) one byte an instance
// (torch.bool); `mode`: a matmul mode's code (mm_mode.cuh), 0 = IEEE;
// float64 takes 0 only
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
