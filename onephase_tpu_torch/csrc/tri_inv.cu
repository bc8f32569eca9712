// Batched triangular inverse: L (B, n, n) lower -> Li = L^-1 (B, n, n),
// lower with the strict upper triangle zeroed.  The wrapper
// (ops/cholesky.py:pallas_tri_inv_gram) follows it with the Gram product
// M = Li^T Li, run by the lower-tile-pair kernel of fused_q.cu in its
// lower-triangular mode (w = 1, no H, no diagonal): together they replace
// the TPU kernel onephase_tpu/ops/cholesky.py:pallas_tri_inv_gram
// (_tri_inv_gram_kernel :131-156: blocked forward substitution on the
// identity, then one Gram matmul).
//
// What bounds it on the H100: FP32/FP64 FMA rate.  The inverse costs
// n^3 / 6 multiply-adds per instance (far above the memory roofline at
// n >= 256); what stands in the way is the substitution inside each 32-row
// diagonal block, a chain of 32 dependent steps, and the shared-memory
// traffic of the update product that feeds it.
//
// What the design does about it:
// - The columns of L^-1 are independent forward substitutions on e_j, so
//   the grid is (instance, 64-column tile) and blocks never wait for each
//   other; the tiles at c0 = 0, which do the most work, come first in the
//   launch order.
// - A block walks its columns' rows 64 at a time (two 32-row chunks A and
//   B).  The update from the rows already solved, sum over k of
//   L[r, k] Li[k, c], is a 64 x 64 tile product over 32-deep k slabs
//   staged in shared memory (the next slab loaded into registers while the
//   current one is multiplied); each of the 256 threads keeps a 4 x 4
//   block of it in registers and reads its 4 rows and 4 columns with one
//   16-byte load each (L's slab is stored with its rows permuted and
//   XOR-swizzled, so both its stores and these loads are conflict-free).
//   The solved rows of Li are read back through L2 (ld.global.cg).
// - The diagonal solve is right-looking, one thread per column (two
//   warps for the 64 columns), the chunk's 32 rows in registers: at step p
//   the thread divides row p by L[p, p] and subtracts L[i, p] x_p from the
//   rows below, independent FMAs, so the dependent chain is one division
//   and one FMA a step, with no barrier, shuffle or shared store inside.
// - Chunk B's sums take their last 32 terms from chunk A's solution, in
//   the registers that held them, before B is solved.
//
// Value for value: every entry is the same floating-point operations in
// the same order as in the earlier 32-column, one-warp-solve kernel, so M
// is bit for bit what it was.  The sum for entry (r, c) is one accumulator
// over k ascending up to the start of r's 32-row chunk (chunk starts stay
// at multiples of 32), then rhs = delta - acc and the in-chunk
// substitution s -= L[r, p] x_p, p ascending, with a true division by
// L[r, r].  The 64-column tile starts the sums up to 32 columns earlier;
// those terms multiply exact zeros of Li (k < c) and leave acc at +0.
// The ragged edge is masked, nothing is padded.
//
// A `matmul_precision` mode (float32 only) runs in tri_inv_mode.cuh, one
// instantiation a mode, with the update on the tensor cores; the
// wrapper's Gram product then runs K1's moded instantiation.
#include <cuda_runtime.h>

#include "tri_inv.cuh"
#include "tri_inv_mode.cuh"

namespace {

using onephase::ld_cg;

constexpr int TC = onephase::TI_TC;         // columns per block
constexpr int RC = onephase::TI_RC;         // rows per chunk = slab depth
constexpr int LDX = TC + 4;    // padded row of Xs, a multiple of 4
constexpr int THREADS = onephase::TI_THREADS;   // 16 x 16, a 4 x 4 block each

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// Place of L-slab entry (k row p, tile row r) in its row of Ls: the rows
// ty + 16 a a thread owns sit side by side (4 ty + a), XOR-swizzled by p.
__device__ __forceinline__ int lslot(int p, int r) {
  return (4 * (r & 15) + (r >> 4)) ^ (4 * (p & 7));
}

// The L slab Ls[p][lslot(p, r)] = L[R0 + r, k0 + p] (r < 64, p < 32),
// through registers: lane (a = l / 8, p % 8 = l % 8) of warp w takes tile
// row (w + 8 i) % 16 + 16 a and k row 8 ((w + 8 i) / 16) + l % 8.
template <typename T>
__device__ __forceinline__ void load_l(const T* __restrict__ Lb, int n,
                                       int R0, int k0, T (&v)[8]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = w + 8 * i;
    const int r = (q & 15) + 16 * (lane >> 3), p = 8 * (q >> 4) + (lane & 7);
    v[i] = (R0 + r < n && k0 + p < n)
               ? __ldg(Lb + (long long)(R0 + r) * n + k0 + p) : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store_l(T (*Ls)[TC], const T (&v)[8]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = w + 8 * i;
    const int r = (q & 15) + 16 * (lane >> 3), p = 8 * (q >> 4) + (lane & 7);
    Ls[p][lslot(p, r)] = v[i];
  }
}

// The Li slab Xs[p][c] = Li[k0 + p, c0 + c] (p < 32, c < tc; zero beyond).
template <typename T>
__device__ __forceinline__ void load_x(const T* X, int n, int k0, int c0,
                                       int tc, T (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = threadIdx.x + THREADS * i, p = e >> 6, c = e & 63;
    v[i] = c < tc ? ld_cg(X + (long long)(k0 + p) * n + c0 + c) : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store_x(T (*Xs)[LDX], const T (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = threadIdx.x + THREADS * i;
    Xs[e >> 6][e & 63] = v[i];
  }
}

// acc[a][j] += sum over p of L-slab(ty + 16 a, p) * Xs[p][4 tx + j], p
// ascending, for a >= A0 (A0 = 2: chunk B's rows only).
template <int A0, typename T>
__device__ __forceinline__ void update(T (*Ls)[TC], T (*Xs)[LDX],
                                       int tx, int ty, T (&acc)[4][4]) {
#pragma unroll
  for (int p = 0; p < RC; ++p) {
    T lv[4], xv[4];
    ld4(&Ls[p][4 * (ty ^ (p & 7))], lv);
    ld4(&Xs[p][4 * tx], xv);
#pragma unroll
    for (int a = A0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] += lv[a] * xv[j];
  }
}

// Right-hand side of a chunk (rows ty + 16 a, a = A0, A0 + 1 of the tile):
// Xs[i][c] = (identity column c0 + c at row Rc + i) - acc.
template <int A0, typename T>
__device__ __forceinline__ void put_rhs(T (*Xs)[LDX], const T (&acc)[4][4],
                                        int Rc, int c0, int tx, int ty) {
#pragma unroll
  for (int a = A0; a < A0 + 2; ++a) {
    const int i = ty + 16 * (a - A0);
    T v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = ((Rc + i == c0 + 4 * tx + j) ? T(1) : T(0)) - acc[a][j];
    st4(&Xs[i][4 * tx], v);
  }
}

// Forward substitution of a chunk's rb rows (tile rows 32 h + i) with its
// diagonal block, held in Ls (L[Rc + i, Rc + p] at tile row 32 h + i),
// right-looking: thread c < 64 (warps 0 and 1) holds column c at the
// chunk's 32 rows in registers; at step p it divides row p by L[p, p] and
// subtracts L[i, p] x_p from the rows i below, which do not depend on each
// other, so the dependent chain is one division and one FMA a step.  Every
// thread of the two warps reads the same L entry (a broadcast).  The
// solution goes back to Xs and to Li (row Rc + i at Xrow + i n).  The other
// warps wait at the caller's barrier.
template <typename T>
__device__ __forceinline__ void solve_chunk(T (*Ls)[TC], T (*Xs)[LDX],
                                            int h, int rb, T* Xrow, int n,
                                            int tc, TiClock& clk) {
  const int c = threadIdx.x;
  if (c >= TC) return;
  // tile row 32 h + i of k row p: lslot(p, i) + 2 h (i < 32)
  const T* Lh = &Ls[0][0] + 2 * h;
  T s[RC];
#pragma unroll
  for (int i = 0; i < RC; ++i) s[i] = Xs[i][c];
#pragma unroll
  for (int p = 0; p < RC; ++p) {
    if (p >= rb) break;
    s[p] = s[p] / Lh[p * TC + lslot(p, p)];
#pragma unroll
    for (int i = p + 1; i < RC; ++i)
      s[i] -= Lh[p * TC + lslot(p, i)] * s[p];
  }
  clk.mark(onephase::TI_STORE);
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    Xs[i][c] = s[i];
    if (i < rb && c < tc) Xrow[(long long)i * n + c] = s[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tri_inv_kernel(const T* __restrict__ L, T* __restrict__ Li, int n) {
  __shared__ __align__(16) T Ls[RC][TC];    // L slab, rows permuted
  __shared__ __align__(16) T Xs[RC][LDX];   // Li slab; a chunk's rhs/solution

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * TC;
  const int tc = min(TC, n - c0);
  const long long nn = (long long)n * n;
  const T* Lb = L + (long long)b * nn;
  T* X = Li + (long long)b * nn;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int tx = (lane & 7) + 8 * (w & 1), ty = (lane >> 3) + 4 * (w >> 1);
  TiClock clk;
  clk.start();
  clk.mark(onephase::TI_STORE);

  // rows above the diagonal block are zero
  for (long long e = tid; e < (long long)c0 * TC; e += THREADS) {
    const long long r = e / TC;
    const int c = (int)(e % TC);
    if (c < tc) X[r * n + c0 + c] = T(0);
  }

  T lreg[8], xreg[8];
  clk.mark(onephase::TI_LOAD);
  for (int R0 = c0; R0 < n; R0 += 2 * RC) {
    T acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = T(0);
    // update from the solved rows: sum over k in [c0, R0), k ascending
    if (c0 < R0) {
      load_l(Lb, n, R0, c0, lreg);
      load_x(X, n, c0, c0, tc, xreg);
    }
    for (int k0 = c0; k0 < R0; k0 += RC) {
      store_l(Ls, lreg);
      store_x(Xs, xreg);
      __syncthreads();
      if (k0 + RC < R0) {
        load_l(Lb, n, R0, k0 + RC, lreg);
        load_x(X, n, k0 + RC, c0, tc, xreg);
      }
      clk.mark(onephase::TI_UPDATE);
      update<0>(Ls, Xs, tx, ty, acc);
      clk.mark(onephase::TI_LOAD);
      __syncthreads();
    }
    // chunk A: rows R0 .. R0 + 31; Ls = L[R0 + r, R0 + p] holds its
    // diagonal block (r < 32) and chunk B's last 32 terms (r >= 32)
    load_l(Lb, n, R0, R0, lreg);
    store_l(Ls, lreg);
    clk.mark(onephase::TI_SOLVE);
    put_rhs<0>(Xs, acc, R0, c0, tx, ty);
    clk.mark(onephase::TI_LOAD);
    __syncthreads();
    clk.mark(onephase::TI_SOLVE);
    solve_chunk(Ls, Xs, 0, min(RC, n - R0),
                       X + (long long)R0 * n + c0, n, tc, clk);
    clk.mark(onephase::TI_LOAD);
    __syncthreads();
    if (R0 + RC >= n) break;
    // chunk B: rows R0 + 32 .. R0 + 63
    clk.mark(onephase::TI_UPDATE);
    update<2>(Ls, Xs, tx, ty, acc);
    clk.mark(onephase::TI_LOAD);
    __syncthreads();
    load_l(Lb, n, R0, R0 + RC, lreg);
    store_l(Ls, lreg);
    clk.mark(onephase::TI_SOLVE);
    put_rhs<2>(Xs, acc, R0 + RC, c0, tx, ty);
    clk.mark(onephase::TI_LOAD);
    __syncthreads();
    clk.mark(onephase::TI_SOLVE);
    solve_chunk(Ls, Xs, 1, min(RC, n - R0 - RC),
                       X + (long long)(R0 + RC) * n + c0, n, tc, clk);
    clk.mark(onephase::TI_LOAD);
    __syncthreads();
  }
  clk.write();
}

template <typename T>
int launch_tri_inv(const void* L, void* Li, int B, int n, void* stream) {
  const int nct = (n + TC - 1) / TC;
  if (nct > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(B, nct);
  tri_inv_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)L, (T*)Li, n);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef ONEPHASE_TRI_INV_CLOCKS
// op_tri_inv_f32 with the phase clocks written to `clk` (int64, (B
// ceil(n / 64), TI_CLK_SLOTS), zeroed by the caller)
extern "C" int op_tri_inv_clocks_f32(const void* L, void* Li, int B, int n,
                                     int mode, void* clk, void* stream) {
  const int err = set_tri_inv_clocks(clk, stream);
  if (err != 0) return err;
  if (mode != 0) return tri_inv_mode_launch(L, Li, B, n, mode, stream);
  return launch_tri_inv<float>(L, Li, B, n, stream);
}
#else
// `mode`: a matmul mode's code (mm_mode.cuh; tri_inv_mode.cuh), 0 = IEEE;
// float64 takes 0 only
extern "C" int op_tri_inv_f32(const void* L, void* Li, int B, int n,
                              int mode, void* stream) {
  if (mode == 0) return launch_tri_inv<float>(L, Li, B, n, stream);
  return tri_inv_mode_launch(L, Li, B, n, mode, stream);
}

extern "C" int op_tri_inv_f64(const void* L, void* Li, int B, int n,
                              int mode, void* stream) {
  if (mode != 0) return (int)cudaErrorInvalidValue;
  return launch_tri_inv<double>(L, Li, B, n, stream);
}
#endif
