// Block-tridiagonal factor (K7) and solve (K5) of the chain path: one
// thread block per instance walks the K stages of the recursion.
//
// Replaces the TPU kernels of onephase_tpu/ops/tridiag_pallas.py:
// - tridiag_factor_kernel: pallas_tridiag_factor (_factor_kernel :54-78,
//   wrapper :94-131).  Per stage k
//       C_k  = chol(A_k + delta I - E_{k-1} E_{k-1}^T)
//       Ci_k = C_k^{-1}
//       E_k  = B_k Ci_k^T          (k < K-1)
//   with ok = every pivot positive and finite, returned as a flag (the
//   Pallas kernel signals it through a signed diagonal).  Pivot protocol
//   as in _unblocked_chol (onephase_tpu/ops/cholesky.py:48-75): ok &=
//   pivot > 0 && finite, then the column is scaled by
//   1/sqrt(max(pivot, tiny)) and the factorization continues.
// - tridiag_solve_kernel: pallas_tridiag_solve (_fwd_kernel :157-172,
//   _bwd_kernel :175-190, wrapper :194-240).  Forward
//       y_k = Ci_k (b_k - E_{k-1} y_{k-1}),
//   then backward
//       x_k = Ci_k^T (y_k - E_k^T x_{k+1}),
//   both sweeps in one launch (y is kept in the output x).
//
// What bounds them on the H100: neither bytes nor operations.  At the
// chain shape (K = 400, nb = 32, one instance, f32) the factor moves 8.2 MB
// and does 36 MFLOP (2.4 us at 3.35 TB/s, 0.5 us at 67 TFLOP/s); the solve
// reads 3.3 MB (1 us) and does 3.3 MFLOP.  What bounds them is
// the serial chain of K dependent stages: each stage waits on the one
// before (E_{k-1} or the carried vector), and inside a stage the nb-step
// Cholesky and the triangular inversion are serial in their columns.  The
// Pallas kernels carry the recursion in VMEM across a sequential grid; on
// Hopper blocks run in no order, so the K loop moves inside one block per
// instance (grid = B) and the carry stays in shared memory.
//
// What the factor's design does about it: the stage's latency is what
// counts, so every step of a stage keeps all threads busy and no loop
// divides by a runtime size.  The blocks are padded in shared memory to a
// compile-time NB (32 for nb <= 32, on 256 threads; else 64, on 512; the
// padding of A_k is the identity, of B_k zero, so the padded entries of
// C_k and Ci_k are the identity's and those of E_k zero), with an odd
// leading dimension (NB | 1) so column walks are conflict-free.  Each
// thread owns a fixed 2-D set of block entries, (ty + TY a, tx + 16 c),
// for the two products of a stage, E E^T and E_k = B_k Ci_k^T, computed
// from shared memory into registers.  C_k and Ci_k come from
// chol_tile.cuh (one barrier per column, factor and inverse together).
// The next stage's A_k and B_k are copied into shared memory with
// cp.async, in the same entry map, while the current stage factors.  The
// arithmetic is the earlier one-column-per-thread kernel's, value for
// value (the same products in the same order), so the chain and banded
// runs keep their iterates.
//
// What the solve's design does about it: a stage's latency is two
// dependent chains of nb FMAs (E v, then Ci r), so only they should stay on
// its critical path.
// - Consumers: the block edge is a compile-time NB (32 for nb <= 32, else
//   64); lane t of NB / 32 consumer warps owns row t.  The inner products
//   are unrolled, masked past nb (predicated FMAs; unmasked where nb ==
//   NB), and each chain's terms are read into registers before its first
//   FMA; the E row of the next stage is read while the current stage's
//   second chain runs.  The warps meet by __syncwarp (NB = 32) or a named
//   barrier of 64 threads (NB = 64): no block-wide barrier a stage.
// - Producers: three warps for each consumer warp copy each stage's
//   operands, Ci_k, E (E_{k-1} forward, E_k backward) and the vector (b_k
//   forward, y_k backward), into a ring of S stage slots in shared memory,
//   up to S - 1 stages ahead (S = 8 at NB = 32; at NB = 64, 5 in f32 and
//   3 in f64: the ring within about 200 KB), with 16-byte cp.async copies.
//   Where nb sizeof(T) is a multiple of 16 each row goes to a slot row
//   padded by 16 bytes, so the forward sweep's 16-byte row reads and the
//   backward sweep's column reads are both free of bank conflicts; else the
//   block is copied as it lies, from its 16-byte phase on (an odd nb, as
//   the banded path's 63, makes both walks conflict-free as well).
// - Handoffs: a slot is full when an mbarrier has counted every producer
//   thread's cp.async.mbarrier.arrive (so no global load lies on a stage's
//   critical path); the consumers release slots through a counter in shared
//   memory (release/acquire), published before their store to x so that
//   its fence waits on no fresh global store.  The whole block meets once,
//   at the turn of the sweeps, after which the producers copy y_k back
//   from x.
// Value for value: each lane sums its terms in the order c = 0 .. nb-1,
// one fma a term (the earlier one-row-per-thread kernel's `s += a * b`, as
// nvcc contracted it), r = b - s and y - s as before; x is what that kernel
// returned, bit for bit (tools/kernel_equal.py).  nb <= 64.
//
// Matmul modes (`matmul_precision`, mm_mode.cuh; float32 only): each kernel
// has one instantiation a card mode beside its IEEE ones, which are
// unchanged, in sources of their own (tridiag_factor_mode.cu,
// tridiag_solve_mode.cu, each its own compiler); the entry points take the
// mode's code (0 = IEEE) and refuse a code without an instantiation (never
// run as IEEE).  The JAX kernels' dots take no `precision`, so the knob
// reaches every product of two matrix entries:
// - K7: E_{k-1} E_{k-1}^T and B_k Ci_k^T on the tensor cores (mm_tc.cuh:
//   each operand split once a stage into part planes, one mma accumulator
//   a part pair from +0, the pairs summed smallest first), and the tile's
//   Cholesky and inverse (chol_tile.cuh: each column and row split once a
//   phase, each product's part products summed from +0 and subtracted);
// - K5: both chains, one accumulator a part pair (so each chain is nb FMAs
//   deep, as in IEEE), each E and Ci term split where it is used, v and r
//   split once by the lane that writes each entry (tridiag.cuh).
// Sums, divisions and square roots stay float32.
#include <cuda_runtime.h>

#include "tridiag.cuh"

namespace {

using onephase::chol_tile;
using onephase::tile_entries;
using onephase::tile_owner;

// --- the factor (K7)

// acc[a][c] = sum_p A[ty + TY a][p] Bt[tx + 16 c][p] over NB x NB tiles in
// shared memory (leading dimension NB | 1), p in increasing order.
template <typename T, int NB, int NT>
__device__ __forceinline__ void band_product(
    const T* A, const T* Bt, T (&acc)[NB * 16 / NT][NB / 16], int ty,
    int tx) {
  constexpr int LD = tile_ld<NB>(), TY = NT / 16;
  constexpr int RA = NB * 16 / NT, RC = NB / 16;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[a][c] = T(0);
#pragma unroll 8
  for (int p = 0; p < NB; ++p) {
    T av[RA], bv[RC];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = A[(ty + TY * a) * LD + p];
#pragma unroll
    for (int c = 0; c < RC; ++c) bv[c] = Bt[(tx + 16 * c) * LD + p];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[a][c] += av[a] * bv[c];
  }
}

template <typename T, int NB>
constexpr size_t factor_smem() {
  return sizeof(T) * (6 * NB * tile_ld<NB>() + 6 * NB + 2);
}

template <typename T, int NB, int NT>
__global__ void __launch_bounds__(NT)
tridiag_factor_kernel(const T* __restrict__ Ad, const T* __restrict__ Bs,
                      const T* __restrict__ delta, T* __restrict__ Ck,
                      T* __restrict__ Ci, T* __restrict__ Ek,
                      int* __restrict__ ok_out, int K, int nb) {
  constexpr int LD = tile_ld<NB>(), TY = NT / 16;
  constexpr int RA = NB * 16 / NT, RC = NB / 16;
  static_assert(RA >= 1 && NB % 16 == 0, "NB x NB tiles on NT threads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);   // A_k + dI - E E^T, then C_k
  T* X = S + NB * LD;                      // C_k^{-1}
  T* E = X + NB * LD;                      // E_{k-1}, then E_k
  T* Am = E + NB * LD;                     // A_k
  T* Bm = Am + NB * LD;                    // B_k in Bm[k & 1]
  T* vec = Bm + 2 * NB * LD;               // chol_tile's scratch

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nn = nb * nb;
  const long long blk = nn;
  const T* A_b = Ad + (long long)b * K * blk;
  const T* B_b = Bs + (long long)b * (K - 1) * blk;
  T* Ck_b = Ck + (long long)b * K * blk;
  T* Ci_b = Ci + (long long)b * K * blk;
  T* Ek_b = Ek + (long long)b * (K - 1) * blk;
  const T dlt = delta[b];

  // E_{-1} = 0, X's strict upper triangle zero, and B's padding zero
  for (int e = tid; e < NB * LD; e += NT) {
    E[e] = T(0);
    X[e] = T(0);
    Bm[e] = T(0);
    Bm[NB * LD + e] = T(0);
  }
  int own[tile_entries<NB, NT>()];
  tile_owner<NB, NT>(own, tid);
  int ok = 1;
  T acc[RA][RC];
  TdClock clk;
  clk.start();
  __syncthreads();
  fetch_block<T, NB, NT>(Am, A_b, nb, ty, tx);
  if (K > 1) fetch_block<T, NB, NT>(Bm, B_b, nb, ty, tx);

  for (int k = 0; k < K; ++k) {
    T* Bk = Bm + (k & 1) * NB * LD;
    clk.mark(TD_WAIT);
    cp_async_wait_all();
    clk.mark(TD_A);
    // 1. S = (A_k + delta I) - E_{k-1} E_{k-1}^T on the lower triangle
    //    (upper zeroed, the identity past nb); a thread reads only the
    //    entries of A_k it copied itself, so no barrier is needed first
    band_product<T, NB, NT>(E, E, acc, ty, tx);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int r = ty + TY * a, cc = tx + 16 * c;
        T s = T(0);
        if (cc <= r)
          s = r < nb ? (Am[r * LD + cc] + (r == cc ? dlt : T(0))) - acc[a][c]
                     : (r == cc ? T(1) : T(0));
        S[r * LD + cc] = s;
      }
    __syncthreads();
    clk.mark(TD_OTHER);

    // the next stage's blocks, in flight while this stage factors (B_k's
    // buffer is read below, so B_{k+1} goes to the other one)
    if (k + 1 < K) fetch_block<T, NB, NT>(Am, A_b + (k + 1) * blk, nb, ty, tx);
    if (k + 2 < K)
      fetch_block<T, NB, NT>(Bm + ((k + 1) & 1) * NB * LD,
                             B_b + (k + 1) * blk, nb, ty, tx);

    // 2. C_k and C_k^{-1} (chol_tile starts and ends with a barrier)
    clk.mark(TD_B);
    chol_tile<T, NB, NT, true>(S, X, vec, own, tid, ok);

    // 3. C_k and X out; E_k = B_k X^T
    clk.mark(TD_C);
    if (k < K - 1)
      band_product<T, NB, NT>(Bk, X, acc, ty, tx);
    clk.mark(TD_D);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int r = ty + TY * a, cc = tx + 16 * c;
        const bool in = r < nb && cc < nb;
        if (in) {
          Ck_b[k * blk + r * nb + cc] = S[r * LD + cc];
          Ci_b[k * blk + r * nb + cc] = X[r * LD + cc];
        }
        if (k < K - 1) {
          E[r * LD + cc] = acc[a][c];
          if (in) Ek_b[k * blk + r * nb + cc] = acc[a][c];
        }
      }
    __syncthreads();
  }
  if (tid == 0) ok_out[b] = ok;
  clk.write();
}

// --- the launches

template <typename T, int NB, int NT>
int launch_factor_nb(const void* Ad, const void* Bs, const void* delta,
                     void* Ck, void* Ci, void* Ek, void* ok, int B, int K,
                     int nb, void* stream) {
  const auto kernel = tridiag_factor_kernel<T, NB, NT>;
  const size_t smem = factor_smem<T, NB>();
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
      (const T*)Ad, (const T*)Bs, (const T*)delta, (T*)Ck, (T*)Ci, (T*)Ek,
      (int*)ok, K, nb);
  return (int)cudaGetLastError();
}

// `mode`: a matmul mode's code (mm_mode.cuh), 0 = IEEE; float64 takes 0
// only, and a code without a moded instantiation is refused, never run as
// IEEE.  `clk`: the clock rows of a clocked build.
template <typename T>
int launch_factor(const void* Ad, const void* Bs, const void* delta, void* Ck,
                  void* Ci, void* Ek, void* ok, int B, int K, int nb,
                  int mode, void* clk, void* stream) {
  if (nb > MAX_NB) return (int)cudaErrorInvalidValue;
  if (mode != 0) {
    if constexpr (sizeof(T) == 4)
      return onephase::tridiag_factor_moded(Ad, Bs, delta, Ck, Ci, Ek, ok, B,
                                            K, nb, mode, clk, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (int err = set_clocks(clk, stream)) return err;
  if (nb <= 32)
    return launch_factor_nb<T, 32, 256>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K,
                                        nb, stream);
  return launch_factor_nb<T, 64, 512>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K,
                                      nb, stream);
}

template <typename T, int NB, bool ROWS>
int launch_solve_nb(const void* Ci, const void* Ek, const void* b, void* x,
                    int B, int K, int nb, void* stream) {
  using S = SolveShape<T, NB>;
  // unmasked where nb fills the block edge
  const auto kernel = nb == NB
                          ? tridiag_solve_kernel<T, NB, ROWS, true, 0, 0>
                          : tridiag_solve_kernel<T, NB, ROWS, false, 0, 0>;
  int err = set_smem(kernel, S::SMEM);
  if (err) return err;
  kernel<<<B, S::THREADS, S::SMEM, (cudaStream_t)stream>>>(
      (const T*)Ci, (const T*)Ek, (const T*)b, (T*)x, K, nb);
  return (int)cudaGetLastError();
}

// `mode` and `clk` as for launch_factor.
template <typename T>
int launch_solve(const void* Ci, const void* Ek, const void* b, void* x,
                 int B, int K, int nb, int mode, void* clk, void* stream) {
  if (nb > MAX_NB) return (int)cudaErrorInvalidValue;
  if (mode != 0) {
    if constexpr (sizeof(T) == 4)
      return onephase::tridiag_solve_moded(Ci, Ek, b, x, B, K, nb, mode, clk,
                                           stream);
    return (int)cudaErrorInvalidValue;
  }
  if (int err = set_clocks(clk, stream)) return err;
  // the row layout where every row of every block is 16-byte aligned
  const bool rows = nb * sizeof(T) % 16 == 0 && aligned16(Ci) &&
                    aligned16(Ek);
  if (nb <= 32)
    return rows ? launch_solve_nb<T, 32, true>(Ci, Ek, b, x, B, K, nb, stream)
                : launch_solve_nb<T, 32, false>(Ci, Ek, b, x, B, K, nb,
                                                stream);
  return rows ? launch_solve_nb<T, 64, true>(Ci, Ek, b, x, B, K, nb, stream)
              : launch_solve_nb<T, 64, false>(Ci, Ek, b, x, B, K, nb, stream);
}

}  // namespace

#ifdef ONEPHASE_TRIDIAG_CLOCKS
// op_tridiag_factor_f32 and op_tridiag_solve_f32 with the phase clocks
// written to `clk` (int64, (B, TD_CLK_SLOTS), zeroed by the caller)
extern "C" int op_tridiag_factor_clocks_f32(const void* Ad, const void* Bs,
                                            const void* delta, void* Ck,
                                            void* Ci, void* Ek, void* ok,
                                            int B, int K, int nb, int mode,
                                            void* clk, void* stream) {
  return launch_factor<float>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb, mode,
                              clk, stream);
}

extern "C" int op_tridiag_solve_clocks_f32(const void* Ci, const void* Ek,
                                           const void* b, void* x, int B,
                                           int K, int nb, int mode, void* clk,
                                           void* stream) {
  return launch_solve<float>(Ci, Ek, b, x, B, K, nb, mode, clk, stream);
}
#else
extern "C" int op_tridiag_factor_f32(const void* Ad, const void* Bs,
                                     const void* delta, void* Ck, void* Ci,
                                     void* Ek, void* ok, int B, int K, int nb,
                                     int mode, void* stream) {
  return launch_factor<float>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb, mode,
                              nullptr, stream);
}

extern "C" int op_tridiag_factor_f64(const void* Ad, const void* Bs,
                                     const void* delta, void* Ck, void* Ci,
                                     void* Ek, void* ok, int B, int K, int nb,
                                     int mode, void* stream) {
  return launch_factor<double>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb, mode,
                               nullptr, stream);
}

extern "C" int op_tridiag_solve_f32(const void* Ci, const void* Ek,
                                    const void* b, void* x, int B, int K,
                                    int nb, int mode, void* stream) {
  return launch_solve<float>(Ci, Ek, b, x, B, K, nb, mode, nullptr, stream);
}

extern "C" int op_tridiag_solve_f64(const void* Ci, const void* Ek,
                                    const void* b, void* x, int B, int K,
                                    int nb, int mode, void* stream) {
  return launch_solve<double>(Ci, Ek, b, x, B, K, nb, mode, nullptr, stream);
}
#endif
