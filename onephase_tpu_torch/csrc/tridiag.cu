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
//   both sweeps in one launch (y is kept in the output x, row t written
//   and read back by thread t).
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
// The solve keeps its simple design: one row per thread in each sweep,
// blocks padded to the odd leading dimension nb | 1, and each thread's
// shared-memory offsets computed once.  The ragged edge is masked in global
// memory.  nb <= 64.
#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

using onephase::chol_tile;
using onephase::tile_entries;
using onephase::tile_ld;
using onephase::tile_owner;

constexpr int THREADS = 256;
constexpr int MAX_NB = 64;
constexpr int PER_T = MAX_NB * MAX_NB / THREADS;   // block elements a thread holds

// --- the factor (K7)

// Copy one element global -> shared without the registers (cp.async, 4 or
// 8 bytes; the inputs are read-only, so the L1 path is safe).
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One nb x nb block (row-major in global memory) into an NB x NB shared
// tile (leading dimension NB | 1), the thread's entries (ty + TY a,
// tx + 16 c) of it; entries past nb are left as they are.
template <typename T, int NB, int NT>
__device__ __forceinline__ void fetch_block(T* dst, const T* src, int nb,
                                            int ty, int tx) {
  constexpr int LD = tile_ld<NB>(), TY = NT / 16;
#pragma unroll
  for (int a = 0; a < NB * 16 / NT; ++a)
#pragma unroll
    for (int c = 0; c < NB / 16; ++c) {
      const int r = ty + TY * a, cc = tx + 16 * c;
      if (r < nb && cc < nb) cp_async(dst + r * LD + cc, src + r * nb + cc);
    }
  cp_async_commit();
}

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
  __syncthreads();
  fetch_block<T, NB, NT>(Am, A_b, nb, ty, tx);
  if (K > 1) fetch_block<T, NB, NT>(Bm, B_b, nb, ty, tx);

  for (int k = 0; k < K; ++k) {
    T* Bk = Bm + (k & 1) * NB * LD;
    cp_async_wait_all();
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

    // the next stage's blocks, in flight while this stage factors (B_k's
    // buffer is read below, so B_{k+1} goes to the other one)
    if (k + 1 < K) fetch_block<T, NB, NT>(Am, A_b + (k + 1) * blk, nb, ty, tx);
    if (k + 2 < K)
      fetch_block<T, NB, NT>(Bm + ((k + 1) & 1) * NB * LD,
                             B_b + (k + 1) * blk, nb, ty, tx);

    // 2. C_k and C_k^{-1} (chol_tile starts and ends with a barrier)
    chol_tile<T, NB, NT, true>(S, X, vec, own, tid, ok);

    // 3. C_k and X out; E_k = B_k X^T
    if (k < K - 1) band_product<T, NB, NT>(Bk, X, acc, ty, tx);
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
}

// --- the solve (K5)

// One nb x nb block (row-major in global memory) into registers: element
// e = tid + i * THREADS goes to reg[i].
template <typename T>
__device__ __forceinline__ void load_block(T (&reg)[PER_T], const T* src,
                                           int nn, int tid) {
#pragma unroll
  for (int i = 0; i < PER_T; ++i) {
    const int e = tid + i * THREADS;
    if (e < nn) reg[i] = src[e];
  }
}

// Where load_block's registers go in a shared block of leading dimension
// ld: computed once, so no loop divides by the runtime nb.
__device__ __forceinline__ void block_offsets(int (&off)[PER_T], int nb,
                                              int ld, int tid) {
#pragma unroll
  for (int i = 0; i < PER_T; ++i) {
    const int e = tid + i * THREADS;
    off[i] = e < nb * nb ? (e / nb) * ld + e % nb : -1;
  }
}

template <typename T>
__device__ __forceinline__ void store_block(T* dst, const T (&reg)[PER_T],
                                            const int (&off)[PER_T]) {
#pragma unroll
  for (int i = 0; i < PER_T; ++i)
    if (off[i] >= 0) dst[off[i]] = reg[i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tridiag_solve_kernel(const T* __restrict__ Ci, const T* __restrict__ Ek,
                     const T* __restrict__ rhs, T* __restrict__ x, int K,
                     int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = nb | 1;
  T* M = reinterpret_cast<T*>(smem_raw);   // Ci_k
  T* E = M + nb * ld;                      // E_{k-1} (forward), E_k (backward)
  T* v = E + nb * ld;                      // y_{k-1} (forward), x_{k+1} (backward)
  T* r = v + nb;                           // the stage's residual

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nn = nb * nb;
  const long long blk = nn;
  const T* Ci_b = Ci + (long long)b * K * blk;
  const T* Ek_b = Ek + (long long)b * (K - 1) * blk;
  const T* b_b = rhs + (long long)b * K * nb;
  T* x_b = x + (long long)b * K * nb;

  T m_reg[PER_T], e_reg[PER_T];
  int off[PER_T];
  block_offsets(off, nb, ld, tid);
  if (tid < nb) v[tid] = T(0);
  load_block(m_reg, Ci_b, nn, tid);

  // forward sweep: y_k = Ci_k (b_k - E_{k-1} y_{k-1}), y_k into x
  for (int k = 0; k < K; ++k) {
    store_block(M, m_reg, off);
    if (k > 0) store_block(E, e_reg, off);
    __syncthreads();
    if (k + 1 < K) {
      load_block(m_reg, Ci_b + (k + 1) * blk, nn, tid);
      load_block(e_reg, Ek_b + k * blk, nn, tid);
    } else {
      load_block(m_reg, Ci_b + k * blk, nn, tid);   // first backward stage
    }
    if (tid < nb) {
      T s = T(0);
      if (k > 0)
        for (int c = 0; c < nb; ++c) s += E[tid * ld + c] * v[c];
      r[tid] = b_b[k * nb + tid] - s;
    }
    __syncthreads();
    if (tid < nb) {
      T y = T(0);
      for (int c = 0; c < nb; ++c) y += M[tid * ld + c] * r[c];
      x_b[k * nb + tid] = y;
      v[tid] = y;
    }
    __syncthreads();
  }

  // backward sweep: x_k = Ci_k^T (y_k - E_k^T x_{k+1})
  for (int k = K - 1; k >= 0; --k) {
    store_block(M, m_reg, off);
    if (k < K - 1) store_block(E, e_reg, off);
    __syncthreads();
    if (k > 0) {
      load_block(m_reg, Ci_b + (k - 1) * blk, nn, tid);
      load_block(e_reg, Ek_b + (k - 1) * blk, nn, tid);
    }
    if (tid < nb) {
      T s = T(0);
      if (k < K - 1)
        for (int c = 0; c < nb; ++c) s += E[c * ld + tid] * v[c];
      r[tid] = x_b[k * nb + tid] - s;
    }
    __syncthreads();
    if (tid < nb) {
      T xv = T(0);
      for (int c = 0; c < nb; ++c) xv += M[c * ld + tid] * r[c];
      x_b[k * nb + tid] = xv;
      v[tid] = xv;
    }
    __syncthreads();
  }
}

template <typename Kern>
int set_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int NB, int NT>
int launch_factor_nb(const void* Ad, const void* Bs, const void* delta,
                     void* Ck, void* Ci, void* Ek, void* ok, int B, int K,
                     int nb, void* stream) {
  const size_t smem = factor_smem<T, NB>();
  int err = set_smem(tridiag_factor_kernel<T, NB, NT>, smem);
  if (err) return err;
  tridiag_factor_kernel<T, NB, NT><<<B, NT, smem, (cudaStream_t)stream>>>(
      (const T*)Ad, (const T*)Bs, (const T*)delta, (T*)Ck, (T*)Ci, (T*)Ek,
      (int*)ok, K, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_factor(const void* Ad, const void* Bs, const void* delta, void* Ck,
                  void* Ci, void* Ek, void* ok, int B, int K, int nb,
                  void* stream) {
  if (nb > MAX_NB) return (int)cudaErrorInvalidValue;
  if (nb <= 32)
    return launch_factor_nb<T, 32, 256>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K,
                                        nb, stream);
  return launch_factor_nb<T, 64, 512>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb,
                                      stream);
}

template <typename T>
int launch_solve(const void* Ci, const void* Ek, const void* b, void* x,
                 int B, int K, int nb, void* stream) {
  if (nb > MAX_NB) return (int)cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)nb * (nb | 1) + 2 * nb) * sizeof(T);
  int err = set_smem(tridiag_solve_kernel<T>, smem);
  if (err) return err;
  tridiag_solve_kernel<T><<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)Ci, (const T*)Ek, (const T*)b, (T*)x, K, nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int op_tridiag_factor_f32(const void* Ad, const void* Bs,
                                     const void* delta, void* Ck, void* Ci,
                                     void* Ek, void* ok, int B, int K, int nb,
                                     void* stream) {
  return launch_factor<float>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb, stream);
}

extern "C" int op_tridiag_factor_f64(const void* Ad, const void* Bs,
                                     const void* delta, void* Ck, void* Ci,
                                     void* Ek, void* ok, int B, int K, int nb,
                                     void* stream) {
  return launch_factor<double>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb,
                               stream);
}

extern "C" int op_tridiag_solve_f32(const void* Ci, const void* Ek,
                                    const void* b, void* x, int B, int K,
                                    int nb, void* stream) {
  return launch_solve<float>(Ci, Ek, b, x, B, K, nb, stream);
}

extern "C" int op_tridiag_solve_f64(const void* Ci, const void* Ek,
                                    const void* b, void* x, int B, int K,
                                    int nb, void* stream) {
  return launch_solve<double>(Ci, Ek, b, x, B, K, nb, stream);
}
