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
// What the design does about it: every stage works on nb x nb blocks in
// shared memory (rows padded to nb + 1 against bank conflicts), and the
// next stage's input blocks are loaded into registers while the current
// stage computes, so the global-memory latency of a stage overlaps the
// serial work of the one before.  The Cholesky takes one barrier per
// column (the trailing update of column j and the scaling of column j-1
// share a phase); the inverse is one column per thread, with no barrier.
// The ragged edge is masked, nothing is padded in memory.  nb <= 64.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_NB = 64;
constexpr int PER_T = MAX_NB * MAX_NB / THREADS;   // block elements a thread holds

template <typename T> __device__ __forceinline__ T tiny_pivot();
template <> __device__ __forceinline__ float tiny_pivot<float>() { return 1e-38f; }
template <> __device__ __forceinline__ double tiny_pivot<double>() { return 1e-300; }
template <typename T> __device__ __forceinline__ T max_finite();
template <> __device__ __forceinline__ float max_finite<float>() { return 3.402823466e38f; }
template <> __device__ __forceinline__ double max_finite<double>() { return 1.7976931348623157e308; }

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

// The registers of load_block into a padded shared block (leading dim ld).
template <typename T>
__device__ __forceinline__ void store_block(T* dst, const T (&reg)[PER_T],
                                            int nb, int ld, int tid) {
#pragma unroll
  for (int i = 0; i < PER_T; ++i) {
    const int e = tid + i * THREADS;
    if (e < nb * nb) dst[(e / nb) * ld + e % nb] = reg[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tridiag_factor_kernel(const T* __restrict__ Ad, const T* __restrict__ Bs,
                      const T* __restrict__ delta, T* __restrict__ Ck,
                      T* __restrict__ Ci, T* __restrict__ Ek,
                      int* __restrict__ ok_out, int K, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = nb + 1;
  T* S = reinterpret_cast<T*>(smem_raw);   // A_k + dI - E E^T, then C_k
  T* X = S + nb * ld;                      // C_k^{-1}
  T* E = X + nb * ld;                      // E_{k-1}, then E_k
  T* Bm = E + nb * ld;                     // B_k
  __shared__ int ok_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nn = nb * nb;
  const long long blk = nn;
  const T* A_b = Ad + (long long)b * K * blk;
  const T* B_b = Bs + (long long)b * (K - 1) * blk;
  T* Ck_b = Ck + (long long)b * K * blk;
  T* Ci_b = Ci + (long long)b * K * blk;
  T* Ek_b = Ek + (long long)b * (K - 1) * blk;
  const T dlt = delta[b];
  const T tiny = tiny_pivot<T>();

  for (int e = tid; e < nb * ld; e += THREADS) E[e] = T(0);   // E_{-1} = 0
  if (tid == 0) ok_s = 1;
  T a_reg[PER_T], b_reg[PER_T];
  load_block(a_reg, A_b, nn, tid);
  if (K > 1) load_block(b_reg, B_b, nn, tid);
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    // 1. S = (A_k + delta I) - E_{k-1} E_{k-1}^T on the lower triangle
    //    (upper zeroed), B_k to shared memory
#pragma unroll
    for (int i = 0; i < PER_T; ++i) {
      const int e = tid + i * THREADS;
      if (e < nn) {
        const int r = e / nb, c = e % nb;
        T s = T(0);
        if (c <= r) {
          T acc = T(0);
          for (int p = 0; p < nb; ++p) acc += E[r * ld + p] * E[c * ld + p];
          s = (a_reg[i] + (r == c ? dlt : T(0))) - acc;
        }
        S[r * ld + c] = s;
      }
    }
    if (k < K - 1) store_block(Bm, b_reg, nb, ld, tid);
    __syncthreads();

    // the next stage's blocks, in flight while this stage computes
    if (k + 1 < K) load_block(a_reg, A_b + (k + 1) * blk, nn, tid);
    if (k + 2 < K) load_block(b_reg, B_b + (k + 1) * blk, nn, tid);

    // 2. unblocked Cholesky of S: one barrier per column; column j-1 is
    //    scaled in the same phase as the trailing update of column j
    T dinv_prev = T(0);
    for (int j = 0; j < nb; ++j) {
      const T piv = S[j * ld + j];
      const T dinv = T(1) / sqrt(piv > tiny ? piv : tiny);
      if (tid == 0 && !(piv > T(0) && piv <= max_finite<T>())) ok_s = 0;
      for (int e = tid; e < nn; e += THREADS) {
        const int r = e / nb, c = e % nb;
        if (r < c) continue;
        if (c > j) {
          S[r * ld + c] -= (S[r * ld + j] * dinv) * (S[c * ld + j] * dinv);
        } else if (c == j - 1) {
          S[r * ld + c] *= dinv_prev;
        }
      }
      dinv_prev = dinv;
      __syncthreads();
    }
    if (tid == 0) S[(nb - 1) * ld + nb - 1] *= dinv_prev;
    __syncthreads();

    // 3. X = C_k^{-1}: column j by forward substitution on thread j
    if (tid < nb) {
      const int j = tid;
      for (int i = 0; i < nb; ++i) {
        T v = T(0);
        if (i >= j) {
          T s = (i == j) ? T(1) : T(0);
          for (int p = j; p < i; ++p) s -= S[i * ld + p] * X[p * ld + j];
          v = s / S[i * ld + i];
        }
        X[i * ld + j] = v;
      }
    }
    __syncthreads();

    // 4. E_k = B_k X^T (X lower: p <= c); C_k and X out
    for (int e = tid; e < nn; e += THREADS) {
      const int r = e / nb, c = e % nb;
      if (k < K - 1) {
        T s = T(0);
        for (int p = 0; p <= c; ++p) s += Bm[r * ld + p] * X[c * ld + p];
        E[r * ld + c] = s;
        Ek_b[k * blk + e] = s;
      }
      Ck_b[k * blk + e] = S[r * ld + c];
      Ci_b[k * blk + e] = X[r * ld + c];
    }
    __syncthreads();
  }
  if (tid == 0) ok_out[b] = ok_s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tridiag_solve_kernel(const T* __restrict__ Ci, const T* __restrict__ Ek,
                     const T* __restrict__ rhs, T* __restrict__ x, int K,
                     int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = nb + 1;
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
  if (tid < nb) v[tid] = T(0);
  load_block(m_reg, Ci_b, nn, tid);

  // forward sweep: y_k = Ci_k (b_k - E_{k-1} y_{k-1}), y_k into x
  for (int k = 0; k < K; ++k) {
    store_block(M, m_reg, nb, ld, tid);
    if (k > 0) store_block(E, e_reg, nb, ld, tid);
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
    store_block(M, m_reg, nb, ld, tid);
    if (k < K - 1) store_block(E, e_reg, nb, ld, tid);
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

template <typename T>
int launch_factor(const void* Ad, const void* Bs, const void* delta, void* Ck,
                  void* Ci, void* Ek, void* ok, int B, int K, int nb,
                  void* stream) {
  if (nb > MAX_NB) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)nb * (nb + 1) * sizeof(T);
  int err = set_smem(tridiag_factor_kernel<T>, smem);
  if (err) return err;
  tridiag_factor_kernel<T><<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)Ad, (const T*)Bs, (const T*)delta, (T*)Ck, (T*)Ci, (T*)Ek,
      (int*)ok, K, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve(const void* Ci, const void* Ek, const void* b, void* x,
                 int B, int K, int nb, void* stream) {
  if (nb > MAX_NB) return (int)cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)nb * (nb + 1) + 2 * nb) * sizeof(T);
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
