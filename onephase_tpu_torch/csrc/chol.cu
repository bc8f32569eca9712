// Batched blocked Cholesky: Q (B, n, n) -> L (lower, strict upper zeroed),
// d = diag(L) (B, n), ok (B,) = every pivot positive and finite.
//
// Replaces the TPU kernel onephase_tpu/ops/cholesky.py:pallas_chol
// (_chol_kernel :99-128 with _unblocked_chol :48-75 and _tri_inv_unblocked
// :78-96).  Pivot protocol as in _unblocked_chol: ok &= pivot > 0 &&
// isfinite(pivot), then the column is scaled by rsqrt(max(pivot, tiny)) and
// the factorization continues (tiny = 1e-38 in f32, 1e-300 in f64); on
// failure L is garbage and only ok matters.
//
// What bounds it on the H100: the serial panel dependency and the number
// of active SMs.  Each 32-column panel must be factored before the next
// can start, and the design runs one thread block per instance, so a batch
// of B instances keeps B of the 132 SMs busy (16 at the bench's batch).
//
// What the simple design does about it: one block of 256 threads per
// instance, right-looking with 32-column panels.  The diagonal block is
// factored in shared memory; the rows below it are solved against it one
// row per thread with the row in registers; the trailing update
// A22 -= L21 L21^T walks the lower triangle in 64 x 64 tiles, staging the
// two 64 x 32 panel slices in shared memory and keeping a 4 x 4 register
// block per thread.  The matrix itself stays in global memory, where it is
// L2-resident at the bench's sizes (16 x 256^2 x 4 B = 4 MB); panels cut
// the trailing-matrix traffic by the panel width.  The ragged edge is
// masked, nothing is padded.
#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;        // panel width
constexpr int CT = 64;        // trailing-update tile edge
constexpr int THREADS = 256;

// smallest pivot fed to the reciprocal square root, and the largest finite
// value (a pivot above it is +inf; NaN compares false with both)
template <typename T> __device__ __forceinline__ T tiny_pivot();
template <> __device__ __forceinline__ float tiny_pivot<float>() { return 1e-38f; }
template <> __device__ __forceinline__ double tiny_pivot<double>() { return 1e-300; }
template <typename T> __device__ __forceinline__ T max_finite();
template <> __device__ __forceinline__ float max_finite<float>() { return 3.402823466e38f; }
template <> __device__ __forceinline__ double max_finite<double>() { return 1.7976931348623157e308; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
chol_kernel(const T* __restrict__ Q, T* __restrict__ L, T* __restrict__ d,
            int* __restrict__ ok_out, int n) {
  __shared__ T D[NB][NB + 1];      // diagonal block being factored
  __shared__ T As[CT][NB + 1];     // panel rows of the tile's i range
  __shared__ T Bs[CT][NB + 1];     // panel rows of the tile's j range
  __shared__ T dinv_s;
  __shared__ int ok_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long nn = (long long)n * n;
  const T* A = Q + (long long)b * nn;
  T* Lb = L + (long long)b * nn;
  const T tiny = tiny_pivot<T>();

  // L := lower triangle of Q, strict upper zeroed
  for (long long e = tid; e < nn; e += THREADS) {
    const long long r = e / n, c = e % n;
    Lb[e] = c <= r ? A[e] : T(0);
  }
  if (tid == 0) ok_s = 1;
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += NB) {
    const int kb = min(NB, n - k0);

    // 1. diagonal block -> shared memory
    for (int e = tid; e < NB * NB; e += THREADS) {
      const int r = e / NB, c = e % NB;
      D[r][c] = (r < kb && c <= r) ? Lb[(long long)(k0 + r) * n + k0 + c]
                                   : T(0);
    }
    __syncthreads();

    // 2. unblocked right-looking Cholesky of the block
    for (int j = 0; j < kb; ++j) {
      if (tid == 0) {
        const T piv = D[j][j];
        if (!(piv > T(0) && piv <= max_finite<T>())) ok_s = 0;
        dinv_s = T(1) / sqrt(piv > tiny ? piv : tiny);
      }
      __syncthreads();
      if (tid >= j && tid < kb) D[tid][j] *= dinv_s;
      __syncthreads();
      for (int e = tid; e < NB * NB; e += THREADS) {
        const int r = e / NB, c = e % NB;
        if (c > j && r >= c && r < kb) D[r][c] -= D[r][j] * D[c][j];
      }
      __syncthreads();
    }

    // 3. factored block back to L, its diagonal to d
    for (int e = tid; e < NB * NB; e += THREADS) {
      const int r = e / NB, c = e % NB;
      if (r < kb && c <= r) Lb[(long long)(k0 + r) * n + k0 + c] = D[r][c];
    }
    if (tid < kb) d[(long long)b * n + k0 + tid] = D[tid][tid];

    const int r0 = k0 + kb;   // first row below the panel (kb == NB here)
    if (r0 < n) {
      // 4. panel: L21 = A21 Lkk^-T, one row per thread, forward substitution
      for (int r = r0 + tid; r < n; r += THREADS) {
        T* row = Lb + (long long)r * n + k0;
        T x[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j) x[j] = row[j];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          T s = x[j];
#pragma unroll
          for (int p = 0; p < j; ++p) s -= x[p] * D[j][p];
          x[j] = s / D[j][j];
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) row[j] = x[j];
      }
      __syncthreads();

      // 5. trailing update A22 -= L21 L21^T on the lower triangle
      const int tx = tid % 16, ty = tid / 16;
      const int nt = (n - r0 + CT - 1) / CT;
      for (int ti = 0; ti < nt; ++ti) {
        for (int tj = 0; tj <= ti; ++tj) {
          const int i0 = r0 + ti * CT, j0 = r0 + tj * CT;
          for (int e = tid; e < CT * NB; e += THREADS) {
            const int r = e / NB, c = e % NB;
            As[r][c] = (i0 + r < n) ? Lb[(long long)(i0 + r) * n + k0 + c]
                                    : T(0);
            Bs[r][c] = (j0 + r < n) ? Lb[(long long)(j0 + r) * n + k0 + c]
                                    : T(0);
          }
          __syncthreads();
          T acc[4][4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = T(0);
#pragma unroll 8
          for (int p = 0; p < NB; ++p) {
            T av[4], bv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) av[a] = As[ty + 16 * a][p];
#pragma unroll
            for (int c = 0; c < 4; ++c) bv[c] = Bs[tx + 16 * c][p];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[a][c] += av[a] * bv[c];
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = i0 + ty + 16 * a;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int j = j0 + tx + 16 * c;
              if (i < n && j <= i) Lb[(long long)i * n + j] -= acc[a][c];
            }
          }
          __syncthreads();
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) ok_out[b] = ok_s;
}

template <typename T>
int launch_chol(const void* Q, void* L, void* d, void* ok, int B, int n,
                void* stream) {
  chol_kernel<T><<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)Q, (T*)L, (T*)d, (int*)ok, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int op_chol_f32(const void* Q, void* L, void* d, void* ok, int B,
                           int n, void* stream) {
  return launch_chol<float>(Q, L, d, ok, B, n, stream);
}

extern "C" int op_chol_f64(const void* Q, void* L, void* d, void* ok, int B,
                           int n, void* stream) {
  return launch_chol<double>(Q, L, d, ok, B, n, stream);
}
