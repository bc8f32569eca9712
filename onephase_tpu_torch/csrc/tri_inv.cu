// Batched triangular inverse: L (B, n, n) lower -> Li = L^-1 (B, n, n),
// lower with the strict upper triangle zeroed.  The wrapper
// (ops/cholesky.py:pallas_tri_inv_gram) follows it with the Gram product
// M = Li^T Li, run by the tiled kernel of fused_q.cuh in its
// lower-triangular mode (w = 1, no H, no diagonal): together they replace
// the TPU kernel onephase_tpu/ops/cholesky.py:pallas_tri_inv_gram
// (_tri_inv_gram_kernel :131-156: blocked forward substitution on the
// identity, then one Gram matmul).
//
// What bounds it on the H100: FP32/FP64 FMA rate.  The inverse costs
// n^3/3 multiply-adds per instance and the Gram product about n^3/3 more
// (only rows k >= max(i, j) of Li contribute); both are far above the
// memory roofline at n >= 256.
//
// What the simple design does about it: the columns of L^-1 are
// independent forward substitutions on e_j, so the grid is (32-column
// tile, instance) and blocks never wait for each other.  A block walks its
// columns' rows in 32-row chunks: the update from the rows already solved
// is a 32 x 32 tile product staged through shared memory (4 outputs per
// thread), then one warp solves the chunk's 32 x 32 triangular system in
// shared memory, one column per lane.  Solved rows go to Li in global
// memory, where the next chunks read them back (L2-resident).  The ragged
// edge is masked, nothing is padded.
#include <cuda_runtime.h>

namespace {

constexpr int TC = 32;   // columns per block
constexpr int RC = 32;   // rows per chunk (and k rows per staged step)
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
tri_inv_kernel(const T* __restrict__ L, T* __restrict__ Li, int n) {
  __shared__ T Ls[RC][RC + 1];   // L[R0 + r, k0 + c]
  __shared__ T Xs[RC][TC + 1];   // Li[k0 + r, c0 + c]
  __shared__ T Dg[RC][RC + 1];   // diagonal block L[R0 + r, R0 + c]
  __shared__ T S[RC][TC + 1];    // right-hand side, then solution

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * TC;
  const int tc = min(TC, n - c0);
  const long long nn = (long long)n * n;
  const T* Lb = L + (long long)b * nn;
  T* X = Li + (long long)b * nn;
  const int tid = threadIdx.x;
  const int tx = tid % 32, ty = tid / 32;   // 4 outputs: rows ty + 8a

  // rows above the diagonal block are zero
  for (long long e = tid; e < (long long)c0 * TC; e += THREADS) {
    const long long r = e / TC;
    const int c = (int)(e % TC);
    if (c < tc) X[r * n + c0 + c] = T(0);
  }

  for (int R0 = c0; R0 < n; R0 += RC) {
    const int rb = min(RC, n - R0);
    T acc[4] = {T(0), T(0), T(0), T(0)};
    // update from the solved rows: sum_k L[R0 + i, k] * Li[k, c0 + j]
    for (int k0 = c0; k0 < R0; k0 += RC) {
      for (int e = tid; e < RC * RC; e += THREADS) {
        const int r = e / RC, c = e % RC;
        Ls[r][c] = (R0 + r < n) ? Lb[(long long)(R0 + r) * n + k0 + c] : T(0);
        Xs[r][c] = (c < tc) ? X[(long long)(k0 + r) * n + c0 + c] : T(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int p = 0; p < RC; ++p) {
        const T xv = Xs[p][tx];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a] += Ls[ty + 8 * a][p] * xv;
      }
      __syncthreads();
    }
    // right-hand side: identity columns minus the update
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 8 * a;
      S[i][tx] = ((R0 + i == c0 + tx) ? T(1) : T(0)) - acc[a];
    }
    for (int e = tid; e < RC * RC; e += THREADS) {
      const int r = e / RC, c = e % RC;
      Dg[r][c] = (r < rb && c <= r) ? Lb[(long long)(R0 + r) * n + R0 + c]
                                    : (r == c ? T(1) : T(0));
    }
    __syncthreads();
    // forward substitution with the diagonal block, one column per lane
    if (ty == 0) {
      for (int i = 0; i < rb; ++i) {
        T s = S[i][tx];
        for (int p = 0; p < i; ++p) s -= Dg[i][p] * S[p][tx];
        S[i][tx] = s / Dg[i][i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 8 * a;
      if (i < rb && tx < tc) X[(long long)(R0 + i) * n + c0 + tx] = S[i][tx];
    }
    __syncthreads();
  }
}

template <typename T>
int launch_tri_inv(const void* L, void* Li, int B, int n, void* stream) {
  dim3 grid((n + TC - 1) / TC, B);
  tri_inv_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)L, (T*)Li, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int op_tri_inv_f32(const void* L, void* Li, int B, int n,
                              void* stream) {
  return launch_tri_inv<float>(L, Li, B, n, stream);
}

extern "C" int op_tri_inv_f64(const void* L, void* Li, int B, int n,
                              void* stream) {
  return launch_tri_inv<double>(L, Li, B, n, stream);
}
