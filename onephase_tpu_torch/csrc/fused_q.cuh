// Tiled batched product Q[b] = H[b] + Jc[b]^T diag(w[b]) Jc[b] + diag(bnd[b]).
//
// Replaces the TPU kernel onephase_tpu/ops/schur.py:pallas_fused_q
// (_fused_q_kernel, :30-47), which tiles the (i, j) output over its grid
// and reduces the constraint axis k into the output tile, with H and the
// diagonal added at k = 0.
//
// What bounds it on the H100: plain FP32/FP64 FMA rate.  At the main
// path's shapes (n = 256..2048, m = n/2, B = 16..64) the product does
// 2 B n^2 m flops on B n m + B n^2 elements, so it sits far above the
// memory roofline; without tensor cores (this kernel keeps full FP32/FP64,
// no TF32) the SM's FMA pipes are the limit.
//
// What the simple design does about it: a grid of (64 x 64 output tile,
// instance).  Each block stages k-chunks of the Jc columns of its i and j
// tiles in shared memory (the i side already scaled by w), and each of its
// 256 threads keeps a 4 x 4 block of the tile in registers, so every
// shared-memory value feeds 4 FMAs.  H and the diagonal are added in the
// epilogue.  The ragged edge is masked, nothing is padded.  A shared
// (folded-constant) Jc or H is read with batch stride 0.
#pragma once

#include <cuda_runtime.h>

namespace onephase {

constexpr int FQ_TILE = 64;     // output tile edge
constexpr int FQ_KC = 16;       // k rows staged per step
constexpr int FQ_THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

// The tile loop shared by the kernels of this header and of
// fused_q_tri.cu: acc[r][c] = sum over k in [kbeg, m) of
// (J[k, i0 + ty + 16 r] * w[k]) * J[k, j0 + tx + 16 c], staged through the
// (FQ_KC, FQ_TILE) shared buffers As (the scaled i side) and Bs (the j side).
// Columns past n read as zero.  Ends on a barrier when the loop ran.
template <typename T>
__device__ __forceinline__ void fq_tile_product(
    const T* __restrict__ J, const T* __restrict__ wb, int m, int n, int i0,
    int j0, int kbeg, T (*As)[FQ_TILE], T (*Bs)[FQ_TILE], T (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = T(0);

  for (int k0 = kbeg; k0 < m; k0 += FQ_KC) {
    for (int e = tid; e < FQ_KC * FQ_TILE; e += FQ_THREADS) {
      const int kk = e / FQ_TILE, c = e % FQ_TILE;
      const int k = k0 + kk;
      T a = T(0), bv = T(0);
      if (k < m) {
        if (i0 + c < n) {
          a = J[(long long)k * n + i0 + c];
          if (wb) a *= wb[k];
        }
        if (j0 + c < n) bv = J[(long long)k * n + j0 + c];
      }
      As[kk][c] = a;
      Bs[kk][c] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FQ_KC; ++kk) {
      T av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += av[r] * bv[c];
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(FQ_THREADS)
fused_q_kernel(const T* __restrict__ Jc, long long jc_bs,
               const T* __restrict__ w, const T* __restrict__ H,
               long long h_bs, const T* __restrict__ bnd,
               T* __restrict__ Q, int m, int n) {
  __shared__ T As[FQ_KC][FQ_TILE];  // Jc[k, i0 + c] * w[k]
  __shared__ T Bs[FQ_KC][FQ_TILE];  // Jc[k, j0 + c]
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * FQ_TILE;
  const int j0 = blockIdx.x * FQ_TILE;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* J = Jc + (long long)b * jc_bs;
  const T* wb = w ? w + (long long)b * m : nullptr;

  T acc[4][4];
  fq_tile_product<T>(J, wb, m, n, i0, j0, 0, As, Bs, acc);

  const T* Hb = H ? H + (long long)b * h_bs : nullptr;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j >= n) continue;
      T v = acc[r][c];
      if (Hb) v = Hb[(long long)i * n + j] + v;
      if (bnd && i == j) v += bnd[(long long)b * n + i];
      Q[((long long)b * n + i) * n + j] = v;
    }
  }
}

template <typename T>
int launch_fused_q(const void* Jc, long long jc_bs, const void* w,
                   const void* H, long long h_bs, const void* bnd, void* Q,
                   int B, int m, int n, void* stream) {
  const int nt = (n + FQ_TILE - 1) / FQ_TILE;
  dim3 grid(nt, nt, B);
  fused_q_kernel<T><<<grid, FQ_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)Jc, jc_bs, (const T*)w, (const T*)H, h_bs, (const T*)bnd,
      (T*)Q, m, n);
  return (int)cudaGetLastError();
}

}  // namespace onephase
