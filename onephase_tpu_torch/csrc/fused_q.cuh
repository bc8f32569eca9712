// The tile loop of the triangle-tiled fused Q (fused_q_tri.cu: K6, and in
// its lower mode the Gram half of K3): a 64 x 64 output tile of
// Jc^T diag(w) Jc over the constraint axis k, staged through shared memory.
//
// K1's kernel (fused_q.cu) computes the same values as this loop on and
// below the diagonal, bit for bit (the same products, summed in the same
// order with one FMA a term): a change to either must keep that.
//
// What bounds it on the H100: plain FP32/FP64 FMA rate.  The product does
// 2 m operations per output entry on m n + n^2 elements per instance, far
// above the memory roofline; without tensor cores (full FP32/FP64, no
// TF32) the SM's FMA pipes are the limit.
//
// What the simple design does about it: each block stages k-chunks of the
// Jc columns of its i and j tiles in shared memory (the i side already
// scaled by w), and each of its 256 threads keeps a 4 x 4 block of the tile
// in registers, so every shared-memory value feeds 4 FMAs.  The ragged edge
// is masked, nothing is padded.  A shared (folded-constant) Jc is read with
// batch stride 0.
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

}  // namespace onephase
