// Triangle-tiled Q[b] = H[b] + Jc[b]^T diag(w[b]) Jc[b] + diag(bnd[b]):
// the rank-m product is formed for the nt (nt + 1) / 2 lower tile pairs
// (i >= j) only, and each off-diagonal tile is written twice, once at
// (i, j) and once transposed at (j, i).
//
// Replaces the TPU kernel onephase_tpu/ops/schur.py:pallas_fused_q_tri
// (_fused_q_tri_kernel :96-106, grid and index decode :146-178).  That
// version writes a compact (T, tn, tn) tile stack and leaves the block
// scatter, the mirror and the H + diagonal adds to XLA; here one launch
// writes the full symmetric Q.
//
// It is also the Gram half of K3 (ops/cholesky.py:pallas_tri_inv_gram):
// M = Li^T Li with Jc = Li = L^-1 (square, lower triangular), w, H and bnd
// null, in the `lower` mode, where the sum for tile (i, j), i >= j, starts
// at row i0 and skips the exact zeros of Li above it.  That is half the
// work of the full (nt, nt) grid, with the same products summed in the
// same order: IEEE products commute, so the mirrored tile holds the values
// the full grid computed there, and M stays what it was bit for bit.
//
// What bounds it on the H100: plain FP32/FP64 FMA rate, as for the full
// product of fused_q.cuh, on half its work: B m n (n + 1) operations
// against 2 B m n^2 (the Gram product: B n^3 / 3 against 2 B n^3 / 3).
//
// What the simple design does about it: grid (T, B), T = nt (nt + 1) / 2;
// the flat tile index t = i (i + 1) / 2 + j is decoded in integers (the
// Pallas index map needs a closed form and uses an f32 sqrt with fix-ups;
// a block just counts).  The k loop is fq_tile_product of fused_q.cuh, the
// same code as the full kernel.  The epilogue stages the 64 x 64 tile of
// the rank-m part in shared memory (reusing the k loop's buffers, rows
// padded to 65 against bank conflicts) so that the transposed tile is
// stored along rows, coalesced like the direct one.  H need not be
// bit-symmetric: the mirrored tile adds H[j, i], read from its own place.
// On a diagonal tile only the entries on or below the diagonal are kept and
// mirrored within the tile, so the rank-m part of Q is symmetric bit for
// bit ((a w) b and (b w) a round differently, which the full kernel leaves
// as it falls).  The ragged edge is masked, nothing is padded.
#include "fused_q.cuh"

namespace onephase {

constexpr int FQ_LDT = FQ_TILE + 1;   // padded row of the staging tile

template <typename T>
__global__ void __launch_bounds__(FQ_THREADS)
fused_q_tri_kernel(const T* __restrict__ Jc, long long jc_bs,
                   const T* __restrict__ w, const T* __restrict__ H,
                   long long h_bs, const T* __restrict__ bnd,
                   T* __restrict__ Q, int m, int n, int lower) {
  // the k loop's As/Bs (2 x FQ_KC x FQ_TILE) and, after it, the staging
  // tile Ts (FQ_TILE x FQ_LDT) share one buffer
  static_assert(2 * FQ_KC * FQ_TILE <= FQ_TILE * FQ_LDT, "staging tile");
  __shared__ __align__(16) unsigned char raw[sizeof(T) * FQ_TILE * FQ_LDT];
  T (*As)[FQ_TILE] = reinterpret_cast<T (*)[FQ_TILE]>(raw);
  T (*Bs)[FQ_TILE] = As + FQ_KC;
  T (*Ts)[FQ_LDT] = reinterpret_cast<T (*)[FQ_LDT]>(raw);

  const int b = blockIdx.y;
  const int t = blockIdx.x;
  int ti = 0;                       // t = ti (ti + 1) / 2 + tj, tj <= ti
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int i0 = ti * FQ_TILE, j0 = tj * FQ_TILE;
  const bool diag = ti == tj;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* J = Jc + (long long)b * jc_bs;
  const T* wb = w ? w + (long long)b * m : nullptr;

  T acc[4][4];
  fq_tile_product<T>(J, wb, m, n, i0, j0, lower ? i0 : 0, As, Bs, acc);

#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) Ts[ty + 16 * r][tx + 16 * c] = acc[r][c];
  __syncthreads();

  const T* Hb = H ? H + (long long)b * h_bs : nullptr;
  const T* bb = bnd ? bnd + (long long)b * n : nullptr;
  T* Qb = Q + (long long)b * n * n;
  // tile (ti, tj); above the diagonal of a diagonal tile, the mirror of the
  // entry below it
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lr = ty + 16 * r, row = i0 + lr;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int lc = tx + 16 * c, col = j0 + lc;
      if (col >= n) continue;
      T v = (diag && lr < lc) ? Ts[lc][lr] : acc[r][c];
      if (Hb) v = Hb[(long long)row * n + col] + v;
      if (bb && row == col) v += bb[row];
      Qb[(long long)row * n + col] = v;
    }
  }
  if (diag) return;
  // tile (tj, ti) = the transpose, read from the staging tile by columns
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lr = ty + 16 * r, row = j0 + lr;   // always < n: tj < ti
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int lc = tx + 16 * c, col = i0 + lc;
      if (col >= n) continue;
      T v = Ts[lc][lr];
      if (Hb) v = Hb[(long long)row * n + col] + v;
      Qb[(long long)row * n + col] = v;
    }
  }
}

template <typename T>
int launch_fused_q_tri(const void* Jc, long long jc_bs, const void* w,
                       const void* H, long long h_bs, const void* bnd,
                       void* Q, int B, int m, int n, int lower,
                       void* stream) {
  const long long nt = (n + FQ_TILE - 1) / FQ_TILE;
  const long long tiles = nt * (nt + 1) / 2;
  if (B > 65535 || tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, B);
  fused_q_tri_kernel<T><<<grid, FQ_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)Jc, jc_bs, (const T*)w, (const T*)H, h_bs, (const T*)bnd,
      (T*)Q, m, n, lower);
  return (int)cudaGetLastError();
}

}  // namespace onephase

extern "C" int op_fused_q_tri_f32(const void* Jc, long long jc_bs,
                                  const void* w, const void* H,
                                  long long h_bs, const void* bnd, void* Q,
                                  int B, int m, int n, int lower,
                                  void* stream) {
  return onephase::launch_fused_q_tri<float>(Jc, jc_bs, w, H, h_bs, bnd, Q,
                                             B, m, n, lower, stream);
}

extern "C" int op_fused_q_tri_f64(const void* Jc, long long jc_bs,
                                  const void* w, const void* H,
                                  long long h_bs, const void* bnd, void* Q,
                                  int B, int m, int n, int lower,
                                  void* stream) {
  return onephase::launch_fused_q_tri<double>(Jc, jc_bs, w, H, h_bs, bnd, Q,
                                              B, m, n, lower, stream);
}
