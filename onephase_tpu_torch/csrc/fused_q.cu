// Fused Schur formation Q[b] = H[b] + Jc[b]^T diag(w[b]) Jc[b] + diag(bnd[b])
// over the lower tile pairs only, register-tiled and pipelined: the one
// rank-m tile loop of the port, behind three functions.
//
// Replaces the TPU kernels
// - onephase_tpu/ops/schur.py:pallas_fused_q (_fused_q_kernel, :30-47),
//   which tiles the (i, j) output over its grid and reduces the constraint
//   axis k into the output tile, with H and the diagonal added at k = 0;
// - onephase_tpu/ops/schur.py:pallas_fused_q_tri (_fused_q_tri_kernel and
//   its grid and index decode, :96-186), the same function over the lower
//   tile pairs, which writes a compact tile stack and leaves the scatter,
//   the mirror and the H + diagonal adds to XLA; here one launch writes the
//   full symmetric Q, the same launch as for pallas_fused_q;
// - in the `lower` mode, the Gram half of
//   onephase_tpu/ops/cholesky.py:pallas_tri_inv_gram (_tri_inv_gram_kernel,
//   :131-156): M = Li^T Li with Jc = Li = L^-1 square and lower triangular,
//   and w, H and bnd null.  Tile (i, j), i >= j, then starts its k loop at
//   row i0, the first row of its larger index: the rows above hold exact
//   zeros of Li.
//
// What bounds it on the H100: the FP32 FMA rate in IEEE float32 (no
// tensor cores: the reference multiplies at full precision, so no TF32),
// the FP64 tensor cores' in float64 (DMMA, below).  Q - H is
// symmetric, so its n (n + 1) / 2 distinct entries of length m are all the
// work, B m n (n + 1) operations on B n m + B n^2 elements (the Gram
// product: B n^3 / 3): far above the memory roofline at the main path's
// shapes (n = 256..2048, m = n / 2).  What keeps a tile loop fed from
// shared memory off that rate is the shared loads it issues per FMA and
// the wait for each k slab.
//
// What the design does about it:
// - The grid is (T, B) over the T = nt (nt + 1) / 2 lower tile pairs
//   (i >= j) of edge BT, the flat tile index decoded in integers: half the
//   full grid's work.  f32 takes BT = 128 where the lower tiles of all
//   instances give every SM two blocks, else BT = 64 (more, smaller blocks
//   for a card that one wave of 128-tiles would leave half idle); f64
//   chooses the same way.
// - Each thread keeps an RM x RN block of the tile in registers (f32 8 x 8
//   at BT = 128, 4 x 4 at BT = 64), its rows and its columns as
//   groups of 4 read with 16-byte shared loads: at 8 x 8, four loads feed
//   64 FMAs.  A warp's loads of a k row broadcast on the i side and read
//   consecutive 16-byte words on the j side.
// - The k axis runs in 16-row slabs through a ring of three: cp.async
//   copies the next two slabs (16-byte copies where rows and bases are
//   16-byte aligned, else one element each; zero fill past the edge) while
//   the current one is multiplied; one barrier a slab.  Once its own copies
//   have landed, each thread scales the i-side elements it copied by w[k]
//   in place, before that barrier.
// - The epilogue stages the tile in shared memory (rows padded by one) and
//   writes the lower tile from registers, 16 bytes at a time where aligned,
//   and its mirror (j, i) from the staging tile along rows, coalesced.  A
//   shared (folded-constant) Jc or H is read with batch stride 0.
//
// A `matmul_precision` mode (float32 only) takes the tensor cores, in an
// instantiation of its own (fused_q_wg_kernel and fused_q_tc_kernel below,
// mm_tc.cuh): each entry is rounded and split once as it is staged (the i
// side after its scaling by w[k], as the TPU kernel forms `ji * w` before
// its dot), each part pair's products accumulate by wgmma or mma.sync from
// +0, and the pairs are summed smallest first.  What bounds them on the
// H100 is the split and the staging around the products, not the tensor
// cores (operations x products over 495 TFLOP/s TF32, 989 bf16 / fp16:
// 0.07 ms a pass at n = 1024, m = 512, B = 64).  The IEEE float32
// instantiations are unchanged.
//
// Float64 runs on the FP64 tensor cores (fused_q_dmma_kernel below: the
// same grid, slabs, scaling and epilogue, the products by DMMA), its
// values those of the FP64-core loop it replaced.
//
// Value for value: every entry on or below the diagonal is what the earlier
// full-grid kernel computed there, bit for bit: acc = 0; for k = kbeg ..
// m-1 in order, acc = fma(J[k, row] * w[k], J[k, col], acc), the product
// with w rounded first; then H[row, col] + acc; then + bnd[row] on the
// diagonal.  No split k, the FMA explicit.  The ragged k tail is masked,
// not padded with 0 * 0 FMAs (which could only turn a -0 into +0).  Above
// the diagonal Q[row, col] = H[row, col] + acc(col, row), the mirrored
// rank-m part with H read from its own place, so Q - H is symmetric bit for
// bit (the full grid rounded (a w) b there where this has (b w) a: nothing
// on the path reads it, the Cholesky reads the lower triangle and the δ
// search the diagonal).  That upper triangle is, product for product, what
// the earlier triangle-tiled kernel of pallas_fused_q_tri (64-tiles, the
// same sums) wrote there, so both functions keep their full Q.  In the
// `lower` mode kbeg = i0 of this tile, which on a 128-tile can lie up to
// 64 rows before the earlier 64-tile's: the extra terms are exact zeros of
// Li, fma(0, x, +0) = +0 ahead of the first nonzero term, so M keeps its
// bits too (both held by tools/kernel_equal.py against the parent commit).
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "mm_tc.cuh"

namespace {

using onephase::Dmma;

__device__ __forceinline__ float fq_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}

// 16 bytes: 4 floats
__device__ __forceinline__ void ld16(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Four consecutive elements at a 16-byte aligned address.
template <typename T>
__device__ __forceinline__ void ld4(const T* p, T* v) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int h = 0; h < 4; h += E) ld16(p + h, v + h);
}

// Asynchronous copy of BYTES from global to shared memory; `ok` false
// fills the destination with zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int nbytes = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(nbytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(s), "l"(src), "n"(BYTES), "r"(nbytes) : "memory");
}
// The same, BYTES always copied (no zero fill): the interior's copies.
template <int BYTES>
__device__ __forceinline__ void cp_async_all(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], %2;\n"
               :: "r"(s), "l"(src), "n"(BYTES) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

constexpr int KC = 16;   // k rows a slab
constexpr int ST = 3;    // slabs in the ring, ST - 1 of them in flight

// The geometry of one instantiation: tile edge BT, RM x RN outputs a
// thread, VEC: 16-byte copies and stores.
template <typename T, int BT, int RM, int RN, bool VEC>
struct Shape {
  static constexpr int TY = BT / RM;          // thread rows
  static constexpr int TX = BT / RN;          // thread columns
  static constexpr int NT = TX * TY;          // threads
  static constexpr int GM = BT / (RM / 4);    // stride of a thread's row groups
  static constexpr int GN = BT / (RN / 4);    // ... and of its column groups
  static constexpr int E = VEC ? 16 / (int)sizeof(T) : 1;  // elements a copy
  static constexpr int CPR = BT / E;          // copies per slab row
  static constexpr int CPT = KC * CPR / NT;   // copies a thread, per operand
  static constexpr int SLAB = KC * BT;        // elements of one operand slab
  static constexpr int LDT = BT + 1;          // padded row of the staging tile
  // the ring of ST (i side, j side) slabs, then the staging tile, share one
  // buffer
  static constexpr int SMEM =
      (2 * ST * SLAB > BT * LDT ? 2 * ST * SLAB : BT * LDT) * (int)sizeof(T);
  static_assert(RM % 4 == 0 && RN % 4 == 0, "4-wide groups");
  static_assert(KC * CPR % NT == 0, "whole copies per thread");
};

template <typename T, int BT, int RM, int RN, bool VEC, int MINB>
__global__ void __launch_bounds__((BT / RM) * (BT / RN), MINB)
fused_q_lower_kernel(const T* __restrict__ Jc, long long jc_bs,
                     const T* __restrict__ w, const T* __restrict__ H,
                     long long h_bs, const T* __restrict__ bnd,
                     T* __restrict__ Q, int m, int n, int lower) {
  using S = Shape<T, BT, RM, RN, VEC>;
  extern __shared__ __align__(16) unsigned char fq_smem[];
  T* sm = reinterpret_cast<T*>(fq_smem);

  const int b = blockIdx.y;
  const int t = blockIdx.x;
  int ti = 0;                       // t = ti (ti + 1) / 2 + tj, tj <= ti
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int i0 = ti * BT, j0 = tj * BT;
  const bool diag = ti == tj;
  const int tid = threadIdx.x;
  const int tx = tid % S::TX, ty = tid / S::TX;
  const T* J = Jc + (long long)b * jc_bs;
  const T* wb = w ? w + (long long)b * m : nullptr;
  // the k range: all of it, or (Jc lower triangular) from the tile's row i0
  const int kbeg = lower ? i0 : 0;

  // This thread's copies q of a slab: row kk = e / CPR, column c, e = tid +
  // NT q, and wq[q] = w[k0 + kk] (1 past m or without w).  wr[j] holds the
  // w of the slab j ahead of the one being scaled.
  T wr[ST - 1][S::CPT];
  auto issue = [&](int k0, int buf, T (&wq)[S::CPT]) {
    T* As = sm + buf * 2 * S::SLAB;
    T* Bs = As + S::SLAB;
#pragma unroll
    for (int q = 0; q < S::CPT; ++q) {
      const int e = tid + S::NT * q;
      const int kk = e / S::CPR, c = (e % S::CPR) * S::E;
      const int k = k0 + kk;
      const bool kin = k < m;
      const bool iin = kin && i0 + c < n, jin = kin && j0 + c < n;
      const T* row = J + (long long)k * n;
      cp_async<S::E * (int)sizeof(T)>(As + kk * BT + c,
                                      iin ? row + i0 + c : J, iin);
      cp_async<S::E * (int)sizeof(T)>(Bs + kk * BT + c,
                                      jin ? row + j0 + c : J, jin);
      wq[q] = (wb && kin) ? __ldg(wb + k) : T(1);
    }
    cp_async_commit();
  };
  // the i-side elements this thread copied, times w[k], rounded (as
  // `a *= w[k]` was); its copies have landed
  auto scale = [&](int buf, const T (&wq)[S::CPT]) {
    if (!wb) return;
    T* As = sm + buf * 2 * S::SLAB;
#pragma unroll
    for (int q = 0; q < S::CPT; ++q) {
      const int e = tid + S::NT * q;
      const int kk = e / S::CPR, c = (e % S::CPR) * S::E;
#pragma unroll
      for (int u = 0; u < S::E; ++u) As[kk * BT + c + u] *= wq[q];
    }
  };

  T acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = T(0);
  // k row kk of a slab: acc[r][c] = fma(a[r], b[c], acc[r][c]), a the
  // thread's RM scaled i-side entries, b its RN j-side entries
  auto k_step = [&](const T* As, const T* Bs, int kk) {
    T a[RM], bv[RN];
#pragma unroll
    for (int g = 0; g < RM / 4; ++g)
      ld4(As + kk * BT + g * S::GM + 4 * ty, a + 4 * g);
#pragma unroll
    for (int g = 0; g < RN / 4; ++g)
      ld4(Bs + kk * BT + g * S::GN + 4 * tx, bv + 4 * g);
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c)
        acc[r][c] = fq_fma(a[r], bv[c], acc[r][c]);
  };

  // every iteration commits one copy group (empty past the last slab), so
  // the wait counts groups
  const int nslab = m > kbeg ? (m - kbeg + KC - 1) / KC : 0;
#pragma unroll
  for (int p = 0; p < ST - 1; ++p) {
    if (p < nslab) issue(kbeg + p * KC, p, wr[p]);
    else cp_async_commit();
  }
  for (int s = 0; s < nslab; ++s) {
    const int buf = s % ST;
    cp_async_wait<ST - 2>();
    scale(buf, wr[0]);
    // slab s is in place for every thread, and every thread is done with
    // slab s - 1, whose buffer the next copies overwrite
    __syncthreads();
#pragma unroll
    for (int j = 0; j + 1 < ST - 1; ++j)
#pragma unroll
      for (int q = 0; q < S::CPT; ++q) wr[j][q] = wr[j + 1][q];
    const int s2 = s + ST - 1;
    if (s2 < nslab) issue(kbeg + s2 * KC, s2 % ST, wr[ST - 2]);
    else cp_async_commit();
    const T* As = sm + buf * 2 * S::SLAB;
    const T* Bs = As + S::SLAB;
    const int kc = m - kbeg - s * KC;
    if (kc >= KC) {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) k_step(As, Bs, kk);
    } else {
      for (int kk = 0; kk < kc; ++kk) k_step(As, Bs, kk);
    }
  }
  __syncthreads();   // the last slab read before the staging tile reuses it

  // tile row of acc[r][.] and tile column of acc[.][c]
  auto lrow = [&](int r) { return (r / 4) * S::GM + 4 * ty + r % 4; };
  auto lcol = [&](int c) { return (c / 4) * S::GN + 4 * tx + c % 4; };
  T* Ts = sm;
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) Ts[lrow(r) * S::LDT + lcol(c)] = acc[r][c];
  __syncthreads();

  const T* Hb = H ? H + (long long)b * h_bs : nullptr;
  const T* bb = bnd ? bnd + (long long)b * n : nullptr;
  T* Qb = Q + (long long)b * n * n;
  // tile (ti, tj), 4 columns at a time; above the diagonal of a diagonal
  // tile, the mirror of the entry below it
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int lr = lrow(r), row = i0 + lr;
    if (row >= n) continue;
#pragma unroll
    for (int g = 0; g < RN / 4; ++g) {
      const int lc0 = g * S::GN + 4 * tx, col0 = j0 + lc0;
      if (col0 >= n) continue;
      const long long o = (long long)row * n + col0;
      T v[4], h[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = (diag && lr < lc0 + u) ? Ts[(lc0 + u) * S::LDT + lr]
                                      : acc[r][4 * g + u];
      if (VEC) {
        if (Hb) {
#pragma unroll
          for (int e = 0; e < 4; e += S::E)
            if (col0 + e < n) ld16(Hb + o + e, h + e);
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = h[u] + v[u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (bb && row == col0 + u) v[u] += bb[row];
#pragma unroll
        for (int e = 0; e < 4; e += S::E)
          if (col0 + e < n) st16(Qb + o + e, v + e);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (col0 + u >= n) continue;
          T x = v[u];
          if (Hb) x = Hb[o + u] + x;
          if (bb && row == col0 + u) x += bb[row];
          Qb[o + u] = x;
        }
      }
    }
  }
  if (diag) return;
  // tile (tj, ti): the transpose, read from the staging tile by columns and
  // stored along rows (unrolled, so that many loads of H are in flight);
  // its rows j0 + lr are < n (tj < ti)
#pragma unroll 16
  for (int e = tid; e < BT * BT; e += S::NT) {
    const int lr = e / BT, lc = e % BT, col = i0 + lc;
    if (col >= n) continue;
    const long long o = (long long)(j0 + lr) * n + col;
    T v = Ts[lc * S::LDT + lr];
    if (Hb) v = Hb[o] + v;
    Qb[o] = v;
  }
}

template <typename T, int BT, int RM, int RN, bool VEC, int MINB>
int launch_shape(const void* Jc, long long jc_bs, const void* w,
                 const void* H, long long h_bs, const void* bnd, void* Q,
                 int B, int m, int n, int lower, void* stream) {
  using S = Shape<T, BT, RM, RN, VEC>;
  const auto kernel = fused_q_lower_kernel<T, BT, RM, RN, VEC, MINB>;
  const long long nt = (n + BT - 1) / BT;
  const long long tiles = nt * (nt + 1) / 2;
  if (B > 65535 || tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = onephase::smem_once(kernel, S::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)tiles, B), S::NT, S::SMEM, (cudaStream_t)stream>>>(
      (const T*)Jc, jc_bs, (const T*)w, (const T*)H, h_bs, (const T*)bnd,
      (T*)Q, m, n, lower);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The matmul modes on the tensor cores (mm_tc.cuh), float32 only: one
// instantiation a mode, KIND (1 TF32, 2 bf16, 3 fp16) and PASSES (1, 3, 6
// or 9 part products), on two routes that share the grid, the tile
// decode, `lower`, the copies (copy_slab), the split and the staged
// epilogue (store_tile):
// - cp.async copies each KC-row slab of both sides (16 bytes where rows
//   and bases allow, else one element; zero fill past the edges) and of w
//   into a ring of ST raw slabs, ST - 1 ahead of the one being split;
// - each thread then scales its i-side entries by w[k] (as the TPU kernel
//   forms `ji * w` before its dot), rounds and splits every entry once
//   into the mode's parts and stores them, one plane a part, 16 bytes a
//   store; the planes are double-buffered, so one barrier a slab suffices,
//   and slab s is split while slab s - 1 is multiplied;
// - one accumulator a part pair, started at +0; the pairs summed smallest
//   first (Mode.pairs), then H and bnd added as in the IEEE epilogue.
// The one-pass and 3-product sets take wgmma on 128-tiles
// (fused_q_wg_kernel): two warpgroups of 64 x 128, the tensor cores
// reading the planes from shared memory, asynchronously, while the next
// slab is split (64 accumulator registers a pair: two blocks an SM at one
// pass, one at three).  The 6- and 9-product sets, whose accumulators a
// 128-tile cannot hold, take mma.sync on 64-tiles (fused_q_tc_kernel):
// eight warps of 32 x 16 (16 registers a pair: 144 at nine), the planes in
// fragment order (unit_at below), 16-byte fragment loads.
template <int KIND, int PASSES>
struct TcShape {
  static_assert(KIND != 1, "the 6- and 9-product sets are 16-bit");
  using Sx = typename onephase::Tc<KIND>::S;
  static constexpr int PARTS = onephase::mode_parts(PASSES);
  static constexpr int BT = 64;
  static constexpr int NT = 256;                   // threads: 8 warps, 2 x 4
  static constexpr int WM = BT / 2, WN = BT / 4;   // a warp's block
  static constexpr int MT = WM / 16, NT8 = WN / 8; // its m16 and n8 tiles
  static constexpr int KC = 32;                    // k rows a slab
  static constexpr int ST = 3;                     // raw slabs in the ring
  static constexpr int KSTEPS = KC / onephase::Tc<KIND>::K;
  // a raw row: BT entries and a pad that puts the rows a fragment spans on
  // distinct banks (k + 2 t: 4 words)
  static constexpr int LDR = BT + 4;
  static constexpr int RAW = 2 * KC * LDR + KC;    // both sides, then w
  static constexpr int E = 16 / (int)sizeof(Sx);   // elements a 16-byte unit
  static constexpr int UNITS = KC * BT / E;        // units of a side's plane
  static constexpr int UPT = 2 * UNITS / NT;       // units a thread
  static constexpr int CPT = 2 * KC * BT / 4 / NT; // 16-byte copies a thread
  static constexpr int PLANE = KC * BT;            // elements of a plane
  static constexpr int LDT = BT + 1;               // the staging tile's row
  static constexpr int RING = ST * RAW * 4;        // bytes
  static constexpr int PLANES = 2 * 2 * PARTS * PLANE * (int)sizeof(Sx);
  static constexpr int SMEM = RING + PLANES > BT * LDT * 4
                                  ? RING + PLANES : BT * LDT * 4;
  static_assert(2 * UNITS % NT == 0 && (UNITS % NT == 0 || UPT == 1),
                "whole units per thread, one side a unit slot");
  static_assert(NT8 % 2 == 0, "B fragments load in pairs of n8 tiles");
  static_assert(2 * KC * BT % (4 * NT) == 0, "whole copies per thread");
};

// Copy the slab of rows k0 .. k0 + KC of both sides (columns from i0 and
// from j0) and of w into a raw ring slot: side s's row kk at raw + (s KC +
// kk) LDR, w after both; 16 bytes a copy where `vec` (whole 16-byte row
// segments and an aligned Jc), else one element; zero fill past the edges.
// One copy group.
template <int BT, int KC, int LDR, int NT>
__device__ __forceinline__ void copy_slab(float* raw, const float* J,
                                          const float* wb, int k0, int m,
                                          int n, int i0, int j0, int vec,
                                          int tid) {
  if (vec) {
    const float* Jk = J + (long long)k0 * n;
#pragma unroll
    for (int q = 0; q < 2 * KC * BT / 4 / NT; ++q) {
      // copy x = tid + NT q: side x / (KC BT / 4), row kk, column c
      const int x = tid + NT * q;
      const int side = x / (KC * BT / 4), r = x % (KC * BT / 4);
      const int kk = r / (BT / 4), c = (r % (BT / 4)) * 4;
      const int col = (side ? j0 : i0) + c;
      float* dst = raw + side * KC * LDR + kk * LDR + c;
      if (k0 + kk < m && col < n)
        cp_async_all<16>(dst, Jk + (long long)kk * n + col);
      else
        cp_async<16>(dst, J, false);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < 2 * KC * BT / NT; ++q) {
      const int x = tid + NT * q;
      const int side = x / (KC * BT), r = x % (KC * BT);
      const int kk = r / BT, c = r % BT;
      const int col = (side ? j0 : i0) + c;
      const bool ok = k0 + kk < m && col < n;
      cp_async<4>(raw + side * KC * LDR + kk * LDR + c,
                  ok ? J + (long long)(k0 + kk) * n + col : J, ok);
    }
  }
  if (wb && tid < KC) {
    const bool ok = k0 + tid < m;
    cp_async<4>(raw + 2 * KC * LDR + tid, ok ? wb + k0 + tid : wb, ok);
  }
  cp_async_commit();
}

// Q's tile (ti, tj) of edge BT from the staging tile Ts (leading dimension
// BT + 1), along rows, with H added from its own place and bnd on the
// diagonal: above the diagonal of a diagonal tile the mirror of the entry
// below it; off the diagonal also the mirror tile (tj, ti), whose rows
// j0 + lr are < n (tj < ti).  Every thread of the block, NT of them.
template <int BT, int NT, typename T>
__device__ __forceinline__ void store_tile(const T* Ts, const T* Hb,
                                           const T* bb, T* Qb, int n, int i0,
                                           int j0, bool diag, int tid) {
  constexpr int LDT = BT + 1;
#pragma unroll 4
  for (int e = tid; e < BT * BT; e += NT) {
    const int lr = e / BT, lc = e % BT;
    const int row = i0 + lr, col = j0 + lc;
    if (row < n && col < n) {
      T v = (diag && lr < lc) ? Ts[lc * LDT + lr] : Ts[lr * LDT + lc];
      const long long o = (long long)row * n + col;
      if (Hb) v = Hb[o] + v;
      if (bb && row == col) v += bb[row];
      Qb[o] = v;
    }
    if (!diag && i0 + lc < n) {
      const long long o = (long long)(j0 + lr) * n + i0 + lc;
      T v = Ts[lc * LDT + lr];
      if (Hb) v = Hb[o] + v;
      Qb[o] = v;
    }
  }
}

// The mma.sync route's planes, in fragment order (16-bit parts: bf16 or
// fp16, m16n8k16).  A 16-byte unit is one lane's fragment: on the A side
// (rows of the product) a0..a7 of m16 tile mt at k step ks, unit
// (ks * BT / 16 + mt) * 32 + lane; on the B side (columns) b0..b3 of the
// n8 tiles 2 np and 2 np + 1, unit (ks * BT / 16 + np) * 32 + lane.  A
// warp reads 32 consecutive units: no bank conflicts.  unit_at gives
// element 0's (k within the slab, row or column within the tile);
// unit_dk / unit_di the offsets of element e from it (the same unit
// index on both sides: the two layouts differ in the elements' order).
template <int BT>
__device__ __forceinline__ void unit_at(int u, int& k, int& i) {
  const int lane = u & 31, rest = u >> 5;
  i = (rest % (BT / 16)) * 16 + (lane >> 2);
  k = (rest / (BT / 16)) * 16 + 2 * (lane & 3);
}
__device__ __forceinline__ int unit_dk(bool bside, int e) {
  return bside ? (e & 1) + 8 * ((e >> 1) & 1) : (e & 1) + 8 * (e >> 2);
}
__device__ __forceinline__ int unit_di(bool bside, int e) {
  return bside ? 8 * (e >> 2) : 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ void frag_ld(const unsigned short* plane, int unit,
                                        uint32_t (&r)[4]) {
  const uint4 v = reinterpret_cast<const uint4*>(plane)[unit];
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

template <int KIND, int PASSES>
__global__ void __launch_bounds__(256, 1)
fused_q_tc_kernel(const float* __restrict__ Jc, long long jc_bs,
                  const float* __restrict__ w, const float* __restrict__ H,
                  long long h_bs, const float* __restrict__ bnd,
                  float* __restrict__ Q, int m, int n, int lower, int vec) {
  using G = TcShape<KIND, PASSES>;
  using Sx = typename G::Sx;
  using TC = onephase::Tc<KIND>;
  constexpr int BT = G::BT, PARTS = G::PARTS, E = G::E, KC = G::KC;
  constexpr int ST = G::ST, LDR = G::LDR;
  extern __shared__ __align__(16) unsigned char fq_smem[];
  float* ring = reinterpret_cast<float*>(fq_smem);
  Sx* planes = reinterpret_cast<Sx*>(fq_smem + G::RING);
  // plane (buffer, side 0 = i / 1 = j, part)
  auto plane = [&](int buf, int side, int part) {
    return planes + ((buf * 2 + side) * PARTS + part) * G::PLANE;
  };

  const int b = blockIdx.y;
  const int t = blockIdx.x;
  int ti = 0;                       // t = ti (ti + 1) / 2 + tj, tj <= ti
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int i0 = ti * BT, j0 = tj * BT;
  const bool diag = ti == tj;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const float* J = Jc + (long long)b * jc_bs;
  const float* wb = w ? w + (long long)b * m : nullptr;
  const int kbeg = lower ? i0 : 0;

  // the slab of rows k0 .. k0 + KC into ring slot `slot`
  auto issue = [&](int k0, int slot) {
    copy_slab<BT, KC, LDR, G::NT>(ring + slot * G::RAW, J, wb, k0, m, n, i0,
                                  j0, vec, tid);
  };

  // this thread's units x = tid + NT q, side x / UNITS: the raw offset of
  // element 0 of each (its k and row or column in the slab)
  int base[G::UPT], kbase[G::UPT];
#pragma unroll
  for (int q = 0; q < G::UPT; ++q) {
    const int x = tid + G::NT * q, side = x / G::UNITS, u = x % G::UNITS;
    int k, i;
    unit_at<BT>(u, k, i);
    base[q] = side * KC * LDR + k * LDR + i;
    kbase[q] = k;
  }
  // scale, round and split raw slot `slot` into the planes of `buf`
  auto split = [&](int slot, int buf) {
    const float* raw = ring + slot * G::RAW;
    const float* wk = raw + 2 * KC * LDR;
#pragma unroll
    for (int q = 0; q < G::UPT; ++q) {
      const int x = tid + G::NT * q, side = x / G::UNITS, u = x % G::UNITS;
      Sx pv[PARTS][E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int dk = unit_dk(side, e);
        float v = raw[base[q] + dk * LDR + unit_di(side, e)];
        if (!side && wb) v *= wk[kbase[q] + dk];
        Sx p[PARTS];
        onephase::tc_split<KIND, PARTS>(v, p);
#pragma unroll
        for (int r = 0; r < PARTS; ++r) pv[r][e] = p[r];
      }
#pragma unroll
      for (int r = 0; r < PARTS; ++r)
        reinterpret_cast<uint4*>(plane(buf, side, r))[u] =
            onephase::pack16(pv[r]);
    }
  };

  float acc[PASSES][G::MT][G::NT8][4];
#pragma unroll
  for (int q = 0; q < PASSES; ++q)
#pragma unroll
    for (int a = 0; a < G::MT; ++a)
#pragma unroll
      for (int c = 0; c < G::NT8; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[q][a][c][r] = 0.0f;
  // the slab in `buf`: pair q = (i, j) takes A part i and B part j
  auto multiply = [&](int buf) {
#pragma unroll
    for (int ks = 0; ks < G::KSTEPS; ++ks) {
      uint32_t bf[PARTS][G::NT8 / 2][4];
#pragma unroll
      for (int r = 0; r < PARTS; ++r)
#pragma unroll
        for (int np = 0; np < G::NT8 / 2; ++np)
          frag_ld(plane(buf, 1, r),
                  (ks * (BT / 16) + wn * (G::NT8 / 2) + np) * 32 + lane,
                  bf[r][np]);
#pragma unroll
      for (int ip = 0; ip < PARTS; ++ip) {
        uint32_t af[G::MT][4];
#pragma unroll
        for (int a = 0; a < G::MT; ++a)
          frag_ld(plane(buf, 0, ip),
                  (ks * (BT / 16) + wm * G::MT + a) * 32 + lane, af[a]);
#pragma unroll
        for (int q = 0; q < PASSES; ++q) {
          if (onephase::pair_i(9 - PASSES + q) != ip) continue;
          const int jp = onephase::pair_j(9 - PASSES + q);
#pragma unroll
          for (int a = 0; a < G::MT; ++a)
#pragma unroll
            for (int c = 0; c < G::NT8; ++c)
              TC::mma(acc[q][a][c], af[a], &bf[jp][c / 2][2 * (c % 2)]);
        }
      }
    }
  };

  // every iteration commits one copy group (empty past the last slab), so
  // the waits count groups
  const int nslab = m > kbeg ? (m - kbeg + KC - 1) / KC : 0;
#pragma unroll
  for (int p = 0; p < ST - 1; ++p) {
    if (p < nslab) issue(kbeg + p * KC, p);
    else cp_async_commit();
  }
  cp_async_wait<ST - 2>();
  __syncthreads();
#pragma unroll 1
  for (int s = 0; s < nslab; ++s) {
    // slot (s - 1) % ST was split before the last barrier
    const int s2 = s + ST - 1;
    if (s2 < nslab) issue(kbeg + s2 * KC, s2 % ST);
    else cp_async_commit();
    // the planes of slab s - 1 were stored before the last barrier; those
    // of s - 2 (the buffer split into below) were read before it.  The
    // split's loads and arithmetic interleave with these products
    if (s > 0) multiply((s - 1) & 1);
    split(s % ST, s & 1);
    cp_async_wait<ST - 2>();   // slab s + 1 has landed
    __syncthreads();
  }
  if (nslab > 0) multiply((nslab - 1) & 1);
  cp_async_wait<0>();
  __syncthreads();   // every plane read before the staging tile reuses them

  // the pairs summed smallest first, staged in shared memory (the ring and
  // the planes are done with), then the tile and its mirror from there
  float* Ts = reinterpret_cast<float*>(fq_smem);
#pragma unroll
  for (int a = 0; a < G::MT; ++a)
#pragma unroll
    for (int c = 0; c < G::NT8; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float v = acc[0][a][c][r];
#pragma unroll
        for (int q = 1; q < PASSES; ++q) v = v + acc[q][a][c][r];
        const int lr = wm * G::WM + a * 16 + (lane >> 2) + 8 * (r >> 1);
        const int lc = wn * G::WN + c * 8 + 2 * (lane & 3) + (r & 1);
        Ts[lr * G::LDT + lc] = v;
      }
  __syncthreads();
  store_tile<BT, G::NT>(Ts, H ? H + (long long)b * h_bs : nullptr,
                        bnd ? bnd + (long long)b * n : nullptr,
                        Q + (long long)b * n * n, n, i0, j0, diag, tid);
}

// The wgmma route (see above).  The planes are K-major core matrices:
// 16-byte unit u = kc BT + i holds row i's entries kc E .. kc E + E - 1
// (E = 4 TF32, 8 16-bit), so a descriptor's 8-row groups lie SBO = 128
// bytes apart and its K chunks LBO = 16 x 128 bytes apart; the split's
// reads of a raw slab and its 16-byte stores are conflict-free.
template <int KIND, int PASSES>
struct WgShape {
  using Sx = typename onephase::Tc<KIND>::S;
  static constexpr int PARTS = onephase::mode_parts(PASSES);
  static constexpr int BT = 128, NT = 256, KC = 16;
  static constexpr int MINB = PASSES == 1 ? 2 : 1;
  static constexpr int ST = 4;                     // raw slabs in the ring
  static constexpr int KSTEPS = KC / onephase::Wg<KIND>::K;
  static constexpr int LDR = BT + 4;               // a raw row
  static constexpr int RAW = 2 * KC * LDR + KC;    // both sides, then w
  static constexpr int E = 16 / (int)sizeof(Sx);   // elements a unit
  static constexpr int UNITS = KC * BT / E;        // 16-byte units a plane
  static constexpr int UPT = 2 * UNITS / NT;       // units a thread
  static constexpr int CPT = 2 * KC * BT / 4 / NT; // 16-byte copies a thread
  static constexpr int PLANE = KC * BT;            // elements of a plane
  static constexpr int LBO = 16 * 128, SBO = 128;  // bytes
  static constexpr int LDT = BT + 1;               // the staging tile's row
  static constexpr int RING = ST * RAW * 4;
  static constexpr int PLANES = 2 * 2 * PARTS * PLANE * (int)sizeof(Sx);
  static constexpr int SMEM = RING + PLANES > BT * LDT * 4
                                  ? RING + PLANES : BT * LDT * 4;
  static_assert(2 * UNITS % NT == 0 && UNITS % NT == 0, "whole units");
  static_assert(RING % 128 == 0, "planes 128-byte aligned");
};

template <int KIND, int PASSES>
__global__ void __launch_bounds__(256, WgShape<KIND, PASSES>::MINB)
fused_q_wg_kernel(const float* __restrict__ Jc, long long jc_bs,
                  const float* __restrict__ w, const float* __restrict__ H,
                  long long h_bs, const float* __restrict__ bnd,
                  float* __restrict__ Q, int m, int n, int lower, int vec) {
  using G = WgShape<KIND, PASSES>;
  using Sx = typename G::Sx;
  using WG = onephase::Wg<KIND>;
  constexpr int BT = G::BT, PARTS = G::PARTS, E = G::E, KC = G::KC;
  constexpr int ST = G::ST, LDR = G::LDR;
  extern __shared__ __align__(16) unsigned char fq_smem[];
  float* ring = reinterpret_cast<float*>(fq_smem);
  Sx* planes = reinterpret_cast<Sx*>(fq_smem + G::RING);
  auto plane = [&](int buf, int side, int part) {
    return planes + ((buf * 2 + side) * PARTS + part) * G::PLANE;
  };

  const int b = blockIdx.y;
  const int t = blockIdx.x;
  int ti = 0;                       // t = ti (ti + 1) / 2 + tj, tj <= ti
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int i0 = ti * BT, j0 = tj * BT;
  const bool diag = ti == tj;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w4 = warp & 3;
  const float* J = Jc + (long long)b * jc_bs;
  const float* wb = w ? w + (long long)b * m : nullptr;
  const int kbeg = lower ? i0 : 0;

  auto issue = [&](int k0, int slot) {
    copy_slab<BT, KC, LDR, G::NT>(ring + slot * G::RAW, J, wb, k0, m, n, i0,
                                  j0, vec, tid);
  };

  // unit x = tid + NT q: side x / UNITS, row i = u % BT, K chunk u / BT
  auto split = [&](int slot, int buf) {
    const float* raw = ring + slot * G::RAW;
    const float* wk = raw + 2 * KC * LDR;
#pragma unroll
    for (int q = 0; q < G::UPT; ++q) {
      const int x = tid + G::NT * q, side = x / G::UNITS, u = x % G::UNITS;
      const int i = u % BT, k = (u / BT) * E;
      const float* src = raw + side * KC * LDR + k * LDR + i;
      Sx pv[PARTS][E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float v = src[e * LDR];
        if (!side && wb) v *= wk[k + e];
        Sx p[PARTS];
        onephase::tc_split<KIND, PARTS>(v, p);
#pragma unroll
        for (int r = 0; r < PARTS; ++r) pv[r][e] = p[r];
      }
#pragma unroll
      for (int r = 0; r < PARTS; ++r)
        reinterpret_cast<uint4*>(plane(buf, side, r))[u] =
            onephase::pack16(pv[r]);
    }
    onephase::fence_async_shared();
  };

  float acc[PASSES][64];
#pragma unroll
  for (int q = 0; q < PASSES; ++q)
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[q][r] = 0.0f;
  // issue the slab in `buf`: pair q = (i, j) takes A part i (this
  // warpgroup's 64 rows) and B part j (all 128 columns)
  auto multiply = [&](int buf) {
    onephase::wg_fence();
#pragma unroll
    for (int ks = 0; ks < G::KSTEPS; ++ks)
#pragma unroll
      for (int q = 0; q < PASSES; ++q) {
        const int ip = onephase::pair_i(9 - PASSES + q);
        const int jp = onephase::pair_j(9 - PASSES + q);
        // K chunk 2 ks; this warpgroup's 8-row groups from 8 wg
        const Sx* a = plane(buf, 0, ip) + (2 * ks * BT + 64 * wg) * E;
        const Sx* bm = plane(buf, 1, jp) + 2 * ks * BT * E;
        WG::mma(acc[q], onephase::wg_desc(a, G::LBO, G::SBO),
                onephase::wg_desc(bm, G::LBO, G::SBO));
      }
    onephase::wg_commit();
  };

  const int nslab = m > kbeg ? (m - kbeg + KC - 1) / KC : 0;
#pragma unroll
  for (int p = 0; p < ST - 1; ++p) {
    if (p < nslab) issue(kbeg + p * KC, p);
    else cp_async_commit();
  }
  cp_async_wait<ST - 2>();
  __syncthreads();
#pragma unroll 1
  for (int s = 0; s < nslab; ++s) {
    const int s2 = s + ST - 1;
    if (s2 < nslab) issue(kbeg + s2 * KC, s2 % ST);
    else cp_async_commit();
    // the products of slab s - 1 run while slab s is split into the other
    // buffer, whose products (slab s - 2) were waited for before the last
    // barrier
    if (s > 0) multiply((s - 1) & 1);
    split(s % ST, s & 1);
    onephase::wg_wait<0>();
    cp_async_wait<ST - 2>();   // slab s + 1 has landed
    __syncthreads();
  }
  if (nslab > 0) {
    multiply((nslab - 1) & 1);
    onephase::wg_wait<0>();
  }
  cp_async_wait<0>();
  __syncthreads();   // every plane read before the staging tile reuses them

  // the pairs summed smallest first, staged in shared memory, then the
  // tile and its mirror from there (straight-line code between the last
  // product and the staging: stores to Q from the accumulators crashed
  // ptxas)
  float* Ts = reinterpret_cast<float*>(fq_smem);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = acc[0][4 * j + r];
#pragma unroll
      for (int q = 1; q < PASSES; ++q) v = v + acc[q][4 * j + r];
      const int lr = 64 * wg + 16 * w4 + (lane >> 2) + 8 * (r >> 1);
      const int lc = 8 * j + 2 * (lane & 3) + (r & 1);
      Ts[lr * G::LDT + lc] = v;
    }
  __syncthreads();
  store_tile<BT, G::NT>(Ts, H ? H + (long long)b * h_bs : nullptr,
                        bnd ? bnd + (long long)b * n : nullptr,
                        Q + (long long)b * n * n, n, i0, j0, diag, tid);
}

template <int KIND, int PASSES>
int launch_wg(const void* Jc, long long jc_bs, const void* w, const void* H,
              long long h_bs, const void* bnd, void* Q, int B, int m, int n,
              int lower, int vec, void* stream) {
  using G = WgShape<KIND, PASSES>;
  const auto kernel = fused_q_wg_kernel<KIND, PASSES>;
  const long long nt = (n + G::BT - 1) / G::BT;
  const long long tiles = nt * (nt + 1) / 2;
  if (B > 65535 || tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = onephase::smem_once(kernel, G::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)tiles, B), G::NT, G::SMEM, (cudaStream_t)stream>>>(
      (const float*)Jc, jc_bs, (const float*)w, (const float*)H, h_bs,
      (const float*)bnd, (float*)Q, m, n, lower, vec);
  return (int)cudaGetLastError();
}

template <int KIND, int PASSES>
int launch_tc(const void* Jc, long long jc_bs, const void* w, const void* H,
              long long h_bs, const void* bnd, void* Q, int B, int m, int n,
              int lower, int vec, void* stream) {
  using G = TcShape<KIND, PASSES>;
  const auto kernel = fused_q_tc_kernel<KIND, PASSES>;
  const long long nt = (n + G::BT - 1) / G::BT;
  const long long tiles = nt * (nt + 1) / 2;
  if (B > 65535 || tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = onephase::smem_once(kernel, G::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)tiles, B), G::NT, G::SMEM, (cudaStream_t)stream>>>(
      (const float*)Jc, jc_bs, (const float*)w, (const float*)H, h_bs,
      (const float*)bnd, (float*)Q, m, n, lower, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// float64 on the FP64 tensor cores (DMMA), the one float64 route:
// mma.sync.aligned.m16n8k8.row.col.f64 (Hopper's f64 shape; 2 x 16 x 8 x 8
// operations an instruction), on the IEEE route's grid, tile decode,
// `lower` mode, cp.async ring of KC-row slabs with the i side scaled by
// w[k] in place before the slab's barrier, and staged epilogue
// (store_tile: the mirror, H from its own place, bnd on the diagonal).
// What is new:
// - a slab row is padded to BT + 4 doubles, so that the fragment loads,
//   8-byte loads at (k row t + 4 i, column g) over g = lane / 4 and
//   t = lane % 4, fall on distinct banks in each half-warp (4 t + g is
//   distinct mod 16); ldmatrix serves no 8-byte elements;
// - warps tile the output: 128-tiles (where B x tiles fills the card, as
//   the float32 route decides) take 16 warps, 64-tiles 4, each warp a
//   32 x 32 block of m16n8 accumulators (4 doubles a lane each) updated
//   by one mma per k8 step and tile;
// - a slab row's copies are one thread's (KC rows, NT / KC threads a
//   row), so each thread scales by one w[k] a slab, held in a register
//   from its copy's issue.
// Value for value: each accumulator starts at +0, and on the H100 an
// f64 mma's result is the FP64 cores' fma chain over its k, ascending
// (tools/dmma_probe.py), so every entry is the earlier FP64-core kernel's
// chain acc = fma(J[k, row] w[k], J[k, col], acc) bit for bit
// (tools/kernel_equal.py against that kernel: 0 differing cases).  Past m
// and past n the slabs are zero filled (fma(0, 0, acc) could only turn a
// -0 sum into +0).  The mma is mm_tc.cuh's Dmma, shared with K2's float64
// trailing update (chol.cu).
template <int BT, int WGM, int WGN, bool VEC>
struct DmShape {
  static constexpr int NT = 32 * WGM * WGN;        // threads
  static constexpr int WM = BT / WGM, WN = BT / WGN;   // a warp's block
  static constexpr int MT = WM / 16, NT8 = WN / 8;     // its m16, n8 tiles
  static constexpr int LDS = BT + 4;               // a slab row (doubles)
  static constexpr int SLAB = KC * LDS;            // one side's slab
  static constexpr int E = VEC ? 2 : 1;            // doubles a copy
  static constexpr int TPR = NT / KC;              // threads a slab row
  static constexpr int CPT = BT / E / TPR;         // copies a thread, a side
  static constexpr int LDT = BT + 1;               // the staging tile's row
  static constexpr int SMEM =
      (2 * ST * SLAB > BT * LDT ? 2 * ST * SLAB : BT * LDT) * 8;
  static_assert(NT % KC == 0 && BT / E % TPR == 0, "whole copies a row");
  static_assert(KC % Dmma::K == 0 && WM % 16 == 0 && WN % 8 == 0, "tiles");
};

template <int BT, int WGM, int WGN, bool VEC, int MINB>
__global__ void __launch_bounds__(32 * WGM * WGN, MINB)
fused_q_dmma_kernel(const double* __restrict__ Jc, long long jc_bs,
                    const double* __restrict__ w,
                    const double* __restrict__ H, long long h_bs,
                    const double* __restrict__ bnd, double* __restrict__ Q,
                    int m, int n, int lower) {
  using G = DmShape<BT, WGM, WGN, VEC>;
  constexpr int LDS = G::LDS;
  extern __shared__ __align__(16) unsigned char fq_smem[];
  double* sm = reinterpret_cast<double*>(fq_smem);

  const int b = blockIdx.y;
  const int t = blockIdx.x;
  int ti = 0;                       // t = ti (ti + 1) / 2 + tj, tj <= ti
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int i0 = ti * BT, j0 = tj * BT;
  const bool diag = ti == tj;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WGN, wn = warp % WGN;
  const int g = lane >> 2, t4 = lane & 3;
  const double* J = Jc + (long long)b * jc_bs;
  const double* wb = w ? w + (long long)b * m : nullptr;
  const int kbeg = lower ? i0 : 0;

  // This thread's copies q of a slab: row kk, columns c = (tid % TPR +
  // TPR q) E (a row's TPR threads read consecutive 8- or 16-byte words);
  // wk = w[k0 + kk] (1 past m or without w)
  const int kk = tid / G::TPR, cq = tid % G::TPR;
  double wr[ST - 1];
  auto issue = [&](int k0, int buf, double& wk) {
    double* As = sm + buf * 2 * G::SLAB + kk * LDS;
    double* Bs = As + G::SLAB;
    const int k = k0 + kk;
    const bool kin = k < m;
    const double* row = J + (long long)k * n;
#pragma unroll
    for (int q = 0; q < G::CPT; ++q) {
      const int c = (cq + G::TPR * q) * G::E;
      const bool iin = kin && i0 + c < n, jin = kin && j0 + c < n;
      cp_async<G::E * 8>(As + c, iin ? row + i0 + c : J, iin);
      cp_async<G::E * 8>(Bs + c, jin ? row + j0 + c : J, jin);
    }
    wk = (wb && kin) ? __ldg(wb + k) : 1.0;
    cp_async_commit();
  };
  // the i-side elements this thread copied, times w[k], rounded; its
  // copies have landed
  auto scale = [&](int buf, double wk) {
    if (!wb) return;
    double* As = sm + buf * 2 * G::SLAB + kk * LDS;
#pragma unroll
    for (int q = 0; q < G::CPT; ++q)
#pragma unroll
      for (int u = 0; u < G::E; ++u) As[(cq + G::TPR * q) * G::E + u] *= wk;
  };

  double acc[G::MT][G::NT8][4];
#pragma unroll
  for (int a = 0; a < G::MT; ++a)
#pragma unroll
    for (int c = 0; c < G::NT8; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][c][r] = 0.0;
  // the slab: this warp's rows wm WM .., columns wn WN ..
  auto multiply = [&](const double* As, const double* Bs) {
    const double* Aw = As + wm * G::WM + g;
    const double* Bw = Bs + wn * G::WN + g;
#pragma unroll
    for (int ks = 0; ks < KC; ks += Dmma::K) {
      double af[G::MT][4], bf[G::NT8][2];
#pragma unroll
      for (int a = 0; a < G::MT; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          af[a][i] = Aw[(ks + t4 + 4 * (i / 2)) * LDS + 16 * a + 8 * (i % 2)];
#pragma unroll
      for (int c = 0; c < G::NT8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          bf[c][i] = Bw[(ks + t4 + 4 * i) * LDS + 8 * c];
#pragma unroll
      for (int a = 0; a < G::MT; ++a)
#pragma unroll
        for (int c = 0; c < G::NT8; ++c) Dmma::mma(acc[a][c], af[a], bf[c]);
    }
  };

  // every iteration commits one copy group (empty past the last slab), so
  // the wait counts groups
  const int nslab = m > kbeg ? (m - kbeg + KC - 1) / KC : 0;
#pragma unroll
  for (int p = 0; p < ST - 1; ++p) {
    if (p < nslab) issue(kbeg + p * KC, p, wr[p]);
    else cp_async_commit();
  }
  for (int s = 0; s < nslab; ++s) {
    const int buf = s % ST;
    cp_async_wait<ST - 2>();
    scale(buf, wr[0]);
    // slab s is in place for every thread, and every thread is done with
    // slab s - 1, whose buffer the next copies overwrite
    __syncthreads();
#pragma unroll
    for (int j = 0; j + 1 < ST - 1; ++j) wr[j] = wr[j + 1];
    const int s2 = s + ST - 1;
    if (s2 < nslab) issue(kbeg + s2 * KC, s2 % ST, wr[ST - 2]);
    else cp_async_commit();
    const double* As = sm + buf * 2 * G::SLAB;
    multiply(As, As + G::SLAB);
  }
  cp_async_wait<0>();
  __syncthreads();   // the last slab read before the staging tile reuses it

  double* Ts = sm;
#pragma unroll
  for (int a = 0; a < G::MT; ++a)
#pragma unroll
    for (int c = 0; c < G::NT8; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int lr = wm * G::WM + 16 * a + g + 8 * (r >> 1);
        const int lc = wn * G::WN + 8 * c + 2 * t4 + (r & 1);
        Ts[lr * G::LDT + lc] = acc[a][c][r];
      }
  __syncthreads();
  store_tile<BT, G::NT>(Ts, H ? H + (long long)b * h_bs : nullptr,
                        bnd ? bnd + (long long)b * n : nullptr,
                        Q + (long long)b * n * n, n, i0, j0, diag, tid);
}

template <int BT, int WGM, int WGN, bool VEC, int MINB>
int launch_dmma(const void* Jc, long long jc_bs, const void* w,
                const void* H, long long h_bs, const void* bnd, void* Q,
                int B, int m, int n, int lower, void* stream) {
  using G = DmShape<BT, WGM, WGN, VEC>;
  const auto kernel = fused_q_dmma_kernel<BT, WGM, WGN, VEC, MINB>;
  const long long nt = (n + BT - 1) / BT;
  const long long tiles = nt * (nt + 1) / 2;
  if (B > 65535 || tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = onephase::smem_once(kernel, G::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)tiles, B), G::NT, G::SMEM, (cudaStream_t)stream>>>(
      (const double*)Jc, jc_bs, (const double*)w, (const double*)H, h_bs,
      (const double*)bnd, (double*)Q, m, n, lower);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// 128-tiles where the lower tile pairs of all instances give every SM
// `per_sm` blocks, else 64-tiles (the SM count read once a device)
bool big_tiles(int B, int n, int per_sm, int* err) {
  int dev = 0, sms = 0;
  *err = (int)onephase::device_sms(dev, sms);
  const long long nt = (n + 127) / 128;
  return (long long)B * (nt * (nt + 1) / 2) >= (long long)per_sm * sms;
}

// a mode's code (16 kind + passes) -> its instantiation
int launch_moded(const void* Jc, long long jc_bs, const void* w,
                 const void* H, long long h_bs, const void* bnd, void* Q,
                 int B, int m, int n, int lower, int mode, void* stream) {
  // 16-byte copies: whole 16-byte row segments, an aligned Jc
  const int vec = n % 4 == 0 && aligned16(Jc);
  switch (mode) {
    case 0x11:
      return launch_wg<1, 1>(Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower,
                             vec, stream);
    case 0x13:
      return launch_wg<1, 3>(Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower,
                             vec, stream);
    case 0x21:
      return launch_wg<2, 1>(Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower,
                             vec, stream);
    case 0x23:
      return launch_wg<2, 3>(Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower,
                             vec, stream);
    case 0x26:
      return launch_tc<2, 6>(Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower,
                             vec, stream);
    case 0x29:
      return launch_tc<2, 9>(Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower,
                             vec, stream);
    case 0x31:
      return launch_wg<3, 1>(Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower,
                             vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The 16-byte route needs whole 16-byte row segments (n a multiple of
// 16 / sizeof(T)) and 16-byte aligned bases.
template <typename T>
bool vec_route(const void* Jc, const void* H, const void* Q, int n) {
  return n % (16 / (int)sizeof(T)) == 0 && aligned16(Jc) && aligned16(Q) &&
         (H == nullptr || aligned16(H));
}

template <typename T>
int launch_fused_q(const void* Jc, long long jc_bs, const void* w,
                   const void* H, long long h_bs, const void* bnd, void* Q,
                   int B, int m, int n, int lower, int mode, void* stream);

// float32: a matmul mode (mode != 0) takes its tensor-core instantiation
// (any n, any alignment); IEEE the four below
template <>
int launch_fused_q<float>(const void* Jc, long long jc_bs, const void* w,
                          const void* H, long long h_bs, const void* bnd,
                          void* Q, int B, int m, int n, int lower, int mode,
                          void* stream) {
  if (mode != 0)
    return launch_moded(Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower, mode,
                        stream);
  int err = 0;
  const bool big = big_tiles(B, n, 2, &err);
  if (err != 0) return err;
  const bool vec = vec_route<float>(Jc, H, Q, n);
  if (big && vec)
    return launch_shape<float, 128, 8, 8, true, 2>(
        Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower, stream);
  if (big)
    return launch_shape<float, 128, 8, 8, false, 1>(
        Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower, stream);
  if (vec)
    return launch_shape<float, 64, 4, 4, true, 1>(
        Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower, stream);
  return launch_shape<float, 64, 4, 4, false, 1>(
      Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower, stream);
}

// float64: IEEE only (the knob touches float32 products), on the FP64
// tensor cores: 128-tiles (512 threads, one block an SM) where they give
// every SM two blocks, else 64-tiles (128 threads, three an SM); 16-byte
// copies where rows and Jc allow
template <>
int launch_fused_q<double>(const void* Jc, long long jc_bs, const void* w,
                           const void* H, long long h_bs, const void* bnd,
                           void* Q, int B, int m, int n, int lower, int mode,
                           void* stream) {
  if (mode != 0) return (int)cudaErrorInvalidValue;
  int err = 0;
  const bool big = big_tiles(B, n, 2, &err);
  if (err != 0) return err;
  const bool vec = n % 2 == 0 && aligned16(Jc);
  if (big && vec)
    return launch_dmma<128, 4, 4, true, 1>(Jc, jc_bs, w, H, h_bs, bnd, Q, B,
                                           m, n, lower, stream);
  if (big)
    return launch_dmma<128, 4, 4, false, 1>(Jc, jc_bs, w, H, h_bs, bnd, Q,
                                            B, m, n, lower, stream);
  if (vec)
    return launch_dmma<64, 2, 2, true, 3>(Jc, jc_bs, w, H, h_bs, bnd, Q, B,
                                          m, n, lower, stream);
  return launch_dmma<64, 2, 2, false, 3>(Jc, jc_bs, w, H, h_bs, bnd, Q, B,
                                         m, n, lower, stream);
}

}  // namespace

// C entry points; `lower` != 0 declares Jc square and lower triangular (the
// Gram product M = Jc^T Jc of a triangular inverse); `mode` is a matmul
// mode's code (mm_mode.cuh; 0 = IEEE, the only one float64 takes)
extern "C" int op_fused_q_f32(const void* Jc, long long jc_bs, const void* w,
                              const void* H, long long h_bs, const void* bnd,
                              void* Q, int B, int m, int n, int lower,
                              int mode, void* stream) {
  return launch_fused_q<float>(Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower,
                               mode, stream);
}

extern "C" int op_fused_q_f64(const void* Jc, long long jc_bs, const void* w,
                              const void* H, long long h_bs, const void* bnd,
                              void* Q, int B, int m, int n, int lower,
                              int mode, void* stream) {
  return launch_fused_q<double>(Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n,
                                lower, mode, stream);
}
