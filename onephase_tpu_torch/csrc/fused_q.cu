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
// What bounds it on the H100: plain FP32/FP64 FMA rate (no tensor cores:
// the reference multiplies at full precision, so no TF32).  Q - H is
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
//   for a card that one wave of 128-tiles would leave half idle); f64 takes
//   BT = 64.
// - Each thread keeps an RM x RN block of the tile in registers (f32 8 x 8
//   at BT = 128, 4 x 4 at BT = 64; f64 4 x 8), its rows and its columns as
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
// A `matmul_precision` mode (mm_mode.cuh; float32 only) takes one further
// instantiation, 64-tiles with 4 x 4 a thread and element copies (any n,
// any alignment): each k row's operands are rounded and split once as they
// leave shared memory (the i side after its scaling by w[k], as the TPU
// kernel forms `ji * w` before its dot), then the mode's part products are
// added smallest first.  The IEEE instantiations below are unchanged.
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

#include "mm_mode.cuh"

namespace {

using onephase::MmMode;

__device__ __forceinline__ float fq_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fq_fma(double a, double b, double c) {
  return fma(a, b, c);
}

// 16 bytes: 4 floats or 2 doubles
__device__ __forceinline__ void ld16(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ld16(const double* p, double* v) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
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

template <typename T, int BT, int RM, int RN, bool VEC, int MINB,
          bool MODED>
__global__ void __launch_bounds__((BT / RM) * (BT / RN), MINB)
fused_q_lower_kernel(const T* __restrict__ Jc, long long jc_bs,
                     const T* __restrict__ w, const T* __restrict__ H,
                     long long h_bs, const T* __restrict__ bnd,
                     T* __restrict__ Q, int m, int n, int lower, int mode) {
  using S = Shape<T, BT, RM, RN, VEC>;
  static_assert(!MODED || sizeof(T) == 4, "modes are float32 only");
  const MmMode md = onephase::mm_mode(mode);
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
  // thread's RM scaled i-side entries, b its RN j-side entries; MODED:
  // each split once (mm_mode.cuh), then the mode's part products
  auto k_step = [&](const T* As, const T* Bs, int kk) {
    T a[RM], bv[RN];
#pragma unroll
    for (int g = 0; g < RM / 4; ++g)
      ld4(As + kk * BT + g * S::GM + 4 * ty, a + 4 * g);
#pragma unroll
    for (int g = 0; g < RN / 4; ++g)
      ld4(Bs + kk * BT + g * S::GN + 4 * tx, bv + 4 * g);
    if constexpr (MODED) {
      float ap[RM][3], bp[RN][3];
#pragma unroll
      for (int r = 0; r < RM; ++r) onephase::mm_split(a[r], md, ap[r]);
#pragma unroll
      for (int c = 0; c < RN; ++c) onephase::mm_split(bv[c], md, bp[c]);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c)
          acc[r][c] = onephase::mm_fma_parts(ap[r], bp[c], acc[r][c],
                                             md.passes);
    } else {
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c)
          acc[r][c] = fq_fma(a[r], bv[c], acc[r][c]);
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
    for (int j = 0; j + 1 < ST - 1; ++j)
#pragma unroll
      for (int q = 0; q < S::CPT; ++q) wr[j][q] = wr[j + 1][q];
    const int s2 = s + ST - 1;
    if (s2 < nslab) issue(kbeg + s2 * KC, s2 % ST, wr[ST - 2]);
    else cp_async_commit();
    const T* As = sm + buf * 2 * S::SLAB;
    const T* Bs = As + S::SLAB;
    const int kc = m - kbeg - s * KC;
    if constexpr (MODED) {
      // one k row at a time: the moded step is large, its unrolled
      // copies would only cost build time
#pragma unroll 1
      for (int kk = 0; kk < (kc < KC ? kc : KC); ++kk) k_step(As, Bs, kk);
    } else if (kc >= KC) {
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

template <typename T, int BT, int RM, int RN, bool VEC, int MINB,
          bool MODED = false>
int launch_shape(const void* Jc, long long jc_bs, const void* w,
                 const void* H, long long h_bs, const void* bnd, void* Q,
                 int B, int m, int n, int lower, void* stream,
                 int mode = 0) {
  using S = Shape<T, BT, RM, RN, VEC>;
  const auto kernel = fused_q_lower_kernel<T, BT, RM, RN, VEC, MINB, MODED>;
  const long long nt = (n + BT - 1) / BT;
  const long long tiles = nt * (nt + 1) / 2;
  if (B > 65535 || tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)tiles, B), S::NT, S::SMEM, (cudaStream_t)stream>>>(
      (const T*)Jc, jc_bs, (const T*)w, (const T*)H, h_bs, (const T*)bnd,
      (T*)Q, m, n, lower, mode);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
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

// float32: a matmul mode (mode != 0) takes the one moded instantiation,
// 64-tiles with element copies (any n, any alignment); IEEE the four below
template <>
int launch_fused_q<float>(const void* Jc, long long jc_bs, const void* w,
                          const void* H, long long h_bs, const void* bnd,
                          void* Q, int B, int m, int n, int lower, int mode,
                          void* stream) {
  if (mode != 0) {
    if (!onephase::mm_mode_valid(mode)) return (int)cudaErrorInvalidValue;
    return launch_shape<float, 64, 4, 4, false, 1, true>(
        Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower, stream, mode);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // 128-tiles where they give every SM two blocks, else 64-tiles
  const long long nt = (n + 127) / 128;
  const bool big = (long long)B * (nt * (nt + 1) / 2) >= 2LL * sms;
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

// float64: IEEE only (the knob touches float32 products)
template <>
int launch_fused_q<double>(const void* Jc, long long jc_bs, const void* w,
                           const void* H, long long h_bs, const void* bnd,
                           void* Q, int B, int m, int n, int lower, int mode,
                           void* stream) {
  if (mode != 0) return (int)cudaErrorInvalidValue;
  if (vec_route<double>(Jc, H, Q, n))
    return launch_shape<double, 64, 4, 8, true, 1>(
        Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower, stream);
  return launch_shape<double, 64, 4, 8, false, 1>(
      Jc, jc_bs, w, H, h_bs, bnd, Q, B, m, n, lower, stream);
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
