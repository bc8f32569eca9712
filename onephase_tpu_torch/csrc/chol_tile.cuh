// Cholesky factor and triangular inverse of one SPD tile in shared memory:
// the device routine K2 (chol.cu, the diagonal block of each panel) and K7
// (tridiag.cu, the diagonal block of each stage) share.
//
// The TPU kernels do the same two steps with masked whole-tile sweeps:
// _unblocked_chol and _tri_inv_unblocked of onephase_tpu/ops/cholesky.py
// (:48-96).  Pivot protocol as there: ok &= pivot > 0 && isfinite(pivot),
// then the column is scaled by 1/sqrt(max(pivot, tiny)) and the
// factorization continues (tiny = 1e-38 in f32, 1e-300 in f64); on failure
// the tile is garbage and only ok matters.
//
// What bounds it: latency.  An NB x NB tile (NB <= 64) is NB dependent
// column steps of a few hundred operations each, so the cost is the number
// of barriers and the instruction count of one step, not bytes or FLOPs.
//
// What the design does about it:
// - Every thread owns a fixed set of entries of the lower triangle (the
//   row-major lower-triangle index e = tid + i * NT), decoded to (r, c)
//   once by the caller (`tile_owner`), so no loop divides by a runtime size.
//   The entries of the factor and of the inverse live in registers for the
//   whole routine; a slot whose rows are all finished is skipped.
// - Factor and inverse advance together, one barrier per column: in phase
//   j the Cholesky scales column j and updates the trailing entries with
//   it, and the inverse (right-looking forward substitution on the
//   identity: X~[r, :] -= L[r, j-1] X[j-1, :] for r >= j, then
//   X[j, :] = X~[j, :] / L[j, j]) takes its step j - 1 and divides its row
//   j.  The columns and rows the next phases need are published to rotating
//   buffers in shared memory by their owners; the phases run in groups of
//   four, so the buffers of each are compile-time offsets.  A phase has no branch that
//   splits a warp but the divisions of row j, taken only in the warps that
//   hold it.
// - The pivot's reciprocal square root is computed once per warp, by lane 0,
//   and broadcast with __shfl_sync; thread 0 alone keeps the ok flag.
// - Shared tiles have an odd leading dimension (NB | 1), so a walk down a
//   column never strides a multiple of the 32 banks.
#pragma once
#include <cuda_runtime.h>

#include "mm_mode.cuh"

namespace onephase {

// smallest pivot fed to the reciprocal square root, and the largest finite
// value (a pivot above it is +inf; NaN compares false with both)
template <typename T> __device__ __forceinline__ T tiny_pivot();
template <> __device__ __forceinline__ float tiny_pivot<float>() { return 1e-38f; }
template <> __device__ __forceinline__ double tiny_pivot<double>() { return 1e-300; }
template <typename T> __device__ __forceinline__ T max_finite();
template <> __device__ __forceinline__ float max_finite<float>() { return 3.402823466e38f; }
template <> __device__ __forceinline__ double max_finite<double>() { return 1.7976931348623157e308; }

// leading dimension of an NB x NB tile in shared memory
template <int NB> __host__ __device__ constexpr int tile_ld() { return NB | 1; }
// lower-triangle entries a thread owns
template <int NB, int NT> __host__ __device__ constexpr int tile_entries() {
  return (NB * (NB + 1) / 2 + NT - 1) / NT;
}

// The last row that slot i of tile_owner reaches in any thread: once the
// phase passes it, the slot's entries are final and the slot is skipped.
template <int NB, int NT>
__host__ __device__ constexpr int slot_last_row(int i) {
  int e = NT * (i + 1) - 1;
  if (e > NB * (NB + 1) / 2 - 1) e = NB * (NB + 1) / 2 - 1;
  int r = 0;
  while ((r + 1) * (r + 2) / 2 <= e) ++r;
  return r;
}

// The entries thread `tid` owns, packed r << 8 | c; a slot past the end
// holds r = c = NB + 1.
template <int NB, int NT>
__device__ __forceinline__ void tile_owner(int (&own)[tile_entries<NB, NT>()],
                                           int tid) {
#pragma unroll
  for (int i = 0; i < tile_entries<NB, NT>(); ++i) {
    const int e = tid + i * NT;
    if (e >= NB * (NB + 1) / 2) {
      own[i] = ((NB + 1) << 8) | (NB + 1);
      continue;
    }
    int r = (int)((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
    while (r * (r + 1) / 2 > e) --r;
    while ((r + 1) * (r + 2) / 2 <= e) ++r;
    own[i] = (r << 8) | (e - r * (r + 1) / 2);
  }
}

// One phase of chol_tile (see there) for column j, with j % 4 == CB: the
// four column buffers and two row buffers are then fixed for the phase, so
// every buffer access is a register offset plus a constant.  PASSES > 0
// (MODED, INV: K7's moded tile): column j's scaled entries L[r, j] =
// S[r, j] dinv and X's row j - 1 are split into their parts once, one
// thread an entry, into part buffers after vec's six (column j's parts in
// the buffer of j's parity, so column j - 1's stay for the inverse's step;
// X's row in a third), with a barrier before the slots read them; each
// slot's two products are then PASSES inline FMAs from +0 on those parts.
template <typename T, int NB, int NT, bool INV, int CB, bool MODED,
          int PASSES>
__device__ __forceinline__ void tile_phase(
    int j, T* vec, T (&s)[tile_entries<NB, NT>()],
    T (&x)[tile_entries<NB, NT>()], const int (&rr)[tile_entries<NB, NT>()],
    const int (&cc)[tile_entries<NB, NT>()],
    const int (&last)[tile_entries<NB, NT>()], T& dinv_prev, int tid,
    int& ok, MmMode md) {
  constexpr int ME = tile_entries<NB, NT>();
  const T* cj = vec + CB * NB;                  // column j
  const T* cp = vec + ((CB + 3) & 3) * NB;      // column j - 1
  T* cn = vec + ((CB + 1) & 3) * NB;            // column j + 1
  const T* xp = vec + (4 + ((CB + 1) & 1)) * NB;   // row j - 1 of X
  T* xn = vec + (4 + (CB & 1)) * NB;               // row j of X
  const T tiny = tiny_pivot<T>();
  T piv = T(0), dinv = T(0);
  if ((tid & 31) == 0) {
    piv = cj[j];
    if (tid == 0 && !(piv > T(0) && piv <= max_finite<T>())) ok = 0;
    dinv = T(1) / sqrt(piv > tiny ? piv : tiny);
  }
  piv = __shfl_sync(0xffffffffu, piv, 0);
  dinv = __shfl_sync(0xffffffffu, dinv, 0);
  const T ljj = piv * dinv;   // L[j, j]
  constexpr int PARTS = mode_parts(PASSES > 0 ? PASSES : 1);
  [[maybe_unused]] T* pc = vec + 6 * NB + 2 + (CB & 1) * 3 * NB;
  [[maybe_unused]] const T* pp = vec + 6 * NB + 2 + ((CB + 1) & 1) * 3 * NB;
  [[maybe_unused]] T* px = vec + 12 * NB + 2;
  if constexpr (PASSES > 0) {
    static_assert(MODED && INV, "the split-once tile is K7's moded one");
    T part[PARTS];
    if (tid < NB) {
      mm_split_n<PARTS>(cj[tid] * dinv, md.kind, part);
#pragma unroll
      for (int q = 0; q < PARTS; ++q) pc[q * NB + tid] = part[q];
    } else if (tid < 2 * NB) {
      mm_split_n<PARTS>(xp[tid - NB], md.kind, part);
#pragma unroll
      for (int q = 0; q < PARTS; ++q) px[q * NB + tid - NB] = part[q];
    }
    __syncthreads();
  }
  // an unused slot has r = c = NB + 1, which matches no test below; a slot
  // whose rows are all finished is skipped
  T lr[ME], lc[ME], pr[ME], xq[ME];
#pragma unroll
  for (int i = 0; i < ME; ++i) {
    if (PASSES > 0 || last[i] < j) continue;
    lr[i] = cj[rr[i]];
    lc[i] = cj[cc[i]];
    if (INV) {
      pr[i] = cp[rr[i]];
      xq[i] = xp[cc[i]];
    }
  }
#pragma unroll
  for (int i = 0; i < ME; ++i) {
    if (last[i] < j) continue;
    const int r = rr[i], c = cc[i];
    T upd;
    if constexpr (PASSES > 0)   // the column update's product in the mode
      upd = s[i] - mm_prod_parts<PASSES>(pc + r, pc + c, NB);
    else if constexpr (MODED)   // (K2: inlined, one product a slot)
      upd = s[i] - mode_fma(lr[i] * dinv, lc[i] * dinv, T(0), md);
    else
      upd = s[i] - (lr[i] * dinv) * (lc[i] * dinv);
    const T scaled = s[i] * dinv;
    s[i] = c == j ? scaled : (c > j ? upd : s[i]);
    if (INV) {
      T xupd;
      if constexpr (PASSES > 0)   // the substitution's product in the mode
        xupd = x[i] - mm_prod_parts<PASSES>(pp + r, px + c, NB);
      else
        xupd = x[i] - (pr[i] * dinv_prev) * xq[i];
      x[i] = (r >= j && c < j) ? xupd : x[i];
      // row j lies in the slots of one or two warps: divide there only
      if (__any_sync(0xffffffffu, r == j)) {
        const T q = x[i] / ljj;
        x[i] = r == j ? q : x[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ME; ++i) {
    if (last[i] < j) continue;
    if (cc[i] == j + 1) cn[rr[i]] = s[i];
    if (INV && rr[i] == j) xn[cc[i]] = x[i];
  }
  dinv_prev = dinv;
  __syncthreads();
}

// Factor the SPD tile S (lower triangle read; NB x NB, leading dimension
// tile_ld<NB>(), NB a multiple of 4) in place: on return its lower
// triangle holds L, with S = L L^T, and, if INV, the lower triangle of X
// holds L^{-1}.  The upper triangles are not touched (X's must be zero on
// entry for X to be L^{-1}).  `vec` is 6 NB + 2 elements of scratch (15 NB
// + 4 with PASSES > 0).  Thread 0's `ok` is cleared on a bad pivot.  Every
// thread of the block calls it; it starts and ends with a barrier.  MODED
// (float32): every product of two entries, the trailing entries' L[r, j]
// L[c, j] and, with INV, the inverse's L[r, q] X[q, c], is taken in the
// matmul mode `md` (mm_mode.cuh): its part products summed from +0 in the
// mode's order, the sum then subtracted, as the twins subtract a dot
// product (K2's diagonal blocks, and K7's blocks with their inverses).
// K2's (INV false) splits both operands in each slot (mode_fma, inline);
// K7's (INV, PASSES the mode's pass count, md.kind its kind) splits each
// operand once a phase (tile_phase), so a slot's products depend on the
// pass count alone.  Each product is one product of two entries, so both
// give the values of a split in every slot.
//
// The arithmetic is that of the unblocked column loops it replaces, value
// for value: column j is scaled by dinv_j = 1/sqrt(pivot) and the trailing
// entries lose (S[r, j] dinv_j)(S[c, j] dinv_j); the inverse's row j is
//   X[j, c] = (delta_jc - sum_{q = c}^{j-1} L[j, q] X[q, c]) / L[j, j],
// summed in increasing q.  Step q of the inverse (every row below q loses
// L[r, q] X[q, c]) runs one barrier after the Cholesky's step q, in the
// same phase as the division of row q + 1, so each phase reads column j
// and column j - 1 (four column buffers in rotation) and the final row
// j - 1 of X (two row buffers).  Within a phase every thread first loads
// what it needs from the buffers, then computes (branch-free: every entry
// computes its candidates and selects), then publishes, so stores to the
// buffers never wait on loads from them.
template <typename T, int NB, int NT, bool INV, bool MODED = false,
          int PASSES = 0>
__device__ void chol_tile(T* S, T* X, T* vec,
                          const int (&own)[tile_entries<NB, NT>()], int tid,
                          int& ok, MmMode md = MmMode{0, 1}) {
  static_assert(NB % 4 == 0, "the phases run in groups of four");
  static_assert(!MODED || sizeof(T) == 4, "modes: float32 only");
  static_assert((PASSES > 0) == (MODED && INV),
                "K7's moded tile splits once; K2's and the IEEE tiles do not");
  constexpr int LD = tile_ld<NB>();
  constexpr int ME = tile_entries<NB, NT>();
  T s[ME], x[ME];
  int rr[ME], cc[ME], last[ME];
#pragma unroll
  for (int i = 0; i < ME; ++i) {
    rr[i] = own[i] >> 8;
    cc[i] = own[i] & 255;
    s[i] = x[i] = T(0);
    last[i] = slot_last_row<NB, NT>(i);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ME; ++i) {
    if (rr[i] >= NB) continue;
    s[i] = S[rr[i] * LD + cc[i]];
    x[i] = rr[i] == cc[i] ? T(1) : T(0);
    if (cc[i] == 0) vec[rr[i]] = s[i];
  }
  __syncthreads();
  T dinv_prev = T(0);
#pragma unroll 1
  for (int j = 0; j < NB; j += 4) {
    tile_phase<T, NB, NT, INV, 0, MODED, PASSES>(j, vec, s, x, rr, cc, last,
                                                 dinv_prev, tid, ok, md);
    tile_phase<T, NB, NT, INV, 1, MODED, PASSES>(
        j + 1, vec, s, x, rr, cc, last, dinv_prev, tid, ok, md);
    tile_phase<T, NB, NT, INV, 2, MODED, PASSES>(
        j + 2, vec, s, x, rr, cc, last, dinv_prev, tid, ok, md);
    tile_phase<T, NB, NT, INV, 3, MODED, PASSES>(
        j + 3, vec, s, x, rr, cc, last, dinv_prev, tid, ok, md);
  }
#pragma unroll
  for (int i = 0; i < ME; ++i) {
    if (rr[i] >= NB) continue;
    S[rr[i] * LD + cc[i]] = s[i];
    if (INV) X[rr[i] * LD + cc[i]] = x[i];
  }
  __syncthreads();
}

// K7's moded tile (chol_tile with INV, MODED and the split once) for the
// mode of pass count PASSES and kind `kind`: one call a stage, not inlined,
// so the tile is built once a pass count and block edge (4 variants an
// NB), not once a mode.  `ok`: thread 0's flag, cleared on a bad pivot.
template <int NB, int NT, int PASSES>
__device__ __noinline__ void chol_tile_split(float* S, float* X, float* vec,
                                             int tid, int* ok, int kind) {
  int own[tile_entries<NB, NT>()];
  tile_owner<NB, NT>(own, tid);
  int okl = *ok;
  chol_tile<float, NB, NT, true, true, PASSES>(S, X, vec, own, tid, okl,
                                               MmMode{kind, PASSES});
  *ok = okl;
}

}  // namespace onephase
