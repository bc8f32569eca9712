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
//   both sweeps in one launch (y is kept in the output x).
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
//
// What the solve's design does about it: a stage's latency is two
// dependent chains of nb FMAs (E v, then Ci r), so only they should stay on
// its critical path.
// - Consumers: the block edge is a compile-time NB (32 for nb <= 32, else
//   64); lane t of NB / 32 consumer warps owns row t.  The inner products
//   are unrolled, masked past nb (predicated FMAs; unmasked where nb ==
//   NB), and each chain's terms are read into registers before its first
//   FMA; the E row of the next stage is read while the current stage's
//   second chain runs.  The warps meet by __syncwarp (NB = 32) or a named
//   barrier of 64 threads (NB = 64): no block-wide barrier a stage.
// - Producers: three warps for each consumer warp copy each stage's
//   operands, Ci_k, E (E_{k-1} forward, E_k backward) and the vector (b_k
//   forward, y_k backward), into a ring of S stage slots in shared memory,
//   up to S - 1 stages ahead (S = 8 at NB = 32; at NB = 64, 5 in f32 and
//   3 in f64: the ring within about 200 KB), with 16-byte cp.async copies.
//   Where nb sizeof(T) is a multiple of 16 each row goes to a slot row
//   padded by 16 bytes, so the forward sweep's 16-byte row reads and the
//   backward sweep's column reads are both free of bank conflicts; else the
//   block is copied as it lies, from its 16-byte phase on (an odd nb, as
//   the banded path's 63, makes both walks conflict-free as well).
// - Handoffs: a slot is full when an mbarrier has counted every producer
//   thread's cp.async.mbarrier.arrive (so no global load lies on a stage's
//   critical path); the consumers release slots through a counter in shared
//   memory (release/acquire), published before their store to x so that
//   its fence waits on no fresh global store.  The whole block meets once,
//   at the turn of the sweeps, after which the producers copy y_k back
//   from x.
// Value for value: each lane sums its terms in the order c = 0 .. nb-1,
// one fma a term (the earlier one-row-per-thread kernel's `s += a * b`, as
// nvcc contracted it), r = b - s and y - s as before; x is what that kernel
// returned, bit for bit (tools/kernel_equal.py).  nb <= 64.
//
// Matmul modes (`matmul_precision`, mm_mode.cuh; float32 only): each kernel
// has one moded instantiation beside its IEEE ones, which are unchanged, as
// K1-K3 have; the mode is a runtime code (0 = IEEE), and a code the kernels
// lack is refused at launch.  The JAX kernels' dots take no `precision`, so
// the knob reaches every product of two matrix entries:
// - K7: E_{k-1} E_{k-1}^T and B_k Ci_k^T, each operand split once when a
//   thread loads it (the part products of a term summed into the running
//   dot product, smallest first), and the tile's Cholesky and inverse
//   (chol_tile.cuh, its products summed from +0 and subtracted);
// - K5: both chains, each E and Ci term split where a lane reads it (once
//   a stage), and the carried vector v and the residual r split once a
//   stage by the lane that writes each entry, into parts in shared memory
//   that every lane reads.
// The products run on the FP32 cores, 1, 3, 6 or 9 FMAs each; sums,
// divisions and square roots stay float32.
#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

using onephase::chol_tile;
using onephase::MmMode;
using onephase::mm_fma_parts;
using onephase::mm_split;
using onephase::tile_entries;
using onephase::tile_ld;
using onephase::tile_owner;

constexpr int MAX_NB = 64;

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
// shared memory (leading dimension NB | 1), p in increasing order.  MODED:
// each loaded entry split once, every term's part products summed into
// acc in the mode's order.
template <typename T, int NB, int NT, bool MODED>
__device__ __forceinline__ void band_product(
    const T* A, const T* Bt, T (&acc)[NB * 16 / NT][NB / 16], int ty,
    int tx, MmMode md) {
  constexpr int LD = tile_ld<NB>(), TY = NT / 16;
  constexpr int RA = NB * 16 / NT, RC = NB / 16;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[a][c] = T(0);
#pragma unroll(MODED ? 1 : 8)
  for (int p = 0; p < NB; ++p) {
    T av[RA], bv[RC];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = A[(ty + TY * a) * LD + p];
#pragma unroll
    for (int c = 0; c < RC; ++c) bv[c] = Bt[(tx + 16 * c) * LD + p];
    if constexpr (MODED) {
      float pa[RA][3], pb[RC][3];
#pragma unroll
      for (int a = 0; a < RA; ++a) mm_split(av[a], md, pa[a]);
#pragma unroll
      for (int c = 0; c < RC; ++c) mm_split(bv[c], md, pb[c]);
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < RC; ++c)
          acc[a][c] = mm_fma_parts(pa[a], pb[c], acc[a][c], md.passes);
    } else {
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < RC; ++c) acc[a][c] += av[a] * bv[c];
    }
  }
}

template <typename T, int NB>
constexpr size_t factor_smem() {
  return sizeof(T) * (6 * NB * tile_ld<NB>() + 6 * NB + 2);
}

// MODED (float32 only): every product in the matmul mode `mode` (the
// header); the IEEE instantiations ignore it.
template <typename T, int NB, int NT, bool MODED>
__global__ void __launch_bounds__(NT)
tridiag_factor_kernel(const T* __restrict__ Ad, const T* __restrict__ Bs,
                      const T* __restrict__ delta, T* __restrict__ Ck,
                      T* __restrict__ Ci, T* __restrict__ Ek,
                      int* __restrict__ ok_out, int K, int nb, int mode) {
  static_assert(!MODED || sizeof(T) == 4, "modes are float32 only");
  const MmMode md = onephase::mm_mode(mode);
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
    band_product<T, NB, NT, MODED>(E, E, acc, ty, tx, md);
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
    chol_tile<T, NB, NT, true, MODED>(S, X, vec, own, tid, ok, md);

    // 3. C_k and X out; E_k = B_k X^T
    if (k < K - 1)
      band_product<T, NB, NT, MODED>(Bk, X, acc, ty, tx, md);
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// Arrive on `bar` once every cp.async this thread has issued has landed
// (the barrier's count includes this arrival).
__device__ __forceinline__ void mbar_arrive_on_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the phase of `bar` with this parity has completed.  A handoff
// takes microseconds; one that has not come after 2^24 tries (seconds)
// means a broken ring, and the kernel traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  for (unsigned tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}
// A counter in shared memory, written by one thread with release semantics
// and read with acquire semantics; the wait traps as mbar_wait does.
__device__ __forceinline__ void flag_store(unsigned* f, unsigned val) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;\n" ::"r"(smem_u32(f)),
               "r"(val)
               : "memory");
}
__device__ __forceinline__ unsigned flag_load(const unsigned* f) {
  unsigned val;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];\n"
               : "=r"(val)
               : "r"(smem_u32(f))
               : "memory");
  return val;
}
__device__ __forceinline__ void flag_wait(const unsigned* f,
                                          unsigned target) {
  for (unsigned tries = 0; flag_load(f) < target; ++tries)
    if (tries == (1u << 26)) __trap();
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
// Four consecutive elements at a 16-byte aligned shared address.
__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ld4(const double* p, double* v) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}
// 16 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// The geometry of the solve at the compile-time block edge NB (32 or 64).
template <typename T, int NB>
struct SolveShape {
  static constexpr int E = 16 / (int)sizeof(T);   // elements a 16-byte copy
  static constexpr int LDR = NB + E;        // a slot row of the row layout
  static constexpr int NCW = NB / 32;       // consumer warps, lane t row t
  static constexpr int NC = 32 * NCW;
  static constexpr int PT = 3 * NC;         // producer threads
  static constexpr int THREADS = NC + PT;
  static constexpr int CR = NB / E;         // 16-byte chunks of a full row
  static constexpr int RS = PT / CR;        // rows one producer pass covers
  static constexpr int AREA = NB * LDR;     // one block of a slot
  static constexpr int SLOT = 2 * AREA + NB;      // Ci_k, E, vector
  static constexpr int SLOT_BYTES = SLOT * (int)sizeof(T);
  // ring depth: up to 8 stages within about 200 KB
  static constexpr int STAGES = 200 * 1024 / SLOT_BYTES < 8
                                    ? 200 * 1024 / SLOT_BYTES : 8;
  // terms of a chain read into registers at once, and of Ci_k's row ahead
  // of the stage's middle sync
  static constexpr int CH = 128 / (int)sizeof(T) < NB ? 128 / (int)sizeof(T)
                                                       : NB;
  // the `done` counter (16 bytes), the full barriers (16 bytes each, so
  // what follows stays 16-byte aligned), v and r, then the ring
  static constexpr size_t SMEM = 16 + 16 * STAGES + 2 * NB * sizeof(T) +
                                 (size_t)STAGES * SLOT_BYTES;
  static_assert(NB % 32 == 0 && PT % CR == 0, "whole warps, whole rows");
  static_assert(STAGES >= 2 && SLOT_BYTES % 16 == 0 &&
                    AREA * sizeof(T) % 16 == 0, "ring");
};

// The whole block, met from the consumers' and the producers' own branches.
template <int N>
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(N) : "memory");
}

template <int NCW>
__device__ __forceinline__ void consumer_sync() {
  if constexpr (NCW == 1)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * NCW) : "memory");
}

// Where a block of the ring starts: in the row layout (ROWS: nb sizeof(T)
// a multiple of 16, bases 16-byte aligned) row r at r LDR; else the block
// as it lies in global memory, from its 16-byte phase on.
template <typename T, int NB, bool ROWS>
__device__ __forceinline__ int block_phase(const T* src) {
  using S = SolveShape<T, NB>;
  if constexpr (ROWS) return 0;
  return (int)((reinterpret_cast<unsigned long long>(src) / sizeof(T)) %
               S::E);
}

// One nb x nb block (row-major in global memory) into a block of the ring,
// by this producer thread p of PT.  Row layout: 16-byte chunk j of row r at
// r LDR + E j, the thread's chunk column j = p % CR and rows p / CR + RS i.
// Else the block's nb^2 elements in order from dst + phase: the elements
// before the first 16-byte boundary and after the last one singly, the
// rest in 16-byte chunks, chunk q by thread q % PT.
template <typename T, int NB, bool ROWS>
__device__ __forceinline__ void copy_block(T* dst, const T* src, int nb,
                                           int p) {
  using S = SolveShape<T, NB>;
  if constexpr (ROWS) {
    const int j = p % S::CR;
    if (S::E * j >= nb) return;
#pragma unroll 4
    for (int r = p / S::CR; r < nb; r += S::RS)
      cp_async16(dst + r * S::LDR + S::E * j, src + r * nb + S::E * j);
  } else {
    const int ph = block_phase<T, NB, false>(src);
    const int n = nb * nb;
    const int head = min((S::E - ph) % S::E, n);
    const int nch = (n - head) / S::E;
    const int tail = n - head - S::E * nch;
    dst += ph;
    if (p < head) cp_async(dst + p, src + p);
    for (int q = p; q < nch; q += S::PT)
      cp_async16(dst + head + S::E * q, src + head + S::E * q);
    if (p < tail) {
      const int i = head + S::E * nch + p;
      cp_async(dst + i, src + i);
    }
  }
}

// acc + a w[c] in matmul mode md, a split here, w given by its parts (hi,
// mid, lo at wp[c], wp[NB + c], wp[2 NB + c]).
template <int NB>
__device__ __forceinline__ float moded_term(float a, const float* wp, int c,
                                            float acc, MmMode md) {
  float pa[3];
  const float pw[3] = {wp[c], wp[NB + c], wp[2 * NB + c]};
  mm_split(a, md, pa);
  return mm_fma_parts(pa, pw, acc, md.passes);
}

// Entry t of a vector, split in mode md, into its parts in wp.
template <int NB>
__device__ __forceinline__ void put_parts(float* wp, int t, float w,
                                          MmMode md) {
  float pw[3];
  mm_split(w, md, pw);
  wp[t] = pw[0];
  wp[NB + t] = pw[1];
  wp[2 * NB + t] = pw[2];
}

// One sweep on the consumer warps (FWD: stages g = 0 .. K-1, k = g; else
// g = K .. 2K-1, k = 2K-1-g), lane t owning row t (t < nb) of each stage:
//   forward  r = b_k - E_{k-1} v,     y = Ci_k r      (v = y_{k-1})
//   backward r = y_k - E_k^T v,       x = Ci_k^T r    (v = x_{k+1})
// each sum over c = 0 .. nb-1 in order, one FMA a term, masked past nb
// unless FULL (nb == NB); the result goes to x and to v.  Each chain's
// terms are read into registers before its first FMA (unconditionally:
// past nb they read the slot's unused padding, which no term sums), and the
// E row (column) of stage g + 1 while stage g's second chain runs, so a
// stage's first chain waits only on v.  `done` is published (release)
// before the stage's store to x, so its fence waits on no fresh global
// store.  MODED: every term's product in the mode `md`, the E and Ci terms
// read from the slot and split there, v and r from their parts `vp` and
// `rp` (hi, mid, lo: 3 NB each in shared memory), which the lane that
// writes an entry of v or r splits once; the moded loops are not unrolled
// (an unrolled moded step multiplies the build time).
template <typename T, int NB, bool ROWS, bool FULL, bool FWD, bool MODED>
__device__ __forceinline__ void consume_sweep(
    const T* ring, unsigned long long* full, unsigned* done, const T* Ci_b,
    const T* Ek_b, T* x_b, T* v, T* r, T* vp, T* rp, int K, int nb, int t,
    MmMode md) {
  using S = SolveShape<T, NB>;
  constexpr int CH = S::CH;
  const long long blk = (long long)nb * nb;
  const int ld = ROWS ? S::LDR : nb;
  const bool own = FULL || t < nb;
  const int g0 = FWD ? 0 : K, g1 = FWD ? K : 2 * K;
  // four consecutive terms c0 .. c0+3 of row t of a block (column t
  // backward), element (row i, column c) at i ld + c; rows of the row
  // layout are read 16 bytes at a time
  auto terms4 = [&](const T* A, int c0, T* a) {
    if constexpr (FWD && ROWS) {
      ld4(A + t * ld + c0, a);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[u] = FWD ? A[t * ld + c0 + u] : A[(c0 + u) * ld + t];
    }
  };
  auto live = [&](int c) { return FULL || c < nb; };
  [[maybe_unused]] const int nc = FULL ? NB : nb;   // terms (MODED)
  T e[NB];
  // wait for stage g's slot, then read its E row (column) into e
  auto take = [&](int g) {
    mbar_wait(full + g % S::STAGES, (g / S::STAGES) & 1);
    const int ke = FWD ? g - 1 : 2 * K - 1 - g;
    if (ke < 0 || ke >= K - 1) return;
    const T* Es = ring + (g % S::STAGES) * S::SLOT + S::AREA +
                  block_phase<T, NB, ROWS>(Ek_b + ke * blk);
#pragma unroll
    for (int c0 = 0; c0 < NB; c0 += 4) terms4(Es, c0, e + c0);
  };
  take(g0);
  for (int g = g0; g < g1; ++g) {
    const int k = FWD ? g : 2 * K - 1 - g;
    const int ke = FWD ? k - 1 : k;
    const T* Ms = ring + (g % S::STAGES) * S::SLOT;
    const T* vs = Ms + 2 * S::AREA;
    Ms += block_phase<T, NB, ROWS>(Ci_b + k * blk);
    T mr[CH];   // the first CH terms of Ci_k's row (column)
#pragma unroll
    for (int c0 = 0; c0 < CH; c0 += 4) terms4(Ms, c0, mr + c0);
    T s = T(0);
    if (ke >= 0 && ke < K - 1) {
      if constexpr (MODED) {
        // from the slot (a runtime index would put e in local memory)
        const T* Es = ring + (g % S::STAGES) * S::SLOT + S::AREA +
                      block_phase<T, NB, ROWS>(Ek_b + ke * blk);
#pragma unroll 1
        for (int c = 0; c < nc; ++c)
          s = moded_term<NB>(Es[FWD ? t * ld + c : c * ld + t], vp, c, s,
                             md);
      } else {
        T vv[NB];
#pragma unroll
        for (int c0 = 0; c0 < NB; c0 += 4) ld4(v + c0, vv + c0);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          if (live(c)) s = fma_t(e[c], vv[c], s);
      }
    }
    if (own) {
      const T rt = vs[t] - s;
      r[t] = rt;
      if constexpr (MODED) put_parts<NB>(rp, t, rt, md);
    }
    consumer_sync<S::NCW>();
    T y = T(0);
    if constexpr (MODED) {
#pragma unroll 1
      for (int c = 0; c < nc; ++c)
        y = moded_term<NB>(Ms[FWD ? t * ld + c : c * ld + t], rp, c, y, md);
    } else {
#pragma unroll
      for (int h = 0; h < NB; h += CH) {
        T m[CH], rr[CH];
#pragma unroll
        for (int c0 = 0; c0 < CH; c0 += 4) {
          if (h == 0) {
#pragma unroll
            for (int u = 0; u < 4; ++u) m[c0 + u] = mr[c0 + u];
          } else {
            terms4(Ms, h + c0, m + c0);
          }
          ld4(r + h + c0, rr + c0);
        }
#pragma unroll
        for (int c = 0; c < CH; ++c)
          if (live(h + c)) y = fma_t(m[c], rr[c], y);
      }
    }
    if (own) {
      v[t] = y;
      if constexpr (MODED) put_parts<NB>(vp, t, y, md);
    }
    if (g + 1 < g1) take(g + 1);
    consumer_sync<S::NCW>();
    if (t == 0) flag_store(done, g + 1);
    if (own) x_b[k * nb + t] = y;
  }
}

// Warp roles: NCW consumer warps (lane t of warp w owns row 32 w + t) and
// PT / 32 producer warps.  2K stages, g = 0 .. K-1 forward (k = g), then
// K .. 2K-1 backward (k = 2K-1-g), each in ring slot g % STAGES, which
// holds Ci_k, E (E_{k-1} forward, E_k backward) and the vector (b_k
// forward, y_k backward).  Handoffs: full[slot], an mbarrier that completes
// once every producer thread's copies of the stage have landed (its parity
// is the slot's use g / STAGES), and `done`, the count of stages the
// consumers have finished, so slot g % STAGES may be refilled for stage
// g + STAGES.  At g = K the whole block meets once: the forward sweep's y
// is in x, for the producers to copy back.  MODED (float32 only): every
// product in the matmul mode `mode`, the parts of v and r after the ring
// (6 NB more elements); the IEEE instantiations ignore `mode`.
template <typename T, int NB, bool ROWS, bool FULL, bool MODED>
__global__ void __launch_bounds__(SolveShape<T, NB>::THREADS)
tridiag_solve_kernel(const T* __restrict__ Ci, const T* __restrict__ Ek,
                     const T* __restrict__ rhs, T* x, int K, int nb,
                     int mode) {
  static_assert(!MODED || sizeof(T) == 4, "modes are float32 only");
  using S = SolveShape<T, NB>;
  const MmMode md = onephase::mm_mode(mode);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* done = reinterpret_cast<unsigned*>(smem_raw);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem_raw + 16);
  T* v = reinterpret_cast<T*>(full + 2 * S::STAGES);   // y_{k-1} / x_{k+1}
  T* r = v + NB;                                        // the residual
  T* ring = r + NB;
  T* vp = ring + S::STAGES * S::SLOT;   // MODED: the parts of v, then of r
  T* rp = vp + 3 * NB;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long blk = (long long)nb * nb;
  const T* Ci_b = Ci + (long long)b * K * blk;
  const T* Ek_b = Ek + (long long)b * (K - 1) * blk;
  const T* b_b = rhs + (long long)b * K * nb;
  T* x_b = x + (long long)b * K * nb;

  if (tid == 0) {
    for (int i = 0; i < S::STAGES; ++i)
      mbar_init(full + i, S::PT);   // every producer thread's copies
    *done = 0;
  }
  if (tid < NB) v[tid] = r[tid] = T(0);
  if (MODED && tid < 3 * NB) vp[tid] = rp[tid] = T(0);
  __syncthreads();

  if (tid < S::NC) {
    consume_sweep<T, NB, ROWS, FULL, true, MODED>(
        ring, full, done, Ci_b, Ek_b, x_b, v, r, vp, rp, K, nb, tid, md);
    block_sync<S::THREADS>();
    consume_sweep<T, NB, ROWS, FULL, false, MODED>(
        ring, full, done, Ci_b, Ek_b, x_b, v, r, vp, rp, K, nb, tid, md);
  } else {
    const int p = tid - S::NC;
    for (int g = 0; g < 2 * K; ++g) {
      if (g == K) block_sync<S::THREADS>();
      const bool fwd = g < K;
      const int k = fwd ? g : 2 * K - 1 - g;
      const int ke = fwd ? k - 1 : k;
      const int slot = g % S::STAGES;
      if (g >= S::STAGES) flag_wait(done, g - S::STAGES + 1);
      T* Ms = ring + slot * S::SLOT;
      T* Es = Ms + S::AREA;
      T* vs = Es + S::AREA;
      copy_block<T, NB, ROWS>(Ms, Ci_b + k * blk, nb, p);
      if (ke >= 0 && ke < K - 1)
        copy_block<T, NB, ROWS>(Es, Ek_b + ke * blk, nb, p);
      // b_k forward, y_k (in x since the turn) backward
      if (p < nb) cp_async(vs + p, (fwd ? b_b : x_b) + k * nb + p);
      mbar_arrive_on_copies(full + slot);
    }
  }
}

template <typename Kern>
int set_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int NB, int NT, bool MODED>
int launch_factor_nb(const void* Ad, const void* Bs, const void* delta,
                     void* Ck, void* Ci, void* Ek, void* ok, int B, int K,
                     int nb, int mode, void* stream) {
  const auto kernel = tridiag_factor_kernel<T, NB, NT, MODED>;
  const size_t smem = factor_smem<T, NB>();
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
      (const T*)Ad, (const T*)Bs, (const T*)delta, (T*)Ck, (T*)Ci, (T*)Ek,
      (int*)ok, K, nb, mode);
  return (int)cudaGetLastError();
}

template <typename T, bool MODED>
int launch_factor_mode(const void* Ad, const void* Bs, const void* delta,
                       void* Ck, void* Ci, void* Ek, void* ok, int B, int K,
                       int nb, int mode, void* stream) {
  if (nb <= 32)
    return launch_factor_nb<T, 32, 256, MODED>(Ad, Bs, delta, Ck, Ci, Ek, ok,
                                               B, K, nb, mode, stream);
  return launch_factor_nb<T, 64, 512, MODED>(Ad, Bs, delta, Ck, Ci, Ek, ok, B,
                                             K, nb, mode, stream);
}

// `mode`: a matmul mode's code (mm_mode.cuh), 0 = IEEE; float64 takes 0
// only, and a code without a moded variant is refused, never run as IEEE.
template <typename T>
int launch_factor(const void* Ad, const void* Bs, const void* delta, void* Ck,
                  void* Ci, void* Ek, void* ok, int B, int K, int nb,
                  int mode, void* stream) {
  if (nb > MAX_NB) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    return launch_factor_mode<T, false>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K,
                                        nb, 0, stream);
  if constexpr (sizeof(T) == 4) {
    if (onephase::mm_mode_valid(mode))
      return launch_factor_mode<T, true>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K,
                                         nb, mode, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int NB, bool ROWS, bool MODED>
int launch_solve_nb(const void* Ci, const void* Ek, const void* b, void* x,
                    int B, int K, int nb, int mode, void* stream) {
  using S = SolveShape<T, NB>;
  // unmasked where nb fills the block edge
  const auto kernel = nb == NB
                          ? tridiag_solve_kernel<T, NB, ROWS, true, MODED>
                          : tridiag_solve_kernel<T, NB, ROWS, false, MODED>;
  // the moded variant's parts of v and r after the ring
  const size_t smem = S::SMEM + (MODED ? 6 * NB * sizeof(T) : 0);
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<B, S::THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)Ci, (const T*)Ek, (const T*)b, (T*)x, K, nb, mode);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename T, bool MODED>
int launch_solve_mode(const void* Ci, const void* Ek, const void* b, void* x,
                      int B, int K, int nb, int mode, void* stream) {
  // the row layout where every row of every block is 16-byte aligned
  const bool rows = nb * sizeof(T) % 16 == 0 && aligned16(Ci) &&
                    aligned16(Ek);
  if (nb <= 32)
    return rows ? launch_solve_nb<T, 32, true, MODED>(Ci, Ek, b, x, B, K, nb,
                                                      mode, stream)
                : launch_solve_nb<T, 32, false, MODED>(Ci, Ek, b, x, B, K, nb,
                                                       mode, stream);
  return rows ? launch_solve_nb<T, 64, true, MODED>(Ci, Ek, b, x, B, K, nb,
                                                    mode, stream)
              : launch_solve_nb<T, 64, false, MODED>(Ci, Ek, b, x, B, K, nb,
                                                     mode, stream);
}

// `mode` as for launch_factor.
template <typename T>
int launch_solve(const void* Ci, const void* Ek, const void* b, void* x,
                 int B, int K, int nb, int mode, void* stream) {
  if (nb > MAX_NB) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    return launch_solve_mode<T, false>(Ci, Ek, b, x, B, K, nb, 0, stream);
  if constexpr (sizeof(T) == 4) {
    if (onephase::mm_mode_valid(mode))
      return launch_solve_mode<T, true>(Ci, Ek, b, x, B, K, nb, mode, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int op_tridiag_factor_f32(const void* Ad, const void* Bs,
                                     const void* delta, void* Ck, void* Ci,
                                     void* Ek, void* ok, int B, int K, int nb,
                                     int mode, void* stream) {
  return launch_factor<float>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb, mode,
                              stream);
}

extern "C" int op_tridiag_factor_f64(const void* Ad, const void* Bs,
                                     const void* delta, void* Ck, void* Ci,
                                     void* Ek, void* ok, int B, int K, int nb,
                                     int mode, void* stream) {
  return launch_factor<double>(Ad, Bs, delta, Ck, Ci, Ek, ok, B, K, nb, mode,
                               stream);
}

extern "C" int op_tridiag_solve_f32(const void* Ci, const void* Ek,
                                    const void* b, void* x, int B, int K,
                                    int nb, int mode, void* stream) {
  return launch_solve<float>(Ci, Ek, b, x, B, K, nb, mode, stream);
}

extern "C" int op_tridiag_solve_f64(const void* Ci, const void* Ek,
                                    const void* b, void* x, int B, int K,
                                    int nb, int mode, void* stream) {
  return launch_solve<double>(Ci, Ek, b, x, B, K, nb, mode, stream);
}
