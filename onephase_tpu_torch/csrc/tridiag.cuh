// The pieces K7 (the block-tridiagonal factor) and K5 (its solve) share
// between their sources: tridiag.cu holds their IEEE instantiations and the
// C entry points, tridiag_factor_mode.cu and tridiag_solve_mode.cu their
// matmul-mode instantiations (each source its own compiler, so the build
// takes the longest of them).  The kernels' design is told in tridiag.cu.
#pragma once
#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace onephase {

// The matmul-mode instantiations, float32: `mode` a code mm_mode_valid
// accepts (mm_mode.cuh), each code one instantiation; any other code
// returns cudaErrorInvalidValue and launches nothing.  `clk`: the clock
// rows of a clocked build (ignored in the kernels' library).  Arguments
// otherwise as op_tridiag_factor_f32 and op_tridiag_solve_f32.
int tridiag_factor_moded(const void* Ad, const void* Bs, const void* delta,
                         void* Ck, void* Ci, void* Ek, void* ok, int B,
                         int K, int nb, int mode, void* clk, void* stream);
int tridiag_solve_moded(const void* Ci, const void* Ek, const void* b,
                        void* x, int B, int K, int nb, int mode, void* clk,
                        void* stream);

}  // namespace onephase

namespace {

using onephase::tile_ld;

constexpr int MAX_NB = 64;

// Phase clocks (a measurement build only: ops/_build.py
// clock_library("tridiag") compiles the three sources with
// -DONEPHASE_TRIDIAG_CLOCKS; tridiag.cu's entry points are then
// op_tridiag_factor_clocks_f32 and op_tridiag_solve_clocks_f32).  Thread 0
// of each block reads clock64() at every phase boundary and adds the cycles
// since the last one to the phase that ended; at the end it writes them and
// the total to row blockIdx.x of the (blocks, TD_CLK_SLOTS) int64 buffer
// g_tridiag_clk (one a source: `set_clocks` points it at the caller's).
// The phases (ops/tridiag_pallas.py TRIDIAG_PHASES):
// K7: TD_WAIT the cp.async waits (in a moded kernel also the split of B_k),
// TD_A the product E_{k-1} E_{k-1}^T and S's write, TD_B the tile Cholesky
// and inverse (moded: and the split of Ci_k), TD_C the product B_k Ci_k^T,
// TD_D the stores of C_k, Ci_k, E_k (moded: and the split of E_k) and the
// stage's barrier; K5 (thread 0 is consumer lane 0): TD_WAIT the ring's
// full barriers, TD_A the first chain (E v) and r's write, TD_B the
// consumers' middle sync, TD_C the second chain (Ci r), TD_D the next
// stage's E read, the stage's end sync, the release and the store to x.
// TD_OTHER is the rest.
enum TdPhase { TD_OTHER = 0, TD_WAIT, TD_A, TD_B, TD_C, TD_D, TD_PHASES };
constexpr int TD_CLK_SLOTS = 8;   // the phases, the total
#ifdef ONEPHASE_TRIDIAG_CLOCKS
__device__ long long* g_tridiag_clk;
int set_clocks(void* clk, void* stream) {
  return (int)cudaMemcpyToSymbolAsync(g_tridiag_clk, &clk, sizeof(clk), 0,
                                      cudaMemcpyHostToDevice,
                                      (cudaStream_t)stream);
}
struct TdClock {
  long long acc[TD_PHASES];
  long long t0, last;
  int cur;
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int p = 0; p < TD_PHASES; ++p) acc[p] = 0;
    t0 = last = clock64();
    cur = TD_OTHER;
  }
  __device__ __forceinline__ void mark(int ph) {
    if (threadIdx.x == 0) {
      const long long t = clock64();
#pragma unroll
      for (int p = 0; p < TD_PHASES; ++p)
        if (p == cur) acc[p] += t - last;
      last = t;
      cur = ph;
    }
  }
  __device__ __forceinline__ void write() {
    mark(TD_OTHER);
    if (threadIdx.x == 0) {
      long long* row = g_tridiag_clk + (long long)blockIdx.x * TD_CLK_SLOTS;
#pragma unroll
      for (int p = 0; p < TD_PHASES; ++p) row[p] = acc[p];
      row[TD_PHASES] = last - t0;   // the phases' sum
    }
  }
};
#else
inline int set_clocks(void*, void*) { return 0; }
struct TdClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void write() {}
};
#endif

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

// The geometry of the solve at the compile-time block edge NB (32 or 64);
// PARTS > 0: a matmul mode's ring, each block's PARTS part planes in its
// slot (Ci_k's, then E's, then the vector), v's and r's parts after the
// ring.
template <typename T, int NB, int PARTS = 0>
struct SolveShape {
  static constexpr int E = 16 / (int)sizeof(T);   // elements a 16-byte copy
  static constexpr int LDR = NB + E;        // a slot row of the row layout
  static constexpr int NCW = NB / 32;       // consumer warps, lane t row t
  static constexpr int NC = 32 * NCW;
  static constexpr int PT = 3 * NC;         // producer threads
  static constexpr int THREADS = NC + PT;
  static constexpr int CR = NB / E;         // 16-byte chunks of a full row
  static constexpr int RS = PT / CR;        // rows one producer pass covers
  static constexpr int AREA = NB * LDR;     // one block (a part) of a slot
  static constexpr int PL = PARTS > 0 ? PARTS : 1;   // planes a block
  static constexpr int EOFF = PL * AREA;             // E's planes in a slot
  static constexpr int VOFF = 2 * PL * AREA;         // the vector's
  static constexpr int SLOT = 2 * PL * AREA + NB;    // Ci_k, E, vector
  static constexpr int SLOT_BYTES = SLOT * (int)sizeof(T);
  // ring depth: up to 8 stages within about 200 KB (a mode's, within 210
  // KB: two at NB = 64 with three parts)
  static constexpr int RING = (PARTS > 0 ? 210 : 200) * 1024;
  static constexpr int STAGES = RING / SLOT_BYTES < 8 ? RING / SLOT_BYTES : 8;
  // terms of a chain read into registers at once, and of Ci_k's row ahead
  // of the stage's middle sync
  static constexpr int CH = 128 / (int)sizeof(T) < NB ? 128 / (int)sizeof(T)
                                                       : NB;
  // the `done` counter (16 bytes), the full barriers (16 bytes each, so
  // what follows stays 16-byte aligned), v and r, then the ring
  static constexpr size_t SMEM = 16 + 16 * STAGES + 2 * NB * sizeof(T) +
                                 (size_t)STAGES * SLOT_BYTES +
                                 (PARTS > 0 ? 6 * NB * sizeof(T) : 0);
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
// store.
template <typename T, int NB, bool ROWS, bool FULL, bool FWD>
__device__ __forceinline__ void consume_sweep(
    const T* ring, unsigned long long* full, unsigned* done, const T* Ci_b,
    const T* Ek_b, T* x_b, T* v, T* r, int K, int nb, int t, TdClock& clk) {
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
  T e[NB];
  // wait for stage g's slot, then read its E row (column) into e
  auto take = [&](int g) {
    clk.mark(TD_WAIT);
    mbar_wait(full + g % S::STAGES, (g / S::STAGES) & 1);
    clk.mark(TD_D);
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
    clk.mark(TD_A);
    if (ke >= 0 && ke < K - 1) {
      T vv[NB];
#pragma unroll
      for (int c0 = 0; c0 < NB; c0 += 4) ld4(v + c0, vv + c0);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        if (live(c)) s = fma_t(e[c], vv[c], s);
    }
    if (own) r[t] = vs[t] - s;
    clk.mark(TD_B);
    consumer_sync<S::NCW>();
    clk.mark(TD_C);
    T y = T(0);
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
    if (own) v[t] = y;
    clk.mark(TD_D);
    if (g + 1 < g1) take(g + 1);
    consumer_sync<S::NCW>();
    if (t == 0) flag_store(done, g + 1);
    if (own) x_b[k * nb + t] = y;
  }
}

// --- the solve's matmul modes (float32; KIND and PASSES a mode's input
// type and pass count, mm_mode.cuh): the producers split each block they
// copied into its part planes in the ring slot, so the consumers' chains
// are loads and FMAs only, one accumulator a part pair.

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x at dst[i] split into its PARTS parts: part q at dst[i + q pstride]
// (part 0 in place)
template <int KIND, int PARTS>
__device__ __forceinline__ void split_at(float* dst, int i, int pstride) {
  float part[PARTS];
  onephase::mm_split_n<PARTS>(dst[i], KIND, part);
#pragma unroll
  for (int q = 0; q < PARTS; ++q) dst[i + q * pstride] = part[q];
}
// the same for the 16-byte chunk at dst + i (16-byte aligned): one 16-byte
// load and one 16-byte store a part, so a warp's chunks meet no bank
// conflict
template <int KIND, int PARTS>
__device__ __forceinline__ void split_chunk(float* dst, int i, int pstride) {
  float x[4];
  ld4(dst + i, x);
  float part[4][PARTS];
#pragma unroll
  for (int u = 0; u < 4; ++u) onephase::mm_split_n<PARTS>(x[u], KIND, part[u]);
#pragma unroll
  for (int q = 0; q < PARTS; ++q)
    *reinterpret_cast<float4*>(dst + i + q * pstride) =
        make_float4(part[0][q], part[1][q], part[2][q], part[3][q]);
}

// Split, in place, the entries of one block that producer thread p copied
// with copy_block (the same entries, once they have landed).
template <int NB, bool ROWS, int KIND, int PARTS>
__device__ __forceinline__ void split_block(float* dst, const float* src,
                                            int nb, int p) {
  using S = SolveShape<float, NB, PARTS>;
  if constexpr (ROWS) {
    const int j = p % S::CR;
    if (S::E * j >= nb) return;
#pragma unroll 2
    for (int r = p / S::CR; r < nb; r += S::RS)
      split_chunk<KIND, PARTS>(dst, r * S::LDR + S::E * j, S::AREA);
  } else {
    const int ph = block_phase<float, NB, false>(src);
    const int n = nb * nb;
    const int head = min((S::E - ph) % S::E, n);
    const int nch = (n - head) / S::E;
    const int tail = n - head - S::E * nch;
    dst += ph;
    if (p < head) split_at<KIND, PARTS>(dst, p, S::AREA);
#pragma unroll 2
    for (int q = p; q < nch; q += S::PT)
      split_chunk<KIND, PARTS>(dst, head + S::E * q, S::AREA);
    if (p < tail) split_at<KIND, PARTS>(dst, head + S::E * nch + p, S::AREA);
  }
}

// The pairs' sums added smallest first (ops/precision.py _sum_pairs).
template <int PASSES>
__device__ __forceinline__ float sum_pairs(const float (&acc)[PASSES]) {
  float s = acc[0];
#pragma unroll
  for (int q = 1; q < PASSES; ++q) s = s + acc[q];
  return s;
}

// Entry t of a vector, split, into its parts (part q at wp + q NB).
template <int KIND, int PARTS, int NB>
__device__ __forceinline__ void put_parts(float* wp, int t, float w) {
  float p[PARTS];
  onephase::mm_split_n<PARTS>(w, KIND, p);
#pragma unroll
  for (int q = 0; q < PARTS; ++q) wp[q * NB + t] = p[q];
}

// One sweep of a moded solve on the consumer warps: consume_sweep's
// stages, each chain sum_c m(A[t][c], w[c]) over all NB terms with one
// accumulator a part pair from +0 (PASSES independent chains of NB FMAs),
// the pairs then summed smallest first (the twin's precision.matmul
// order); A's parts from the slot's planes (part q at A + q AREA), w's
// from `wp` (part q at wp + q NB).  The terms past nb are not masked:
// there w's parts are zero (v and r are written only for t < nb) and A's
// are finite (the ring is zeroed once, and a slot holds only blocks'
// parts), so they add +-0.
template <int NB, bool ROWS, bool FWD, int KIND, int PASSES>
__device__ __forceinline__ void consume_sweep_moded(
    const float* ring, unsigned long long* full, unsigned* done,
    const float* Ci_b, const float* Ek_b, float* x_b, float* vp, float* rp,
    int K, int nb, int t, TdClock& clk) {
  constexpr int PARTS = onephase::mode_parts(PASSES);
  using S = SolveShape<float, NB, PARTS>;
  const long long blk = (long long)nb * nb;
  const int ld = ROWS ? S::LDR : nb;
  const bool own = t < nb;
  const int g0 = FWD ? 0 : K, g1 = FWD ? K : 2 * K;
  // sum over the pairs of the chain A (row t forward, column t backward)
  // with the parts at wp, in chunks of CHM terms: a chunk's parts are read
  // into registers before the chunk before it runs its FMAs
  constexpr int CHM = (PARTS == 1 ? 32 : PARTS == 2 ? 16 : 8) < NB
                          ? (PARTS == 1 ? 32 : PARTS == 2 ? 16 : 8) : NB;
  auto chain = [&](const float* A, const float* wp) {
    float acc[PASSES];
#pragma unroll
    for (int q = 0; q < PASSES; ++q) acc[q] = 0.0f;
    float a[2][PARTS][CHM], w[2][PARTS][CHM];
    auto load = [&](int h, float (&ah)[PARTS][CHM],
                    float (&wh)[PARTS][CHM]) {
#pragma unroll
      for (int q = 0; q < PARTS; ++q) {
        const float* Aq = A + q * S::AREA;
#pragma unroll
        for (int c0 = 0; c0 < CHM; c0 += 4) {
          if constexpr (FWD && ROWS) {
            ld4(Aq + t * ld + h + c0, ah[q] + c0);
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              ah[q][c0 + u] = FWD ? Aq[t * ld + h + c0 + u]
                                  : Aq[(h + c0 + u) * ld + t];
          }
          ld4(wp + q * NB + h + c0, wh[q] + c0);
        }
      }
    };
    load(0, a[0], w[0]);
#pragma unroll
    for (int h = 0; h < NB; h += CHM) {
      const int cur = (h / CHM) & 1;
      if (h + CHM < NB) load(h + CHM, a[cur ^ 1], w[cur ^ 1]);
#pragma unroll
      for (int c = 0; c < CHM; ++c)
#pragma unroll
        for (int q = 0; q < PASSES; ++q)
          acc[q] = fmaf(a[cur][onephase::pair_i(9 - PASSES + q)][c],
                        w[cur][onephase::pair_j(9 - PASSES + q)][c], acc[q]);
    }
    return sum_pairs<PASSES>(acc);
  };
  for (int g = g0; g < g1; ++g) {
    const int k = FWD ? g : 2 * K - 1 - g;
    const int ke = FWD ? k - 1 : k;
    clk.mark(TD_WAIT);
    mbar_wait(full + g % S::STAGES, (g / S::STAGES) & 1);
    clk.mark(TD_A);
    const float* slot = ring + (g % S::STAGES) * S::SLOT;
    float s = 0.0f;
    if (ke >= 0 && ke < K - 1)
      s = chain(slot + S::EOFF + block_phase<float, NB, ROWS>(Ek_b + ke * blk),
                vp);
    if (own) put_parts<KIND, PARTS, NB>(rp, t, slot[S::VOFF + t] - s);
    clk.mark(TD_B);
    consumer_sync<S::NCW>();
    clk.mark(TD_C);
    const float y =
        chain(slot + block_phase<float, NB, ROWS>(Ci_b + k * blk), rp);
    if (own) put_parts<KIND, PARTS, NB>(vp, t, y);
    clk.mark(TD_D);
    consumer_sync<S::NCW>();
    if (t == 0) flag_store(done, g + 1);
    if (own) x_b[k * nb + t] = y;
  }
}

// The producers of a moded solve: tridiag_solve_kernel's copies, each
// stage's one cp.async group a thread.  With LAG stages in flight, before
// it issues the next stage's copies a thread waits for the oldest stage's,
// splits the entries it copied into their part planes and arrives on that
// stage's full barrier (so the split never waits for a slot to free, and
// up to LAG stages' copies fly while it splits).  Every stage of the
// forward sweep is split before the block meets at the turn.
template <int NB, bool ROWS, int KIND, int PASSES>
__device__ __forceinline__ void produce_moded(
    float* ring, unsigned long long* full, const unsigned* done,
    const float* Ci_b, const float* Ek_b, const float* b_b, float* x_b,
    int K, int nb, int p) {
  constexpr int PARTS = onephase::mode_parts(PASSES);
  using S = SolveShape<float, NB, PARTS>;
  constexpr int LAG = S::STAGES - 1 < 3 ? S::STAGES - 1 : 3;
  const long long blk = (long long)nb * nb;
  auto finish = [&](int h) {
    const int k = h < K ? h : 2 * K - 1 - h;
    const int ke = h < K ? k - 1 : k;
    float* Ms = ring + (h % S::STAGES) * S::SLOT;
    split_block<NB, ROWS, KIND, PARTS>(Ms, Ci_b + k * blk, nb, p);
    if (ke >= 0 && ke < K - 1)
      split_block<NB, ROWS, KIND, PARTS>(Ms + S::EOFF, Ek_b + ke * blk, nb,
                                         p);
    mbar_arrive(full + h % S::STAGES);
  };
  int pend = 0;   // the first stage not yet split
  for (int g = 0; g < 2 * K; ++g) {
    if (g == K) {
      cp_async_wait_all();
      for (; pend < K; ++pend) finish(pend);
      block_sync<S::THREADS>();
    }
    if (g - pend == LAG) {
      cp_async_wait_group<LAG - 1>();
      finish(pend++);
    }
    const bool fwd = g < K;
    const int k = fwd ? g : 2 * K - 1 - g;
    const int ke = fwd ? k - 1 : k;
    float* Ms = ring + (g % S::STAGES) * S::SLOT;
    if (g >= S::STAGES) flag_wait(done, g - S::STAGES + 1);
    copy_block<float, NB, ROWS>(Ms, Ci_b + k * blk, nb, p);
    if (ke >= 0 && ke < K - 1)
      copy_block<float, NB, ROWS>(Ms + S::EOFF, Ek_b + ke * blk, nb, p);
    // b_k forward, y_k (in x since the turn) backward
    if (p < nb) cp_async(Ms + S::VOFF + p, (fwd ? b_b : x_b) + k * nb + p);
    cp_async_commit();
  }
  cp_async_wait_all();
  for (; pend < 2 * K; ++pend) finish(pend);
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
// is in x, for the producers to copy back.  PASSES > 0 (float32 only, the
// matmul mode of kind KIND and that pass count; the IEEE instantiations
// have KIND = PASSES = 0): every product in the mode, the blocks split by
// the producers (produce_moded, consume_sweep_moded), the parts of v and r
// after the ring, always masked (FULL false).
template <typename T, int NB, bool ROWS, bool FULL, int KIND, int PASSES>
__global__ void __launch_bounds__(SolveShape<T, NB>::THREADS)
tridiag_solve_kernel(const T* __restrict__ Ci, const T* __restrict__ Ek,
                     const T* __restrict__ rhs, T* x, int K, int nb) {
  static_assert(PASSES == 0 || (sizeof(T) == 4 && !FULL),
                "modes: float32, masked");
  using S = SolveShape<T, NB, PASSES ? onephase::mode_parts(PASSES) : 0>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* done = reinterpret_cast<unsigned*>(smem_raw);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem_raw + 16);
  T* v = reinterpret_cast<T*>(full + 2 * S::STAGES);   // y_{k-1} / x_{k+1}
  T* r = v + NB;                                        // the residual
  T* ring = r + NB;
  [[maybe_unused]] T* vp = ring + S::STAGES * S::SLOT;   // moded: v's parts
  [[maybe_unused]] T* rp = vp + 3 * NB;                   // and r's

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
  if constexpr (PASSES > 0) {
    if (tid < 3 * NB) vp[tid] = rp[tid] = T(0);
    for (int e = tid; e < S::STAGES * S::SLOT; e += S::THREADS) ring[e] = T(0);
  }
  TdClock clk;
  clk.start();
  __syncthreads();

  if constexpr (PASSES > 0) {
    if (tid < S::NC) {
      consume_sweep_moded<NB, ROWS, true, KIND, PASSES>(
          ring, full, done, Ci_b, Ek_b, x_b, vp, rp, K, nb, tid, clk);
      clk.mark(TD_OTHER);
      block_sync<S::THREADS>();
      consume_sweep_moded<NB, ROWS, false, KIND, PASSES>(
          ring, full, done, Ci_b, Ek_b, x_b, vp, rp, K, nb, tid, clk);
      clk.write();
    } else {
      produce_moded<NB, ROWS, KIND, PASSES>(ring, full, done, Ci_b, Ek_b,
                                            b_b, x_b, K, nb, tid - S::NC);
    }
  } else if (tid < S::NC) {
    consume_sweep<T, NB, ROWS, FULL, true>(ring, full, done, Ci_b, Ek_b,
                                           x_b, v, r, K, nb, tid, clk);
    clk.mark(TD_OTHER);
    block_sync<S::THREADS>();
    consume_sweep<T, NB, ROWS, FULL, false>(ring, full, done, Ci_b, Ek_b,
                                            x_b, v, r, K, nb, tid, clk);
    clk.write();
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

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace
