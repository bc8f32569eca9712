// What K3's inverse kernels share: the IEEE instantiations (tri_inv.cu) and
// the matmul-mode ones (tri_inv_mode.cuh, which tri_inv.cu includes).  The
// grid and the tiling are the same in both: a block takes one instance and
// TC columns of L^-1 and walks their rows in RC-row chunks (the IEEE
// kernel two chunks at a time).
#pragma once
#include <cuda_runtime.h>

namespace onephase {

constexpr int TI_TC = 64;         // columns per block
constexpr int TI_RC = 32;         // rows per chunk = k rows per staged slab
constexpr int TI_THREADS = 256;   // 8 warps

// Li's solved rows, read back through L2.  Volatile with a memory clobber,
// so the load stays after the barrier that orders this block's stores.
__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ double ld_cg(const double* p) {
  double v;
  asm volatile("ld.global.cg.f64 %0, [%1];" : "=d"(v) : "l"(p) : "memory");
  return v;
}

// Phase clocks (a measurement build only: ops/_build.py
// clock_library("tri_inv") compiles tri_inv.cu, and with it
// tri_inv_mode.cuh, with -DONEPHASE_TRI_INV_CLOCKS, whose one entry point
// is op_tri_inv_clocks_f32).
// Thread 0 of each block, which is one of the substitution's threads,
// reads clock64() at every phase boundary and adds the cycles since the
// last one to the phase that ended; at the end it writes them and the
// total to row blockIdx.x + gridDim.x blockIdx.y of the (blocks,
// TI_CLK_SLOTS) int64 buffer `g_tri_inv_clk` (`set_tri_inv_clocks` points
// it at the caller's).  The phases
// (ops/cholesky.py TRI_INV_PHASES): TI_LOAD the slab loads, their stores
// to shared memory (a moded kernel: and their split) and the barriers;
// TI_UPDATE the update product; TI_SOLVE a chunk's right-hand side and its
// substitution; TI_STORE the zeros above the diagonal block and the solved
// rows' stores; TI_OTHER the rest.
enum TiPhase { TI_OTHER = 0, TI_LOAD, TI_UPDATE, TI_SOLVE, TI_STORE,
               TI_PHASES };
constexpr int TI_CLK_SLOTS = 8;   // the phases, the total

}  // namespace onephase

namespace {
#ifdef ONEPHASE_TRI_INV_CLOCKS
__device__ long long* g_tri_inv_clk;
inline int set_tri_inv_clocks(void* clk, void* stream) {
  return (int)cudaMemcpyToSymbolAsync(g_tri_inv_clk, &clk, sizeof(clk), 0,
                                      cudaMemcpyHostToDevice,
                                      (cudaStream_t)stream);
}
struct TiClock {
  long long acc[onephase::TI_PHASES];
  long long t0, last;
  int cur;
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int p = 0; p < onephase::TI_PHASES; ++p) acc[p] = 0;
    t0 = last = clock64();
    cur = onephase::TI_OTHER;
  }
  __device__ __forceinline__ void mark(int ph) {
    if (threadIdx.x == 0) {
      const long long t = clock64();
#pragma unroll
      for (int p = 0; p < onephase::TI_PHASES; ++p)
        if (p == cur) acc[p] += t - last;
      last = t;
      cur = ph;
    }
  }
  __device__ __forceinline__ void write() {
    mark(onephase::TI_OTHER);
    if (threadIdx.x == 0) {
      long long* row =
          g_tri_inv_clk + ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                              onephase::TI_CLK_SLOTS;
#pragma unroll
      for (int p = 0; p < onephase::TI_PHASES; ++p) row[p] = acc[p];
      row[onephase::TI_PHASES] = last - t0;   // the phases' sum
    }
  }
};
#else
struct TiClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void write() {}
};
#endif
}  // namespace
