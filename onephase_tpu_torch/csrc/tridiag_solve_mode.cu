// K5's matmul-mode instantiations: the block-tridiagonal solve of
// tridiag.cu (its warp roles, ring and handoffs; the kernel template is
// tridiag.cuh's tridiag_solve_kernel) with every product of two entries in
// a `matmul_precision` mode (mm_mode.cuh, ops/precision.py; float32 only),
// one kernel a mode, block edge and layout, the mode's input type KIND and
// pass count PASSES template parameters chosen by a switch outside the
// kernel.  Replaces, in these modes, the TPU kernel
// onephase_tpu/ops/tridiag_pallas.py: pallas_tridiag_solve (_fwd_kernel
// :157-172, _bwd_kernel :175-190), whose dots take no `precision`.
//
// What bounds it: as in IEEE, the 2K dependent stages, each two chains (E
// v, then Ci r).  What the design does about it (tridiag.cuh,
// produce_moded and consume_sweep_moded):
// - The producer warps, three for each consumer warp and idle while their
//   copies fly, split each block once: after a stage's cp.async group
//   lands (up to three stages later, so copies stay in flight), each
//   producer thread splits the entries it copied into the slot's part
//   planes (part 0 in place), then arrives on the stage's full barrier.
//   The ring holds PARTS planes a block: 8, 8 and 7 stages at NB = 32,
//   6, 3 and 2 at NB = 64, with 1, 2 and 3 parts (within about 210 KB).
// - The consumers' chains are loads and FMAs only: one accumulator a part
//   pair, from +0, so a chain is PASSES independent chains of NB FMAs (not
//   one of PASSES nb), unrolled, the pairs summed smallest first after it
//   (the twin's precision.matmul order, so an entry that is one product is
//   that exact product); v and r are split once, by the lane that writes
//   each entry, into parts in shared memory that every lane reads 16 bytes
//   at a time.
// An earlier version split each E and Ci term in the consumer's chain:
// 0.57-1.15 ms in the one-product modes, 2.1-3.2 ms with 3-9 products at
// K = 400, nb = 32 (H100; the split's conversions issue-bound the lone
// consumer warp).
#include <cuda_runtime.h>

#include "tridiag.cuh"

namespace {

template <int NB, bool ROWS, int KIND, int PASSES>
int launch_nb(const void* Ci, const void* Ek, const void* b, void* x, int B,
              int K, int nb, void* stream) {
  using S = SolveShape<float, NB, onephase::mode_parts(PASSES)>;
  const auto kernel = tridiag_solve_kernel<float, NB, ROWS, false, KIND,
                                           PASSES>;
  int err = set_smem(kernel, S::SMEM);
  if (err) return err;
  kernel<<<B, S::THREADS, S::SMEM, (cudaStream_t)stream>>>(
      (const float*)Ci, (const float*)Ek, (const float*)b, (float*)x, K, nb);
  return (int)cudaGetLastError();
}

template <int KIND, int PASSES>
int launch_mode(const void* Ci, const void* Ek, const void* b, void* x,
                int B, int K, int nb, void* stream) {
  // the row layout where every row of every block is 16-byte aligned
  const bool rows = nb * sizeof(float) % 16 == 0 && aligned16(Ci) &&
                    aligned16(Ek);
  if (nb <= 32)
    return rows ? launch_nb<32, true, KIND, PASSES>(Ci, Ek, b, x, B, K, nb,
                                                    stream)
                : launch_nb<32, false, KIND, PASSES>(Ci, Ek, b, x, B, K, nb,
                                                     stream);
  return rows ? launch_nb<64, true, KIND, PASSES>(Ci, Ek, b, x, B, K, nb,
                                                  stream)
              : launch_nb<64, false, KIND, PASSES>(Ci, Ek, b, x, B, K, nb,
                                                   stream);
}

}  // namespace

namespace onephase {

// One instantiation a code mm_mode_valid accepts (16 kind + passes; the
// card modes of ops/precision.py CARD_MODES); any other is refused.
int tridiag_solve_moded(const void* Ci, const void* Ek, const void* b,
                        void* x, int B, int K, int nb, int mode, void* clk,
                        void* stream) {
  if (nb > MAX_NB) return (int)cudaErrorInvalidValue;
  if (int err = set_clocks(clk, stream)) return err;
  switch (mode) {
    case 0x11: return launch_mode<1, 1>(Ci, Ek, b, x, B, K, nb, stream);
    case 0x13: return launch_mode<1, 3>(Ci, Ek, b, x, B, K, nb, stream);
    case 0x21: return launch_mode<2, 1>(Ci, Ek, b, x, B, K, nb, stream);
    case 0x23: return launch_mode<2, 3>(Ci, Ek, b, x, B, K, nb, stream);
    case 0x26: return launch_mode<2, 6>(Ci, Ek, b, x, B, K, nb, stream);
    case 0x29: return launch_mode<2, 9>(Ci, Ek, b, x, B, K, nb, stream);
    case 0x31: return launch_mode<3, 1>(Ci, Ek, b, x, B, K, nb, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace onephase
