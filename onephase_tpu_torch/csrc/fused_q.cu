// C entry points of the fused Schur-formation kernel (see fused_q.cuh).
#include "fused_q.cuh"

extern "C" int op_fused_q_f32(const void* Jc, long long jc_bs, const void* w,
                              const void* H, long long h_bs, const void* bnd,
                              void* Q, int B, int m, int n, int lower,
                              void* stream) {
  return onephase::launch_fused_q<float>(Jc, jc_bs, w, H, h_bs, bnd, Q, B, m,
                                         n, lower, stream);
}

extern "C" int op_fused_q_f64(const void* Jc, long long jc_bs, const void* w,
                              const void* H, long long h_bs, const void* bnd,
                              void* Q, int B, int m, int n, int lower,
                              void* stream) {
  return onephase::launch_fused_q<double>(Jc, jc_bs, w, H, h_bs, bnd, Q, B, m,
                                          n, lower, stream);
}
