// What K1's and K2's launchers (fused_q.cu, chol.cu) ask of the runtime
// once a device, not once a call: the card's SM count, and each kernel
// instantiation's dynamic shared memory attribute.  At the main path's
// shapes (n = 256, B = 16) a call's host work outlasted its kernel (PERF.md
// §6): a cudaDeviceGetAttribute and a cudaFuncSetAttribute a call were part
// of it.  Each cache is a value the runtime would return again, read or set
// once, by whichever thread comes first (setting an attribute twice is
// harmless).
#pragma once
#include <cuda_runtime.h>

#include <atomic>

namespace onephase {

constexpr int MAX_DEVICES = 64;

// the current device and its SM count (read once a device)
inline cudaError_t device_sms(int& dev, int& sms) {
  static std::atomic<int> cache[MAX_DEVICES];   // 0: not read yet
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int v = cache[dev].load(std::memory_order_relaxed);
  if (v == 0) {
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cache[dev].store(v, std::memory_order_relaxed);
  }
  sms = v;
  return cudaSuccess;
}

// The dynamic shared memory of `kernel` raised to `bytes` on the current
// device, once a device: `done` is the calling launcher's own mask of the
// devices already set (a static of the launcher's instantiation, so one
// mask a kernel instantiation and size).
template <typename F>
inline cudaError_t smem_once(F kernel, int bytes,
                             std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace onephase
