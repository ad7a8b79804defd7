// Hopper (sm_90a) toolchain probe: probe_scale, out[i] = 2 * x[i].
//
// Replaces f32_kernel and f64_kernel (tools/probe_pallas.py), which checked
// that Pallas compiled an f32 and an f64 elementwise kernel on the TPU.
// Here the same two products, one instantiation per type, check that a
// machine's nvcc, driver and ctypes binding work end to end
// (python -m relp_tpu_torch.probe).  An elementwise pass is bound by
// device memory; at the probe's [8, 128] it is one launch's latency.  One
// thread per element, neighbouring threads on neighbouring addresses.
//
// Built by relp_tpu_torch/ops/cuda_build.py; the entry points launch on the
// given stream, allocate nothing, and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void scale2_kernel(const T* __restrict__ x, T* __restrict__ out,
                              int64_t n) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * T(2);
}

template <typename T>
int launch(const void* x, void* out, int64_t n, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    scale2_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int relp_probe_scale_f32(const void* x, void* out, int64_t n, void* stream) {
  return launch<float>(x, out, n, stream);
}

int relp_probe_scale_f64(const void* x, void* out, int64_t n, void* stream) {
  return launch<double>(x, out, n, stream);
}

}  // extern "C"
