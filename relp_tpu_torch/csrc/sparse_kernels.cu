// Hopper (sm_90a) kernels of the sparse ELL constraint operator.
//
// Both kernels compute one K-deep gather-reduction per output element over
// an ELL pool stored K-major (slot k of element j at data[k * n + j]):
//
//   ell_price:  out[j] = c[j] - sum_k data[k,j] * y[idx[k,j]]   (c given)
//               out[j] =        sum_k data[k,j] * y[idx[k,j]]   (c == NULL)
//     over the column pool: pricing d = c - A^T pi, and the devex pivot
//     row alpha = A^T B^-1[r,:].  Replaces brick_pricing_pallas
//     (relp_tpu/ops/pallas_kernels.py).
//   ell_spmv:   y[i] = sum_k rdata[k,i] * x[rcols[k,i]]
//     over the row-major twin: A x.  Replaces brick_spmv_pallas
//     (relp_tpu/ops/pallas_kernels.py).
//
// What bounds them: both are memory-bound gathers.  Each slot moves its
// value and its index (12 bytes in f32, 16 in f64 with the gathered operand)
// and nothing is reused except the gathered vector y / x.  At the solver's
// shapes (n ~ 32k columns, K = 2) a launch moves under 1 MB, so launch
// latency bounds them, not bandwidth.
//
// What the design does about it: the TPU kernels tile the pool into 8x128
// bricks (a TPU register shape) and keep the whole gathered vector in VMEM.
// Here one thread owns one output element and walks its K slots in
// ascending order; the K-major layout makes neighbouring threads read
// neighbouring addresses, so every slot load is coalesced, and the gathered
// vector goes through the read-only cache (__ldg), which holds it (32 KB at
// m = 4096 in f64) after first touch.  Padding slots hold (index 0, value
// 0) and contribute exactly zero.  Later work: stage y in shared memory,
// fuse the masked devex argmax into pricing, capture the step in a graph.
//
// Built by relp_tpu_torch/ops/cuda_build.py into a shared library with a
// plain C interface; every entry point launches on the given stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void ell_gather_sum_kernel(const T* __restrict__ data,
                                      const int32_t* __restrict__ idx,
                                      const T* __restrict__ y,
                                      const T* __restrict__ c,
                                      T* __restrict__ out, int64_t n, int K) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int64_t s = static_cast<int64_t>(k) * n + j;
    acc += data[s] * __ldg(y + idx[s]);
  }
  out[j] = (c != nullptr) ? c[j] - acc : acc;
}

template <typename T>
int launch(const void* data, const void* idx, const void* y, const void* c,
           void* out, int64_t n, int K, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    ell_gather_sum_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(data), static_cast<const int32_t*>(idx),
        static_cast<const T*>(y), static_cast<const T*>(c),
        static_cast<T*>(out), n, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int relp_ell_price_f32(const void* data, const void* rows, const void* y,
                       const void* c, void* out, int64_t n, int K,
                       void* stream) {
  return launch<float>(data, rows, y, c, out, n, K, stream);
}

int relp_ell_price_f64(const void* data, const void* rows, const void* y,
                       const void* c, void* out, int64_t n, int K,
                       void* stream) {
  return launch<double>(data, rows, y, c, out, n, K, stream);
}

int relp_ell_spmv_f32(const void* rdata, const void* rcols, const void* x,
                      void* y, int64_t m, int K, void* stream) {
  return launch<float>(rdata, rcols, x, nullptr, y, m, K, stream);
}

int relp_ell_spmv_f64(const void* rdata, const void* rcols, const void* x,
                      void* y, int64_t m, int K, void* stream) {
  return launch<double>(rdata, rcols, x, nullptr, y, m, K, stream);
}

}  // extern "C"
