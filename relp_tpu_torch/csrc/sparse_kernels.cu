// Hopper (sm_90a) kernels of the sparse ELL constraint operator.
//
// Both compute one K-deep gather-reduction per output element over an ELL
// pool stored K-major (slot k of element j at data[k * n + j]):
//
//   ell_price:  d[j] = c[j] - sum_k data[k,j0+j] * y[idx[k,j0+j]]   (c given)
//               d[j] =        sum_k data[k,j0+j] * y[idx[k,j0+j]]   (c == NULL)
//     for j in a column window [j0, j0 + w) of the n-column pool (c holds
//     the window's w entries), and then either out[j] = d[j] or (c given, a
//     SelectArgs passed) the entering column chosen from d by the selection
//     epilogue (select_epilogue.cuh), with d never written: pricing
//     d = c - A^T pi, the devex pivot row alpha = A^T B^-1[r,:], and with a
//     window the one block of columns that partial pricing scans.
//     Replaces brick_pricing_pallas (relp_tpu/ops/pallas_kernels.py) and the
//     argmax that XLA fused onto its output.
//   ell_spmv:   y[i] = sum_k rdata[k,i] * x[rcols[k,i]]
//     over the row-major twin: A x.  Replaces brick_spmv_pallas
//     (relp_tpu/ops/pallas_kernels.py).
//
// What bounds them: bytes, and at the solver's shapes latency.  Each slot
// moves its value and its index (8 bytes in f32, 12 in f64) and nothing is
// reused except the gathered vector y / x.  ell_price at n = 32,768, K = 2,
// m = 4,096 moves 0.80 MB in f32 (0.24 us at 3.35 TB/s): the launch and the
// chain index load -> dependent gather bound it, not bandwidth.
//
// What the design of ell_price does about it: the TPU kernel tiles the pool
// into 8x128 bricks (a TPU register shape) and keeps the whole gathered
// vector in VMEM.  Here
// - y is staged once per block in shared memory when the caller says it fits
//   (16 KB at m = 4,096 in f32; up to the 227 KB a block may ask for), so a
//   gather is a shared-memory read that waits on no second trip to L2; a
//   larger y is gathered through the read-only cache (__ldg) as before;
// - a few blocks per SM at most, each striding over chunks of 4 * kThreads
//   columns, so y is staged once per block and not once per 256 columns;
// - a thread owns 4 neighbouring columns and reads their indices and values
//   with 16-byte loads, kSlots slots at a time, all issued before the first
//   gather.  A window that is not 16-byte aligned (j0 or n not a multiple of
//   4) runs the same kernel with 4- and 8-byte loads, threads on
//   neighbouring columns;
// - the selection epilogue: every thread scores its columns in registers and
//   the candidates meet through one slot per block.
// Padding slots hold (index 0, value 0) and contribute exactly zero.
// ell_spmv keeps one thread per output element walking its K slots in order
// (Kr = 31 slots deep at m = 4,096: the depth, not the width, is its work).
//
// Built by relp_tpu_torch/ops/cuda_build.py into a shared library with a
// plain C interface; every entry point launches on the given stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "select_epilogue.cuh"

namespace {

using relp::Cand;
using relp::SelectArgs;

constexpr int kThreads = 256;  // ell_spmv: one output element a thread
#ifndef RELP_ELL_THREADS
#define RELP_ELL_THREADS 128
#endif
constexpr int kPriceThreads = RELP_ELL_THREADS;  // ops/sparse_kernels.py: _PRICE_CHUNK
constexpr int kCols = 4;       // columns a thread of ell_price owns
constexpr int kSlots = 4;      // slots whose loads are issued together

template <typename T>
__global__ void ell_gather_sum_kernel(const T* __restrict__ data,
                                      const int32_t* __restrict__ idx,
                                      const T* __restrict__ y,
                                      T* __restrict__ out, int64_t n, int K) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int64_t s = static_cast<int64_t>(k) * n + j;
    acc += data[s] * __ldg(y + idx[s]);
  }
  out[j] = acc;
}

template <typename T>
struct PriceArgs {
  const T* data;
  const int32_t* idx;
  const T* y;
  const T* c;    // null: the sum alone
  T* out;        // null under the selection epilogue
  int64_t n, j0, w;
  int K;
  int m;         // length of y
  int vector;    // the window's slots are 16-byte aligned
};

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double (&x)[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void load4(const int32_t* p, int32_t (&x)[4]) {
  const int4 t = __ldg(reinterpret_cast<const int4*>(p));
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

// acc[e] = sum_k data[k, col_e] * y[idx[k, col_e]] for the thread's columns
// col_e = first + e * step (e < live), relative to the window.  VLOAD: the
// four columns are neighbours and their slots 16-byte aligned.
template <typename T, bool VLOAD, bool STAGED>
__device__ __forceinline__ void gather_sums(const PriceArgs<T>& a,
                                            const T* __restrict__ ys,
                                            int64_t first, int step, int live,
                                            T (&acc)[kCols]) {
  const T* __restrict__ dp = a.data + a.j0 + first;
  const int32_t* __restrict__ ip = a.idx + a.j0 + first;
  for (int k0 = 0; k0 < a.K; k0 += kSlots) {
    T val[kSlots][kCols];
    int32_t row[kSlots][kCols];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (k0 + u < a.K) {
        const int64_t off = static_cast<int64_t>(k0 + u) * a.n;
        if constexpr (VLOAD) {
          load4(ip + off, row[u]);
          load4(dp + off, val[u]);
        } else {
#pragma unroll
          for (int e = 0; e < kCols; ++e) {
            row[u][e] = e < live ? __ldg(ip + off + e * step) : 0;
            val[u][e] = e < live ? __ldg(dp + off + e * step) : T(0);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (k0 + u < a.K) {
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const T yv = STAGED ? ys[row[u][e]] : __ldg(a.y + row[u][e]);
          acc[e] += val[u][e] * yv;
        }
      }
    }
  }
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(kPriceThreads)
ell_price_kernel(PriceArgs<T> a, SelectArgs s, int select) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Cand warps_s[relp::kMaxWarps];
  __shared__ int flag_s;
  T* ys = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  if constexpr (STAGED) {
    // 16 bytes a load where y allows it (torch allocations do)
    constexpr int kPer = 16 / sizeof(T);
    const int vecs = reinterpret_cast<uintptr_t>(a.y) % 16 == 0 ? a.m / kPer : 0;
    const int4* y4 = reinterpret_cast<const int4*>(a.y);
    int4* ys4 = reinterpret_cast<int4*>(smem_raw);
#pragma unroll 8
    for (int i = tid; i < vecs; i += kPriceThreads) ys4[i] = __ldg(y4 + i);
    for (int i = vecs * kPer + tid; i < a.m; i += kPriceThreads) ys[i] = __ldg(a.y + i);
    __syncthreads();
  }
  const bool bland = select && *s.bland != 0;
  Cand best = relp::no_candidate();
  constexpr int64_t kChunk = static_cast<int64_t>(kPriceThreads) * kCols;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kChunk; base < a.w;
       base += static_cast<int64_t>(gridDim.x) * kChunk) {
    // the thread's columns, relative to the window: first + e * step, e < live
    const int64_t first = base + (a.vector ? tid * kCols : tid);
    const int step = a.vector ? 1 : kPriceThreads;
    int live = 0;
#pragma unroll
    for (int e = 0; e < kCols; ++e) live += (first + e * step < a.w) ? 1 : 0;
    if (live == 0) continue;
    // what the end of the pass reads, asked for before the gathers
    relp::SelectInputs<kCols> inputs;
    if (select) inputs.load(s, a.j0 + first, step, live);
    T cj[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      cj[e] = (a.c != nullptr && e < live) ? __ldg(a.c + first + e * step) : T(0);
    }
    T acc[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] = T(0);
    if (a.vector && live == kCols) {
      gather_sums<T, true, STAGED>(a, ys, first, step, live, acc);
    } else {
      gather_sums<T, false, STAGED>(a, ys, first, step, live, acc);
    }
    T d[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      d[e] = T(0);
      if (e < live) {
        const int64_t j = first + e * step;
        d[e] = a.c != nullptr ? cj[e] - acc[e] : acc[e];
        if (a.out != nullptr) a.out[j] = d[e];
      }
    }
    if (select) {
      const Cand mine = relp::best_of<T, kCols>(d, a.j0 + first, step, live, inputs, s, bland);
      if (relp::better(mine, best)) best = mine;
    }
  }
  if (!select) return;
  bool owner;
  best = relp::block_best(best, tid, kPriceThreads, warps_s, owner);
  relp::select_finish<T>(best, owner, s, blockIdx.x, gridDim.x, tid, kPriceThreads,
                         &flag_s, warps_s);
}

template <typename T>
int launch_price(const void* data, const void* idx, const void* y,
                 const void* c, void* out, int64_t n, int64_t j0, int64_t w,
                 int K, int64_t m, int blocks, int stage,
                 const SelectArgs* sel, void* stream) {
  if (w <= 0) return static_cast<int>(cudaGetLastError());
  if (blocks < 1 || m > INT32_MAX || (sel != nullptr && c == nullptr) ||
      (sel == nullptr && out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PriceArgs<T> a;
  a.data = static_cast<const T*>(data);
  a.idx = static_cast<const int32_t*>(idx);
  a.y = static_cast<const T*>(y);
  a.c = static_cast<const T*>(c);
  a.out = static_cast<T*>(out);
  a.n = n;
  a.j0 = j0;
  a.w = w;
  a.K = K;
  a.m = static_cast<int>(m);
  a.vector = reinterpret_cast<uintptr_t>(a.data) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(a.idx) % 16 == 0 && n % kCols == 0 &&
             j0 % kCols == 0;
  const SelectArgs sa = sel != nullptr ? *sel : SelectArgs{};
  const int select = sel != nullptr ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage) {
    const size_t bytes = static_cast<size_t>(m) * sizeof(T);
    if (bytes > 48 * 1024) {
      // above 48 KB a kernel has to opt in (per instantiation and device)
      const cudaError_t err = cudaFuncSetAttribute(
          ell_price_kernel<T, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024 - 2048);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    ell_price_kernel<T, true><<<blocks, kPriceThreads, bytes, st>>>(a, sa, select);
  } else {
    ell_price_kernel<T, false><<<blocks, kPriceThreads, 0, st>>>(a, sa, select);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spmv(const void* rdata, const void* rcols, const void* x, void* y,
                int64_t m, int K, void* stream) {
  if (m > 0) {
    const int64_t blocks = (m + kThreads - 1) / kThreads;
    ell_gather_sum_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(rdata), static_cast<const int32_t*>(rcols),
        static_cast<const T*>(x), static_cast<T*>(y), m, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int relp_ell_price_f32(const void* data, const void* rows, const void* y,
                       const void* c, void* out, int64_t n, int64_t j0,
                       int64_t w, int K, int64_t m, int blocks, int stage,
                       const SelectArgs* sel, void* stream) {
  return launch_price<float>(data, rows, y, c, out, n, j0, w, K, m, blocks,
                             stage, sel, stream);
}

int relp_ell_price_f64(const void* data, const void* rows, const void* y,
                       const void* c, void* out, int64_t n, int64_t j0,
                       int64_t w, int K, int64_t m, int blocks, int stage,
                       const SelectArgs* sel, void* stream) {
  return launch_price<double>(data, rows, y, c, out, n, j0, w, K, m, blocks,
                              stage, sel, stream);
}

int relp_ell_spmv_f32(const void* rdata, const void* rcols, const void* x,
                      void* y, int64_t m, int K, void* stream) {
  return launch_spmv<float>(rdata, rcols, x, y, m, K, stream);
}

int relp_ell_spmv_f64(const void* rdata, const void* rcols, const void* x,
                      void* y, int64_t m, int K, void* stream) {
  return launch_spmv<double>(rdata, rcols, x, y, m, K, stream);
}

}  // extern "C"
