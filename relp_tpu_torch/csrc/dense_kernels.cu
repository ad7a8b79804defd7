// Hopper (sm_90a) kernel of the dense constraint operator: dense_price.
//
// For a row-major, contiguous A[m, lda] (the DenseMatrix layout) and a
// column window [j0, j0 + w):
//
//   out[j] = c[j] - sum_i v[i] * A[i, j0 + j]   (c given, length w)
//   out[j] =        sum_i v[i] * A[i, j0 + j]   (c == NULL)
//
// It prices the dense operator: d = c - A^T pi in f64 (the fallback pass),
// the f32 scan c - A^T v and the f32 devex pivot row A^T B^-1[r,:], and with
// a window the one block of columns that partial pricing scans.  Replaces
// pricing_kernel (tools/probe_pallas.py), whose grid of 256-column blocks
// is the window here.
//
// What bounds it: a matrix-vector product reads every entry of the window
// once and reuses nothing but v, so it is bound by device-memory bandwidth
// at large shapes (2048 x 16384 f32 is 128 MiB) and by launch latency at
// the solver's dense shapes (768 x 1536 f32 is 4.5 MiB).
//
// What the design does about it: neighbouring threads take neighbouring
// columns and walk the rows, so every row segment a warp reads is one
// coalesced 128-byte (f32) or 256-byte (f64) load.  v is staged in shared
// memory in tiles of kStage rows.  A block owns kCols columns and splits its
// rows over kWarps warps; a narrow window (n = 1536 gives only 48 column
// blocks for 132 SMs) also splits the rows over a second grid dimension of
// `slices`.  Partial sums are combined in a fixed order -- the warps of a
// block in shared memory, then the slices in a second small kernel -- and
// never with atomics, so the result is the same from run to run and pivot
// choices repeat.  Later work: wider loads (TMA), a fused devex argmax.
//
// Built by relp_tpu_torch/ops/cuda_build.py into a shared library with a
// plain C interface; every entry point launches on the given stream, does
// not synchronise, allocates nothing (the caller passes the `partial`
// scratch of slices * w elements when slices > 1), and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;     // columns of a block: one warp-wide row segment
constexpr int kWarps = 8;     // warps that split a block's rows
constexpr int kStage = 1024;  // rows of v staged in shared memory at a time
constexpr int kFinishThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCols * kWarps)
dense_colsum_kernel(const T* __restrict__ A, const T* __restrict__ v,
                    const T* __restrict__ c, T* __restrict__ out,
                    T* __restrict__ partial, int m, int64_t lda, int64_t j0,
                    int64_t w, int rows_per_slice) {
  __shared__ T v_s[kStage];
  __shared__ T red[kWarps][kCols];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kCols + tx;
  const bool live = j < w;
  const int row_begin = static_cast<int>(blockIdx.y) * rows_per_slice;
  const int row_end = min(m, row_begin + rows_per_slice);
  const T* __restrict__ col = A + j0 + (live ? j : 0);

  T acc = T(0);
  for (int base = row_begin; base < row_end; base += kStage) {
    const int len = min(kStage, row_end - base);
    for (int t = ty * kCols + tx; t < len; t += kCols * kWarps) {
      v_s[t] = v[base + t];
    }
    __syncthreads();
    if (live) {
      for (int t = ty; t < len; t += kWarps) {
        acc += v_s[t] * col[static_cast<int64_t>(base + t) * lda];
      }
    }
    __syncthreads();
  }
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && live) {
    T sum = red[0][tx];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) sum += red[k][tx];
    if (partial != nullptr) {
      partial[static_cast<int64_t>(blockIdx.y) * w + j] = sum;
    } else {
      out[j] = (c != nullptr) ? c[j] - sum : sum;
    }
  }
}

template <typename T>
__global__ void dense_finish_kernel(const T* __restrict__ partial,
                                    const T* __restrict__ c,
                                    T* __restrict__ out, int64_t w,
                                    int slices) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= w) return;
  T sum = partial[j];
  for (int s = 1; s < slices; ++s) sum += partial[static_cast<int64_t>(s) * w + j];
  out[j] = (c != nullptr) ? c[j] - sum : sum;
}

template <typename T>
int launch(const void* A, const void* v, const void* c, void* out,
           void* partial, int m, int64_t lda, int64_t j0, int64_t w,
           int slices, int rows_per_slice, void* stream) {
  if (w <= 0) return static_cast<int>(cudaGetLastError());
  if (slices < 1 || rows_per_slice < 1 || (slices > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kCols, kWarps);
  const dim3 grid(static_cast<unsigned>((w + kCols - 1) / kCols),
                  static_cast<unsigned>(slices));
  T* dst_partial = slices > 1 ? static_cast<T*>(partial) : nullptr;
  dense_colsum_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(A), static_cast<const T*>(v),
      static_cast<const T*>(c), static_cast<T*>(out), dst_partial, m, lda, j0,
      w, rows_per_slice);
  if (slices > 1) {
    const int64_t blocks = (w + kFinishThreads - 1) / kFinishThreads;
    dense_finish_kernel<T><<<static_cast<unsigned>(blocks), kFinishThreads, 0,
                             s>>>(dst_partial, static_cast<const T*>(c),
                                  static_cast<T*>(out), w, slices);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int relp_dense_price_f32(const void* A, const void* v, const void* c,
                         void* out, void* partial, int m, int64_t lda,
                         int64_t j0, int64_t w, int slices, int rows_per_slice,
                         void* stream) {
  return launch<float>(A, v, c, out, partial, m, lda, j0, w, slices,
                       rows_per_slice, stream);
}

int relp_dense_price_f64(const void* A, const void* v, const void* c,
                         void* out, void* partial, int m, int64_t lda,
                         int64_t j0, int64_t w, int slices, int rows_per_slice,
                         void* stream) {
  return launch<double>(A, v, c, out, partial, m, lda, j0, w, slices,
                        rows_per_slice, stream);
}

}  // extern "C"
