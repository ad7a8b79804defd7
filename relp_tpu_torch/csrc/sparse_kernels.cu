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
// - a few blocks per SM at most, each striding over chunks of 4 * kPriceThreads
//   columns, so y is staged once per block and not once per 256 columns;
// - a thread owns 4 neighbouring columns and reads their indices and values
//   with 16-byte loads, kSlots slots at a time, all issued before the first
//   gather.  A window that is not 16-byte aligned (j0 or n not a multiple of
//   4) runs the same kernel with 4- and 8-byte loads, threads on
//   neighbouring columns;
// - the selection epilogue: every thread scores its columns in registers and
//   the candidates meet through one slot per block.
// Padding slots hold (index 0, value 0) and contribute exactly zero.
//
// What the design of ell_spmv does about it.  The row twin is few rows deep
// in slots (Kr = 31 at m = 4,096, n = 32,768): one thread a row is 16 blocks
// on a card of 132 SMs, each thread a chain of 31 index loads with a
// dependent gather behind every one.  The TPU kernel walks 8x128 bricks of
// rows with the whole x in VMEM.  Here
// - a row's Kr slots are cut into S segments of L slots that different
//   threads take, so a launch has about m * S work items; a block is
//   (row threads) x (S segments) with the row index on threadIdx.x, so
//   neighbouring threads read neighbouring addresses of rdata[k, .] and
//   rcols[k, .];
// - a thread issues the index and value loads of a whole batch of slots
//   before the first gather (4 slots x 4 neighbouring rows with 16-byte
//   loads where m % 4 == 0 and the pools are aligned; 8 slots of one row
//   otherwise, the scalar edge path of the same kernel);
// - the S partial sums of a row meet in shared memory and one thread adds
//   them in the order s = 0 .. S-1: no atomics, the same bits every run
//   (another order than k = 0 .. Kr-1, so it agrees with the plain version
//   within rounding, not bit for bit);
// - x is not staged.  ell_price has a few blocks that each reuse a 16-32 KB
//   y; here there are many blocks and x is n long (256 KB in f64 at
//   n = 32,768, more than the 227 KB a block may hold), so every block
//   staging x would move blocks * n values where the gathers move m * Kr:
//   more bytes than the gathers themselves.  x is gathered through the
//   read-only path (__ldg) and lives in L2.
// S, L and the block's shape come from ops/sparse_kernels.py (spmv_plan).
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

#ifndef RELP_ELL_THREADS
#define RELP_ELL_THREADS 128
#endif
constexpr int kPriceThreads = RELP_ELL_THREADS;  // ops/sparse_kernels.py: _PRICE_CHUNK
constexpr int kSpmvMaxThreads = 512;  // of an ell_spmv block (row threads x segments)
constexpr int kCols = 4;       // columns a thread of ell_price owns
constexpr int kSlots = 4;      // slots whose loads are issued together

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

// ell_spmv: block (TX row threads, S segments); thread (tx, s) sums the slots
// [s * L, min(K, (s + 1) * L)) of its R rows.  R == 4 with `vector`: the 4
// neighbouring rows 4 * tx .. 4 * tx + 3 of the block's chunk, 16-byte
// loads; otherwise the rows tx + e * TX, 4- and 8-byte loads.  part[s][row]
// in shared memory (S > 1) holds the partial sums.  kBatch slots have their
// loads issued together: 2 for segments of at most 2 slots, else 4 (R == 4)
// or 8 (R == 1).
template <typename T, int R, int kBatch>
__global__ void __launch_bounds__(kSpmvMaxThreads) ell_spmv_kernel(const T* __restrict__ rdata,
                                const int32_t* __restrict__ rcols,
                                const T* __restrict__ x, T* __restrict__ y,
                                int64_t m, int K, int L, int vector) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* part = reinterpret_cast<T*>(smem_raw);
  const int TX = blockDim.x, S = blockDim.y;
  const int tx = threadIdx.x, s = threadIdx.y;
  const int rows_blk = TX * R;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * rows_blk;
  const bool vec = R == 4 && vector != 0;
  const int local = vec ? tx * R : tx;
  const int step = vec ? 1 : TX;
  const int64_t first = base + local;
  int live = 0;
#pragma unroll
  for (int e = 0; e < R; ++e) live += (first + e * step < m) ? 1 : 0;
  T acc[R];
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] = T(0);
  const int k_lo = s * L;
  const int k_hi = min(K, k_lo + L);
  if (live > 0) {
    const T* __restrict__ dp = rdata + first;
    const int32_t* __restrict__ ip = rcols + first;
    for (int k0 = k_lo; k0 < k_hi; k0 += kBatch) {
      T val[kBatch][R];
      int32_t col[kBatch][R];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k0 + u < k_hi) {
          const int64_t off = static_cast<int64_t>(k0 + u) * m;
          bool wide = false;
          if constexpr (R == 4) {
            if (vec && live == R) {
              load4(ip + off, col[u]);
              load4(dp + off, val[u]);
              wide = true;
            }
          }
          if (!wide) {
#pragma unroll
            for (int e = 0; e < R; ++e) {
              col[u][e] = e < live ? __ldg(ip + off + e * step) : 0;
              val[u][e] = e < live ? __ldg(dp + off + e * step) : T(0);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k0 + u < k_hi) {
#pragma unroll
          for (int e = 0; e < R; ++e) acc[e] += val[u][e] * __ldg(x + col[u][e]);
        }
      }
    }
  }
  if (S == 1) {
#pragma unroll
    for (int e = 0; e < R; ++e) {
      if (e < live) y[first + e * step] = acc[e];
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < R; ++e) part[s * rows_blk + local + e * step] = acc[e];
  __syncthreads();
  // one thread a row adds the S partial sums, always in the order 0 .. S-1
  for (int r = s * TX + tx; r < rows_blk; r += TX * S) {
    if (base + r < m) {
      T sum = part[r];
      for (int q = 1; q < S; ++q) sum += part[q * rows_blk + r];
      y[base + r] = sum;
    }
  }
}

template <typename T>
int launch_spmv(const void* rdata, const void* rcols, const void* x, void* y,
                int64_t m, int K, int S, int L, int TX, int R, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  // every slot in exactly one segment, no segment empty
  if (K < 1 || S < 1 || L < 1 || TX < 1 || (R != 1 && R != 4) ||
      static_cast<int64_t>(S) * L < K || static_cast<int64_t>(S - 1) * L >= K ||
      static_cast<int64_t>(TX) * S > kSpmvMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = S > 1 ? static_cast<size_t>(S) * TX * R * sizeof(T) : 0;
  const int64_t rows_blk = static_cast<int64_t>(TX) * R;
  const int64_t blocks = (m + rows_blk - 1) / rows_blk;
  if (smem > 48 * 1024 || blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vector = R == 4 && m % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(rdata) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(rcols) % 16 == 0;
  const dim3 block(TX, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* d = static_cast<const T*>(rdata);
  const int32_t* c = static_cast<const int32_t*>(rcols);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (R == 4 && L <= 2) {
    ell_spmv_kernel<T, 4, 2><<<grid, block, smem, st>>>(d, c, xv, yv, m, K, L, vector);
  } else if (R == 4) {
    ell_spmv_kernel<T, 4, 4><<<grid, block, smem, st>>>(d, c, xv, yv, m, K, L, vector);
  } else if (L <= 2) {
    ell_spmv_kernel<T, 1, 2><<<grid, block, smem, st>>>(d, c, xv, yv, m, K, L, 0);
  } else {
    ell_spmv_kernel<T, 1, 8><<<grid, block, smem, st>>>(d, c, xv, yv, m, K, L, 0);
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
                      void* y, int64_t m, int K, int S, int L, int TX, int R,
                      void* stream) {
  return launch_spmv<float>(rdata, rcols, x, y, m, K, S, L, TX, R, stream);
}

int relp_ell_spmv_f64(const void* rdata, const void* rcols, const void* x,
                      void* y, int64_t m, int K, int S, int L, int TX, int R,
                      void* stream) {
  return launch_spmv<double>(rdata, rcols, x, y, m, K, S, L, TX, R, stream);
}

}  // extern "C"
