// Hopper (sm_90a) kernel of the dense constraint operator: dense_price.
//
// For a row-major, contiguous A[m, lda] (the DenseMatrix layout) and a
// column window [j0, j0 + w):
//
//   d[j] = c[j] - sum_i v[i] * A[i, j0 + j]   (c given, length w)
//   d[j] =        sum_i v[i] * A[i, j0 + j]   (c == NULL)
//
// and then either out[j] = d[j], or (c given, a SelectArgs passed) the
// entering column chosen from d by the selection epilogue
// (select_epilogue.cuh), with d never written.  It prices the dense
// operator: d = c - A^T pi in f64 (the fallback pass), the f32 scan
// c - A^T v and the f32 devex pivot row A^T B^-1[r,:], and with a window the
// one block of columns that partial pricing scans.  Replaces pricing_kernel
// (tools/probe_pallas.py), whose grid of 256-column blocks is the window
// here, and the argmax that XLA fused onto its output.
//
// What bounds it: bytes.  A matrix-vector product reads every entry of the
// window once (m * w * sizeof(T); 2048 x 16384 f32 is 134 MB, 40 us at
// 3.35 TB/s) and reuses nothing but v.  At the solver's dense shapes
// (768 x 1536 f32 is 4.7 MB, 1.4 us) the launch and the latency of one
// dependent chain of loads bound it.
//
// What the design does about it:
// - 16-byte loads.  A thread owns 4 (f32) or 2 (f64) neighbouring columns,
//   so a warp reads 512 bytes of a row with one instruction, and kUnroll
//   independent rows are in flight per thread.  A block is one such warp
//   column (128 or 64 columns) times kWarps warps that split its rows.
// - A window whose first element or row stride is not 16-byte aligned (a
//   partial-pricing window at any j0, hybrid's spill block of any width)
//   runs the same kernel with 4- or 8-byte loads, lanes on neighbouring
//   columns; a ragged last vector of an aligned window does the same for
//   that thread alone.
// - One launch.  A narrow window (n = 1536 gives 12 column blocks for 132
//   SMs) splits the rows over a second grid dimension of `slices`.  Each
//   block writes its partial sums to scratch and takes a ticket on its
//   column block's counter; the block that draws the last ticket adds
//   the partials in a fixed order and finishes the column block.  Atomics
//   only count arrivals: every sum runs in an order fixed by the shapes, so
//   two runs give the same bits and pivot choices repeat.
// - The selection epilogue: the finishing block scores its columns in
//   registers (their statuses and weights loaded while the rows stream) and
//   the candidates meet through one slot per column block.
//
// Lanes.  The same pass prices L right-hand sides at once (the fleet
// engines' iterates, one lane per scenario; dense_price_lanes in
// ops/dense_kernels.py): lane s is grid row blockIdx.z and reads
// A + s * a_stride (0: one shared A, m * lda: lane s of a stacked
// A[L, m, lda]), its own v, c, out, partial sums, column-block counters and,
// under the selection epilogue, its own statuses, weights, Bland flag,
// slots, ticket and outputs (LaneArgs).  Each lane runs exactly the code and
// the sum order of a single-vector launch with the same plan, so lane s
// equals dense_price(A_s, v_s, c_s) bit for bit.  An optional bool[L] mask
// of live lanes lets a finished lane cost one early return per block; its
// outputs are left as they were.  A is read from L2 once per lane: sharing
// a tile of A between lanes (wgmma, TMA) is left for later.
//
// Built by relp_tpu_torch/ops/cuda_build.py into a shared library with a
// plain C interface; every entry point launches on the given stream, does
// not synchronise, allocates nothing (the caller passes `partial`, lanes *
// slices * w elements, and `counters`, one zeroed unsigned per lane and
// column block, when slices > 1), and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "select_epilogue.cuh"

// Element strides from one lane to the next (0: the lanes share it) and the
// mask of live lanes; all zero and null for a single-vector launch.
struct LaneArgs {
  int64_t a, v, c, out;          // A, v, c and out
  int64_t vstat, can_enter, w;   // the selection's inputs
  const unsigned char* live;     // bool[L], or null: every lane is live
};

namespace {

using relp::Cand;
using relp::SelectArgs;

constexpr int kWarps = 8;   // warps that split a block's rows
#ifndef RELP_DENSE_UNROLL
#define RELP_DENSE_UNROLL 4
#endif
constexpr int kUnroll = RELP_DENSE_UNROLL;  // rows in flight per thread
constexpr int kThreads = 32 * kWarps;

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

__device__ __forceinline__ void unpack(const float4& t, float (&x)[4]) {
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void unpack(const double2& t, double (&x)[2]) {
  x[0] = t.x; x[1] = t.y;
}

template <typename T>
struct DenseArgs {
  const T* A;
  const T* v;
  const T* c;            // null: the sum alone
  T* out;                // null under the selection epilogue
  T* partial;            // [slices, w] scratch when slices > 1
  unsigned int* counters;  // one per column block when slices > 1; zero at rest
  int m;
  int64_t lda, j0, w;
  int slices, rows_per_slice;
  int vector;            // the window's rows are 16-byte aligned
};

// acc[k] += sum over this warp's rows of v[i] * (the thread's k-th column).
// `p` points at the thread's first column in row `row`; VLOAD reads the V
// columns with one 16-byte load, otherwise `live` columns `step` apart are
// read one by one.
template <typename T, bool VLOAD>
__device__ __forceinline__ void accumulate(const T* __restrict__ p,
                                           const T* __restrict__ v, int row,
                                           int row_end, int64_t lda, int step,
                                           int live, T (&acc)[Vec<T>::n]) {
  constexpr int V = Vec<T>::n;
  using VT = typename Vec<T>::type;
  auto load = [&](const T* q, T (&x)[V]) {
    if constexpr (VLOAD) {
      unpack(__ldg(reinterpret_cast<const VT*>(q)), x);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) x[k] = k < live ? __ldg(q + k * step) : T(0);
    }
  };
  const int64_t hop = lda * kWarps;
  for (; row + (kUnroll - 1) * kWarps < row_end; row += kUnroll * kWarps) {
    T x[kUnroll][V];
    T vi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load(p + u * hop, x[u]);
      vi[u] = __ldg(v + row + u * kWarps);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] += vi[u] * x[u][k];
    }
    p += kUnroll * hop;
  }
  for (; row < row_end; row += kWarps) {
    T x[V];
    load(p, x);
    const T vi = __ldg(v + row);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] += vi * x[k];
    p += hop;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_price_kernel(DenseArgs<T> a, SelectArgs s, LaneArgs l, int select) {
  constexpr int V = Vec<T>::n;
  // this block's lane: its own operands, scratch and outputs
  const int64_t ln = blockIdx.z;
  if (l.live != nullptr && l.live[ln] == 0) return;  // uniform over the block
  a.A += ln * l.a;
  a.v += ln * l.v;
  if (a.c != nullptr) a.c += ln * l.c;
  if (a.out != nullptr) a.out += ln * l.out;
  if (a.slices > 1) {
    a.partial += ln * a.slices * a.w;
    a.counters += ln * gridDim.x;
  }
  if (select) {
    s.vstat += ln * l.vstat;
    s.can_enter += ln * l.can_enter;
    s.w += ln * l.w;
    s.bland += ln;
    s.slots += ln * gridDim.x;
    s.ticket += ln;
    s.q += ln;
    s.has += ln;
    s.d_q = static_cast<T*>(s.d_q) + ln;
  }
  constexpr int kBlockCols = 32 * V;
  __shared__ T red[kWarps][kBlockCols];
  __shared__ Cand warps_s[relp::kMaxWarps];
  __shared__ int flag_s;
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int tid = wy * 32 + lane;
  const int64_t jb = static_cast<int64_t>(blockIdx.x) * kBlockCols;
  const int64_t w_left = a.w - jb;
  // the thread's columns, relative to jb: col0 + k * step for k < live
  const int col0 = a.vector ? lane * V : lane;
  const int step = a.vector ? 1 : 32;
  int live = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) live += (col0 + k * step < w_left) ? 1 : 0;

  const int row_begin = static_cast<int>(blockIdx.y) * a.rows_per_slice;
  const int row_end = min(a.m, row_begin + a.rows_per_slice);
  // what the end of the pass reads of this thread's columns, asked for
  // before the rows so that it waits on nothing then
  relp::SelectInputs<V> inputs;
  if (select && wy == 0 && live > 0) inputs.load(s, a.j0 + jb + col0, step, live);
  T cj[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    cj[k] = (a.c != nullptr && wy == 0 && k < live) ? __ldg(a.c + jb + col0 + k * step) : T(0);
  }

  T acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = T(0);
  if (live > 0) {
    const int row = row_begin + wy;
    const T* p = a.A + static_cast<int64_t>(row) * a.lda + a.j0 + jb + col0;
    if (a.vector && live == V) {
      accumulate<T, true>(p, a.v, row, row_end, a.lda, step, live, acc);
    } else {
      accumulate<T, false>(p, a.v, row, row_end, a.lda, step, live, acc);
    }
  }

  // the block's warps, in warp order, into warp 0
  T sum[V];
  auto fold_warps = [&](const T (&mine)[V]) {
#pragma unroll
    for (int k = 0; k < V; ++k) red[wy][lane * V + k] = mine[k];
    __syncthreads();
    if (wy == 0) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        T t = red[0][lane * V + k];
#pragma unroll
        for (int y = 1; y < kWarps; ++y) t += red[y][lane * V + k];
        sum[k] = t;
      }
    }
  };
  fold_warps(acc);

  if (a.slices > 1) {
    // the row slices of this column block meet through `partial`; the block
    // that draws the last ticket adds them: thread (wy, lane) the slices wy,
    // wy + kWarps, ... in ascending order, then the warps in warp order
    if (wy == 0) {
      T* mine = a.partial + static_cast<int64_t>(blockIdx.y) * a.w + jb + col0;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (k < live) __stcg(mine + k * step, sum[k]);
      }
    }
    __syncthreads();
    unsigned int* counter = a.counters + blockIdx.x;
    if (tid == 0) {
      flag_s = relp::take_ticket(counter) == static_cast<unsigned>(a.slices) - 1 ? 1 : 0;
    }
    __syncthreads();
    if (flag_s == 0) return;
    T part[V];
#pragma unroll
    for (int k = 0; k < V; ++k) part[k] = T(0);
    for (int sl = wy; sl < a.slices; sl += kWarps) {
      const T* theirs = a.partial + static_cast<int64_t>(sl) * a.w + jb + col0;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (k < live) part[k] += __ldcg(theirs + k * step);
      }
    }
    fold_warps(part);
    if (tid == 0) *counter = 0u;  // at rest again for the next launch
  }

  // finish the column block: d, then out or the block's candidate
  Cand best = relp::no_candidate();
  if (wy == 0) {
    T d[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      d[k] = T(0);
      if (k < live) {
        const int64_t j = jb + col0 + k * step;
        d[k] = a.c != nullptr ? cj[k] - sum[k] : sum[k];
        if (a.out != nullptr) a.out[j] = d[k];
      }
    }
    if (select && live > 0) {
      best = relp::best_of<T, V>(d, a.j0 + jb + col0, step, live, inputs, s,
                                 *s.bland != 0);
    }
  }
  if (!select) return;
  bool owner;
  best = relp::block_best(best, tid, kThreads, warps_s, owner);  // its barrier: flag_s was read
  relp::select_finish<T>(best, owner, s, blockIdx.x, gridDim.x, tid, kThreads,
                         &flag_s, warps_s);
}

template <typename T>
int launch(const void* A, const void* v, const void* c, void* out,
           void* partial, void* counters, int m, int64_t lda, int64_t j0,
           int64_t w, int slices, int rows_per_slice, const SelectArgs* sel,
           const LaneArgs* lanes, int n_lanes, void* stream) {
  if (w <= 0 || n_lanes == 0) return static_cast<int>(cudaGetLastError());
  if (slices < 1 || rows_per_slice < 1 || n_lanes < 0 || n_lanes > 65535 ||
      (slices > 1 && (partial == nullptr || counters == nullptr)) ||
      (sel != nullptr && c == nullptr) || (sel == nullptr && out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kBlockCols = 32 * Vec<T>::n;
  DenseArgs<T> a;
  a.A = static_cast<const T*>(A);
  a.v = static_cast<const T*>(v);
  a.c = static_cast<const T*>(c);
  a.out = static_cast<T*>(out);
  a.partial = static_cast<T*>(partial);
  a.counters = static_cast<unsigned int*>(counters);
  a.m = m;
  a.lda = lda;
  a.j0 = j0;
  a.w = w;
  a.slices = slices;
  a.rows_per_slice = rows_per_slice;
  a.vector = reinterpret_cast<uintptr_t>(a.A + j0) % 16 == 0 &&
             (lda * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  const dim3 block(32, kWarps);
  const dim3 grid(static_cast<unsigned>((w + kBlockCols - 1) / kBlockCols),
                  static_cast<unsigned>(slices), static_cast<unsigned>(n_lanes));
  dense_price_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      a, sel != nullptr ? *sel : SelectArgs{},
      lanes != nullptr ? *lanes : LaneArgs{}, sel != nullptr ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int relp_dense_price_f32(const void* A, const void* v, const void* c,
                         void* out, void* partial, void* counters, int m,
                         int64_t lda, int64_t j0, int64_t w, int slices,
                         int rows_per_slice, const SelectArgs* sel,
                         const LaneArgs* lanes, int n_lanes, void* stream) {
  return launch<float>(A, v, c, out, partial, counters, m, lda, j0, w, slices,
                       rows_per_slice, sel, lanes, n_lanes, stream);
}

int relp_dense_price_f64(const void* A, const void* v, const void* c,
                         void* out, void* partial, void* counters, int m,
                         int64_t lda, int64_t j0, int64_t w, int slices,
                         int rows_per_slice, const SelectArgs* sel,
                         const LaneArgs* lanes, int n_lanes, void* stream) {
  return launch<double>(A, v, c, out, partial, counters, m, lda, j0, w, slices,
                        rows_per_slice, sel, lanes, n_lanes, stream);
}

}  // extern "C"
