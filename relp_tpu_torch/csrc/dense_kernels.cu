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
// ops/dense_kernels.py), each lane with its own v, c, out, partial sums and,
// under the selection epilogue, its own statuses, weights, Bland flag,
// slots, ticket and outputs (LaneArgs).  An optional bool[L] mask of live
// lanes leaves a finished lane's outputs as they were.  Two kernels:
// - A stacked A[L, m, lda] shares nothing between lanes: lane s is grid row
//   blockIdx.z of dense_price_kernel and reads A + s * m * lda (group 1).
// - One A shared by the lanes: dense_price_group_kernel.  Run lane by lane,
//   the pass reads A from L2 or device memory once per lane (16 lanes of
//   the first-order fleet's 1,024 x 8,192 f32 operator: 16 x 33.5 MB where
//   one GEMM reads 33.5 MB), so the lanes' repeated bytes bound it.  A block
//   of the group kernel is one column block x one row slice x a group of G
//   lanes (4, 8 or 16, the wrapper's choice): it reads each tile of A once,
//   16 bytes a thread and row as the single kernel does, and feeds every
//   element to G FMAs, one per lane, from G x Vec<T>::n accumulators in
//   registers.  A warp needs the v of its own rows only, so it stages them
//   itself: each row of A and its G values of v arrive by cp.async in one
//   group, kStages - 1 rows ahead, through a ring in shared memory, and the
//   warp reads a row's G values as broadcast 16-byte loads.  What bounds it
//   then is A read once per group (bytes), the FMAs past that: L x m x w of
//   them at the card's rate outside the tensor cores, 67 TFLOP/s in f32 and
//   34 in f64 (64 lanes of 768 x 1536: 2.3 / 4.5 us); at the fleets' shapes
//   also the latency of the one-launch reduction below, a few round trips
//   to L2 after the last row.  The tensor cores are not used: the port runs
//   f32 with TF32 off and wgmma takes no full-f32 input, and f64 DMMA
//   (mma.sync) would add each lane's products in another order than the
//   single launch does.
//   Each lane keeps the single launch's order of sums: the same row slices
//   (the wrapper's slices_for), warp wy adding rows wy, wy + kWarps, ... of
//   its slice in ascending order, the warps folded in warp order, the
//   slices added in ascending order by the block that draws the last
//   ticket.  So lane s equals dense_price(A, v_s, c_s) bit for bit, and a
//   fleet lane pivots as the single solve does.  One ticket per (group,
//   column block) decides which block finishes; it spreads the group's
//   (lane, column) pairs over its threads, and under the selection epilogue
//   each warp takes lanes wy, wy + kWarps, ..., whose candidates meet
//   through the lane's slots and ticket as in the single kernel.  A group
//   with no live lane costs one early return per block; a dead or missing
//   lane (a ragged last group) in a live group is computed but never
//   written and takes no ticket.
//
// Built by relp_tpu_torch/ops/cuda_build.py into a shared library with a
// plain C interface; every entry point launches on the given stream, does
// not synchronise, allocates nothing (the caller passes `partial`, lanes *
// slices * w elements (the group kernel: rows of whole column blocks), and
// `counters`, zeroed unsigneds, one per lane and column block (the group
// kernel: one per group and column block), when slices > 1), and returns
// cudaGetLastError().

#include <atomic>
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

// ---- the group kernel: lanes that share A ----

#ifndef RELP_DENSE_GROUP_STAGES
#define RELP_DENSE_GROUP_STAGES 8
#endif
constexpr int kStages = RELP_DENSE_GROUP_STAGES;  // rows of A in flight per thread, plus one
static_assert(kStages >= 2, "a thread reads one staged row while the next are in flight");

template <typename P, typename T, int C>
__device__ __forceinline__ P pack(const T (&x)[C]) {
  P t;
  T* tt = reinterpret_cast<T*>(&t);
#pragma unroll
  for (int k = 0; k < C; ++k) tt[k] = x[k];
  return t;
}

// A block of the group kernel serves G lanes (4, 8 or 16); each thread owns
// the single kernel's C columns of a row and keeps G x C accumulators.
template <typename T, int G>
struct GroupShared {
  static constexpr int C = Vec<T>::n;
  static constexpr int kBlockCols = 32 * C;
  static constexpr int kFold = G < kWarps ? G : kWarps;  // lanes folded per round
  // blocks an SM holds: a thread's registers, 128 for 16 lanes, else 80
  static constexpr int kMinBlocks = G >= 16 ? 2 : 3;
  using P = typename Vec<T>::type;
  union {
    struct {
      P ring[kStages][kThreads];                // each thread's rows of A in flight
      alignas(16) T vring[kStages][kWarps][G];  // each warp's rows of V, by lane
    } in;
    T red[kFold][kWarps][kBlockCols];  // the warps' sums of kFold lanes
  } u;
  alignas(16) T sums[G][kBlockCols];  // the block's sums, by lane and thread column
  int flag;
};

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Copy `bytes` (4, 8 or 16) to shared memory without passing through
// registers; `real` false writes zeros and reads nothing.
template <int bytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool real) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(to), "l"(src), "r"(real ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
                 :: "r"(to), "l"(src), "n"(bytes), "r"(real ? bytes : 0) : "memory");
  }
}

// Phase stamps for tools/stamp_torch_lanes.py: built with -DRELP_DENSE_STAMPS,
// thread 0 of each group-kernel block writes the %globaltimer at the ends of
// its phases (started, rows in flight, rows summed, warps folded, ticket,
// slices summed, done) into the block's row of g_stamps; otherwise nothing.
#ifdef RELP_DENSE_STAMPS
constexpr int kStampBlocks = 1 << 16;
__device__ unsigned long long g_stamps[kStampBlocks][8];
__device__ __forceinline__ void stamp(int k) {
  const unsigned b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (threadIdx.x != 0 || threadIdx.y != 0 || b >= kStampBlocks) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_stamps[b][k] = t;
}
#define STAMP(k) stamp(k)
#else
#define STAMP(k) ((void)0)
#endif

// The selection's grid stage for one lane, run by the warp that holds the
// lane's candidates of this column block: select_finish with a warp in
// place of the block.  The owner writes the block's slot and takes the
// lane's ticket; on the last ticket the warp reads every slot.
template <typename T>
__device__ __forceinline__ void select_finish_warp(Cand mine, const SelectArgs& s,
                                                   unsigned rank, unsigned n_blocks, int lane) {
  double score = mine.score;
  long long idx = mine.idx;
  relp::warp_best(score, idx);
  const bool owner = idx < 0 ? lane == 0 : mine.idx == idx;
  int last = 0;
  if (owner) {
    Cand* slot = s.slots + rank;
    __stcg(&slot->score, mine.score);
    __stcg(&slot->d, mine.d);
    __stcg(&slot->idx, mine.idx);
    __stcg(&slot->has, mine.has);
    last = relp::take_ticket(s.ticket) == n_blocks - 1 ? 1 : 0;
  }
  if (!__any_sync(0xffffffffu, last)) return;
  __syncwarp();  // the owner's acquire orders the other lanes' reads too
  Cand best = relp::no_candidate();
  for (unsigned b = lane; b < n_blocks; b += 32) {
    const Cand* slot = s.slots + b;
    Cand o;
    o.score = __ldcg(&slot->score);
    o.d = __ldcg(&slot->d);
    o.idx = __ldcg(&slot->idx);
    o.has = __ldcg(&slot->has);
    if (relp::better(o, best)) best = o;
  }
  score = best.score;
  idx = best.idx;
  relp::warp_best(score, idx);
  if (idx < 0 ? lane == 0 : best.idx == idx) {
    *s.q = best.idx;
    *s.has = best.has ? 1 : 0;
    *static_cast<T*>(s.d_q) = static_cast<T>(best.d);
    *s.ticket = 0u;  // at rest again for the next launch
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads, GroupShared<T, G>::kMinBlocks)
dense_price_group_kernel(DenseArgs<T> a, SelectArgs s, LaneArgs l, int n_lanes, int select) {
  using Shared = GroupShared<T, G>;
  using P = typename Shared::P;
  constexpr int C = Shared::C;
  constexpr int kBlockCols = Shared::kBlockCols;
  constexpr int kFold = Shared::kFold;
  constexpr int kPairs = G * kBlockCols / kThreads;  // (lane, column) pairs a thread finishes
  constexpr int kPacks = G * 32 / kThreads > 0 ? G * 32 / kThreads : 1;  // (lane, pack) pairs
  constexpr int kPerWarp = (G + kWarps - 1) / kWarps;  // lanes a warp selects for
  static_assert(G % C == 0 && G <= 16, "a row of staged V is read C lanes at a time");
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sm = *reinterpret_cast<Shared*>(smem);

  // the group's live lanes (uniform over the block)
  const int first = static_cast<int>(blockIdx.z) * G;
  unsigned alive = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int ln = first + g;
    if (ln < n_lanes && (l.live == nullptr || l.live[ln] != 0)) alive |= 1u << g;
  }
  if (alive == 0) return;
  STAMP(0);
  auto is_alive = [&](int g) { return ((alive >> g) & 1u) != 0; };

  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int tid = wy * 32 + lane;
  const int64_t jb = static_cast<int64_t>(blockIdx.x) * kBlockCols;
  const int64_t w_left = a.w - jb;
  // the thread's columns, relative to jb: col0 + k * step for k < live
  // (a.vector: the window's rows are aligned to C elements)
  const int col0 = a.vector ? lane * C : lane;
  const int step = a.vector ? 1 : 32;
  int live = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) live += (col0 + k * step < w_left) ? 1 : 0;
  const bool vload = a.vector && live == C;
  const int row_begin = static_cast<int>(blockIdx.y) * a.rows_per_slice;
  const int row_end = min(a.m, row_begin + a.rows_per_slice);

  T acc[G][C];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int k = 0; k < C; ++k) acc[g][k] = T(0);
  }
  // Warp wy takes rows row_begin + wy + kWarps * i, i < mine, and only
  // those rows of V, so each warp stages its own: row i's group of cp.asyncs
  // brings the thread's columns of A and, from the warp's first G threads,
  // the G lanes' v of that row, into ring slot i % kStages.  One group per
  // row, even an empty one, so that every thread counts the same groups.
  const int mine = max(0, (row_end - row_begin - wy + kWarps - 1) / kWarps);
  const bool v_lane = lane < G;
  const bool v_real = v_lane && is_alive(lane);
  const T* next_a = a.A + a.j0 + jb + col0 + static_cast<int64_t>(row_begin + wy) * a.lda;
  const T* next_v = a.v + (v_real ? static_cast<int64_t>(first + lane) * l.v : 0) + row_begin + wy;
  int issued = 0;
  auto issue_next = [&]() {
    if (issued < mine) {
      const int slot = issued % kStages;
      P* to = &sm.u.in.ring[slot][tid];
      if (vload) {
        copy_async<sizeof(P)>(to, next_a, true);
      } else {
#pragma unroll
        for (int k = 0; k < C; ++k) {
          copy_async<sizeof(T)>(reinterpret_cast<T*>(to) + k, k < live ? next_a + k * step : next_a,
                                k < live);
        }
      }
      if (v_lane) copy_async<sizeof(T)>(&sm.u.in.vring[slot][wy][lane], next_v, v_real);
    }
    async_commit();
    ++issued;
    next_a += a.lda * kWarps;
    next_v += v_real ? kWarps : 0;
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue_next();
  STAMP(1);
  // each lane's products in ascending row order, as accumulate adds them
  for (int i = 0; i < mine; ++i) {
    async_wait<kStages - 2>();  // this thread's copies of row i are in
    __syncwarp();  // and the warp's: row i's v, and every thread is done with row i - 1
    const int slot = i % kStages;
    T x[C];
    unpack(sm.u.in.ring[slot][tid], x);
    const T* vr = sm.u.in.vring[slot][wy];
    issue_next();  // row i + kStages - 1, into row i - 1's slot
#pragma unroll
    for (int g0 = 0; g0 < G; g0 += C) {
      T vi[C];
      unpack(*reinterpret_cast<const P*>(vr + g0), vi);
#pragma unroll
      for (int e = 0; e < C; ++e) {
#pragma unroll
        for (int k = 0; k < C; ++k) acc[g0 + e][k] += vi[e] * x[k];
      }
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  STAMP(2);

  // the block's warps, in warp order, into sm.sums, kFold lanes a round:
  // warp f adds lane g0 + f's eight warp sums of the thread column `lane`
#pragma unroll
  for (int g0 = 0; g0 < G; g0 += kFold) {
    __syncthreads();  // red is free (it shares memory with the staged rows)
#pragma unroll
    for (int f = 0; f < kFold; ++f) {
      *reinterpret_cast<P*>(&sm.u.red[f][wy][lane * C]) = pack<P>(acc[g0 + f]);
    }
    __syncthreads();
    if (wy < kFold) {
      T t[C], y_t[C];
      unpack(*reinterpret_cast<const P*>(&sm.u.red[wy][0][lane * C]), t);
#pragma unroll
      for (int y = 1; y < kWarps; ++y) {
        unpack(*reinterpret_cast<const P*>(&sm.u.red[wy][y][lane * C]), y_t);
#pragma unroll
        for (int k = 0; k < C; ++k) t[k] += y_t[k];
      }
      *reinterpret_cast<P*>(&sm.sums[g0 + wy][lane * C]) = pack<P>(t);
    }
  }
  __syncthreads();

  STAMP(3);
  if (a.slices > 1) {
    // The row slices of a column block meet through `partial`, each lane's
    // sums of a slice stored in thread-column order (sm.sums' layout) with a
    // row stride of whole column blocks, so that every access is a packed
    // one.  The (lane, pack) pairs are spread over the block.
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kBlockCols / C;  // in packs
    P* parts = reinterpret_cast<P*>(a.partial);
    auto row_of = [&](int g, int sl) {
      return (static_cast<int64_t>(first + g) * a.slices + sl) * stride + jb / C;
    };
#pragma unroll
    for (int e0 = 0; e0 < kPacks; ++e0) {
      const int e = e0 * kThreads + tid;
      const int g = e / 32, q = e % 32;
      if (e < G * 32 && is_alive(g)) {
        __stcg(parts + row_of(g, blockIdx.y) + q, *reinterpret_cast<const P*>(&sm.sums[g][q * C]));
      }
    }
    __syncthreads();
    unsigned int* counter = a.counters + static_cast<int64_t>(blockIdx.z) * gridDim.x + blockIdx.x;
    if (tid == 0) {
      const bool last = relp::take_ticket(counter) == static_cast<unsigned>(a.slices) - 1;
      sm.flag = last ? 1 : 0;
      if (last) *counter = 0u;  // every slice has arrived: at rest for the next launch
    }
    __syncthreads();
    STAMP(4);
    if (sm.flag == 0) return;
    // The single kernel's order: its thread (y, lane) added the slices y,
    // y + kWarps, ... from zero, and the warps were added in warp order.
    // Here one thread takes the eight warps' parts of a (lane, pack) pair,
    // each slice's load issued before any sum needs it.
#pragma unroll
    for (int e0 = 0; e0 < kPacks; ++e0) {
      const int e = e0 * kThreads + tid;
      const int g = e / 32, q = e % 32;
      if (e >= G * 32 || !is_alive(g)) continue;
      const P* theirs = parts + row_of(g, 0) + q;
      T part[kWarps][C];
#pragma unroll
      for (int y = 0; y < kWarps; ++y) {
#pragma unroll
        for (int k = 0; k < C; ++k) part[y][k] = T(0);
      }
      for (int r0 = 0; r0 < a.slices; r0 += kWarps) {
        T x[kWarps][C];
#pragma unroll
        for (int y = 0; y < kWarps; ++y) {
          if (r0 + y < a.slices) unpack(__ldcg(theirs + (r0 + y) * stride), x[y]);
        }
#pragma unroll
        for (int y = 0; y < kWarps; ++y) {
#pragma unroll
          for (int k = 0; k < C; ++k) {
            if (r0 + y < a.slices) part[y][k] += x[y][k];
          }
        }
      }
#pragma unroll
      for (int y = 1; y < kWarps; ++y) {
#pragma unroll
        for (int k = 0; k < C; ++k) part[0][k] += part[y][k];
      }
      *reinterpret_cast<P*>(&sm.sums[g][q * C]) = pack<P>(part[0]);
    }
    __syncthreads();
    STAMP(5);
  }

  if (!select) {
    // out = C - sums (or the sums), the (lane, column) pairs spread over the
    // block, every load of C issued before the first store
    T cv[kPairs];
    bool ok[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int e = i * kThreads + tid;
      const int g = e / kBlockCols, cc = e % kBlockCols;
      ok[i] = is_alive(g) && cc < w_left;
      cv[i] = T(0);
      if (ok[i] && a.c != nullptr) cv[i] = __ldg(a.c + (first + g) * l.c + jb + cc);
    }
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int e = i * kThreads + tid;
      const int g = e / kBlockCols, cc = e % kBlockCols;
      if (!ok[i]) continue;
      // column cc belongs to thread column (its thread, then its k)
      const T sum = sm.sums[g][a.vector ? cc : (cc % 32) * C + cc / 32];
      a.out[(first + g) * l.out + jb + cc] = a.c != nullptr ? cv[i] - sum : sum;
    }
    STAMP(6);
    return;
  }

  // the selection: warp wy takes the lanes wy, wy + kWarps, ..., the loads
  // of all of them issued before the first is scored; each lane's candidates
  // then meet through the lane's slots and ticket as in the single kernel
  SelectArgs sl[kPerWarp];
  relp::SelectInputs<C> inputs[kPerWarp];
  bool bland[kPerWarp];
  T cv[kPerWarp][C];
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const int g = wy + kWarps * j;
    if (g >= G || !is_alive(g)) continue;  // uniform over the warp
    const int64_t ln = first + g;
    sl[j] = s;
    sl[j].vstat += ln * l.vstat;
    sl[j].can_enter += ln * l.can_enter;
    sl[j].w += ln * l.w;
    sl[j].bland += ln;
    sl[j].slots += ln * gridDim.x;
    sl[j].ticket += ln;
    sl[j].q += ln;
    sl[j].has += ln;
    sl[j].d_q = static_cast<T*>(sl[j].d_q) + ln;
    bland[j] = __ldg(sl[j].bland) != 0;
    if (live == 0) continue;
    inputs[j].load(sl[j], a.j0 + jb + col0, step, live);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      cv[j][k] = k < live ? __ldg(a.c + ln * l.c + jb + col0 + k * step) : T(0);
    }
  }
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const int g = wy + kWarps * j;
    if (g >= G || !is_alive(g)) continue;
    Cand best = relp::no_candidate();
    if (live > 0) {
      T d[C];
#pragma unroll
      for (int k = 0; k < C; ++k) d[k] = k < live ? cv[j][k] - sm.sums[g][lane * C + k] : T(0);
      best = relp::best_of<T, C>(d, a.j0 + jb + col0, step, live, inputs[j], sl[j], bland[j]);
    }
    select_finish_warp<T>(best, sl[j], blockIdx.x, gridDim.x, lane);
  }
  STAMP(6);
}

template <typename T, int G>
cudaError_t launch_group(const DenseArgs<T>& a, const SelectArgs& s, const LaneArgs& l,
                         int n_lanes, int select, dim3 grid, cudaStream_t stream) {
  constexpr int bytes = sizeof(GroupShared<T, G>);  // over the 48 KB of a static allocation
  // the opt-in, once per device (a driver call that costs the host more
  // than the launch)
  constexpr int kDevices = 64;
  static std::atomic<bool> opted_in[kDevices]{};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices || !opted_in[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(dense_price_group_kernel<T, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < kDevices) opted_in[dev].store(true, std::memory_order_relaxed);
  }
  grid.z = static_cast<unsigned>((n_lanes + G - 1) / G);
  dense_price_group_kernel<T, G><<<grid, dim3(32, kWarps), bytes, stream>>>(a, s, l, n_lanes,
                                                                            select);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* A, const void* v, const void* c, void* out,
           void* partial, void* counters, int m, int64_t lda, int64_t j0,
           int64_t w, int slices, int rows_per_slice, const SelectArgs* sel,
           const LaneArgs* lanes, int n_lanes, int group, void* stream) {
  if (w <= 0 || n_lanes == 0) return static_cast<int>(cudaGetLastError());
  if (slices < 1 || rows_per_slice < 1 || n_lanes < 0 || n_lanes > 65535 ||
      (slices > 1 && (partial == nullptr || counters == nullptr)) ||
      (sel != nullptr && c == nullptr) || (sel == nullptr && out == nullptr) ||
      (group != 1 && (lanes == nullptr || lanes->a != 0))) {
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
  const SelectArgs s = sel != nullptr ? *sel : SelectArgs{};
  const LaneArgs l = lanes != nullptr ? *lanes : LaneArgs{};
  const int select = sel != nullptr ? 1 : 0;
  const dim3 grid(static_cast<unsigned>((w + kBlockCols - 1) / kBlockCols),
                  static_cast<unsigned>(slices), static_cast<unsigned>(n_lanes));
  const auto st = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1:
      dense_price_kernel<T><<<grid, dim3(32, kWarps), 0, st>>>(a, s, l, select);
      return static_cast<int>(cudaGetLastError());
    case 4:
      return static_cast<int>(launch_group<T, 4>(a, s, l, n_lanes, select, grid, st));
    case 8:
      return static_cast<int>(launch_group<T, 8>(a, s, l, n_lanes, select, grid, st));
    case 16:
      return static_cast<int>(launch_group<T, 16>(a, s, l, n_lanes, select, grid, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int relp_dense_price_f32(const void* A, const void* v, const void* c,
                         void* out, void* partial, void* counters, int m,
                         int64_t lda, int64_t j0, int64_t w, int slices,
                         int rows_per_slice, const SelectArgs* sel,
                         const LaneArgs* lanes, int n_lanes, int group, void* stream) {
  return launch<float>(A, v, c, out, partial, counters, m, lda, j0, w, slices,
                       rows_per_slice, sel, lanes, n_lanes, group, stream);
}

int relp_dense_price_f64(const void* A, const void* v, const void* c,
                         void* out, void* partial, void* counters, int m,
                         int64_t lda, int64_t j0, int64_t w, int slices,
                         int rows_per_slice, const SelectArgs* sel,
                         const LaneArgs* lanes, int n_lanes, int group, void* stream) {
  return launch<double>(A, v, c, out, partial, counters, m, lda, j0, w, slices,
                        rows_per_slice, sel, lanes, n_lanes, group, stream);
}

#ifdef RELP_DENSE_STAMPS
// Copy the stamps out (`bytes` of them), then zero them for the next launch.
int relp_dense_stamps(void* dst, size_t bytes) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, g_stamps, bytes);
  if (err == cudaSuccess) {
    void* at = nullptr;
    err = cudaGetSymbolAddress(&at, g_stamps);
    if (err == cudaSuccess) err = cudaMemset(at, 0, sizeof(g_stamps));
  }
  return static_cast<int>(err);
}
#endif

}  // extern "C"
