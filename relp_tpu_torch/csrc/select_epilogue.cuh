// Selection epilogue shared by the pricing kernels (dense_kernels.cu,
// sparse_kernels.cu): the entering column comes out of the pricing pass.
//
// The TPU kernels leave d = c - A^T pi in VMEM and XLA fuses the masked
// devex argmax onto it.  On Hopper a pricing kernel that writes d to device
// memory hands it to some thirty small launches (PrimalKernel._select: the
// status compares, two selects, the mask, viol^2 / w, argmax, the Bland
// argmin, the gathers).  With this epilogue a thread that holds a reduced
// cost d_j scores it in registers, the candidates reduce over the warp by
// shuffles (score and index only: the lane that owns the winner carries the
// rest), over the block in shared memory and over the grid through one slot
// per block, and d never reaches device memory.
//
// The arithmetic is _select's (relp_tpu_torch/simplex/core.py; `pick` in
// relp_tpu/simplex/core.py), in f64 whatever the kernel's type: d_j is
// widened first, as d32.to(float64) does, so the comparison with eps_dual
// and the score viol^2 / w_j round as they do there.
//
//   free  = vstat_j == NB_FREE
//   viol  = (vstat_j in {NB_LOWER, free} and d < -eps ? -d : 0)
//         + (vstat_j in {NB_UPPER, free} and d >  eps ?  d : 0)
//   viol  = can_enter_j and vstat_j != BASIC ? viol : 0
//   score = viol^2 / w_j (devex) | viol (Dantzig)
//   q     = argmax score, or under Bland's rule the smallest j with viol > 0
//   has   = viol_q > 0,  d_q = d at q
//
// Candidates compare as torch.argmax and jnp.argmax do: a NaN score is the
// greatest, and among equal scores the lowest column index wins.  Bland's
// rule is the same comparison over the score (viol > 0 ? 1 : 0), so a window
// with no improving column yields its first column either way.  The order
// is total (indices are distinct), so the result does not depend on the
// order in which candidates meet, and repeats bit for bit.
//
// A thread's status, can_enter flag and weight are loaded before its reduced
// cost is ready (SelectInputs), all columns at once: scored one column after
// the other, each behind its own loads, four columns cost four trips to L2.
//
// Across the grid nothing is summed or compared through an atomic: each
// block writes its candidate to its slot and takes a ticket (an add with
// release and acquire semantics on a counter that only counts arrivals, so
// the slot is visible before the ticket is); the block that draws the last
// ticket reads every slot, in block order, writes (q, has, d_q) and sets
// the counter back to zero.  The counter is zero before the first launch
// (the wrapper allocates it zeroed, one per stream) and after every launch;
// nothing here synchronises with the host.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace relp {

// simplex/status.py
constexpr long long kNbLower = 0;
constexpr long long kNbUpper = 1;
constexpr long long kBasic = 2;
constexpr long long kNbFree = 3;

constexpr int kMaxWarps = 32;  // warps of the largest block

// One entering candidate.  idx < 0 marks "none" (a thread past the window).
struct Cand {
  double score;
  double d;       // the reduced cost, widened
  long long idx;  // column index in the whole pool (j0 + j)
  int has;        // viol > 0
};

// What the epilogue reads and writes; every pointer is device memory.  The
// host passes a null SelectArgs* when the kernel is to write d alone.
struct SelectArgs {
  const long long* vstat;          // i64[>= n], statuses by pool column
  const unsigned char* can_enter;  // bool[n]
  const double* w;                 // f64[n], devex reference weights
  const unsigned char* bland;      // bool, 0-dim: Bland's rule active
  double eps_dual;
  int devex;                       // 1: viol^2 / w, 0: viol
  Cand* slots;                     // scratch, one per block
  unsigned int* ticket;            // arrivals; zero at rest
  long long* q;                    // out, i64
  unsigned char* has;              // out, bool
  void* d_q;                       // out, one element of the kernel's type
};

// Arrive at `counter`: what this block wrote before (and, through a
// preceding __syncthreads(), what its other threads wrote) is visible to
// whoever draws a later ticket and reads after it.  Returns the arrivals
// before this one.
__device__ __forceinline__ unsigned int take_ticket(unsigned int* counter) {
  unsigned int before;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(before)
               : "l"(counter), "r"(1u)
               : "memory");
  return before;
}

// What the selection reads of N pool columns first + e * step, e < live.
template <int N>
struct SelectInputs {
  long long vstat[N];
  double w[N];
  unsigned char can_enter[N];

  __device__ __forceinline__ void load(const SelectArgs& s, long long first,
                                       int step, int live) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const long long j = first + (e < live ? e * step : 0);
      vstat[e] = __ldg(s.vstat + j);
      w[e] = __ldg(s.w + j);
      can_enter[e] = __ldg(s.can_enter + j);
    }
  }
};

__device__ __forceinline__ Cand no_candidate() {
  Cand c;
  c.score = 0.0;
  c.d = 0.0;
  c.idx = -1;
  c.has = 0;
  return c;
}

// a beats b: greater score, NaN greatest, ties to the lower index
__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  if (a.idx < 0) return false;
  if (b.idx < 0) return true;
  const bool a_nan = a.score != a.score;
  const bool b_nan = b.score != b.score;
  if (a_nan || b_nan) return a_nan && (!b_nan || a.idx < b.idx);
  return a.score > b.score || (a.score == b.score && a.idx < b.idx);
}

// The best candidate among the thread's columns first + e * step (e < live)
// with reduced costs d[e].  The violations, then the scores, then the
// comparisons, each as one unrolled pass: the f64 divisions of the N columns
// are independent and overlap.
template <typename T, int N>
__device__ __forceinline__ Cand best_of(const T (&d)[N], long long first,
                                        int step, int live,
                                        const SelectInputs<N>& in,
                                        const SelectArgs& s, bool bland) {
  double d64[N], viol[N], score[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    d64[e] = static_cast<double>(d[e]);
    const long long vs = in.vstat[e];
    const bool is_free = vs == kNbFree;
    const bool imp_l = (vs == kNbLower || is_free) && d64[e] < -s.eps_dual;
    const bool imp_u = (vs == kNbUpper || is_free) && d64[e] > s.eps_dual;
    viol[e] = (imp_l ? -d64[e] : 0.0) + (imp_u ? d64[e] : 0.0);
    if (!(in.can_enter[e] != 0 && vs != kBasic)) viol[e] = 0.0;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (bland) {
      score[e] = viol[e] > 0.0 ? 1.0 : 0.0;
    } else if (s.devex) {
      score[e] = viol[e] * viol[e] / in.w[e];
    } else {
      score[e] = viol[e];
    }
  }
  Cand best = no_candidate();
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (e < live) {
      Cand c;
      c.score = score[e];
      c.d = d64[e];
      c.idx = first + e * step;
      c.has = viol[e] > 0.0 ? 1 : 0;
      if (better(c, best)) best = c;
    }
  }
  return best;
}

// The best of the warp's candidates, in every lane.  Only the score and the
// index travel (they decide); the lane that owns the winner knows it by its
// index and carries the rest.
__device__ __forceinline__ void warp_best(double& score, long long& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Cand a, b;
    a.score = score;
    a.idx = idx;
    b.score = __shfl_xor_sync(0xffffffffu, score, off);
    b.idx = __shfl_xor_sync(0xffffffffu, idx, off);
    if (better(b, a)) {
      score = b.score;
      idx = b.idx;
    }
  }
}

// The block's best candidate.  Every thread of the block calls it with its
// own; exactly one thread of warp 0 gets `owner` set and the winner returned
// (no_candidate() if no thread had one).  `warps_s` is shared scratch of
// kMaxWarps candidates.
__device__ __forceinline__ Cand block_best(Cand mine, int tid, int n_threads,
                                           Cand* warps_s, bool& owner) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  double score = mine.score;
  long long idx = mine.idx;
  warp_best(score, idx);
  // indices are distinct, so one lane owns the winner; none does if idx < 0
  if (idx < 0 ? lane == 0 : mine.idx == idx) warps_s[warp] = mine;
  __syncthreads();
  owner = false;
  Cand b = no_candidate();
  if (warp == 0) {
    const int n_warps = (n_threads + 31) >> 5;
    if (lane < n_warps) b = warps_s[lane];
    score = b.score;
    idx = b.idx;
    warp_best(score, idx);
    owner = idx < 0 ? lane == 0 : b.idx == idx;
  }
  return b;
}

// Grid stage.  Every thread of every participating block calls it with the
// outcome of block_best; `rank` is the block's slot and `n_blocks` the number
// of blocks that call.  The block that arrives last writes the outputs.
// `flag_s` is one shared int, `warps_s` as in block_best.
template <typename T>
__device__ __forceinline__ void select_finish(Cand mine, bool owner,
                                              const SelectArgs& s,
                                              unsigned rank, unsigned n_blocks,
                                              int tid, int n_threads,
                                              int* flag_s, Cand* warps_s) {
  if (owner) {
    Cand* slot = s.slots + rank;
    __stcg(&slot->score, mine.score);
    __stcg(&slot->d, mine.d);
    __stcg(&slot->idx, mine.idx);
    __stcg(&slot->has, mine.has);
    *flag_s = take_ticket(s.ticket) == n_blocks - 1 ? 1 : 0;
  }
  __syncthreads();
  if (*flag_s == 0) return;
  Cand best = no_candidate();
  for (unsigned b = tid; b < n_blocks; b += n_threads) {
    const Cand* slot = s.slots + b;
    Cand o;
    o.score = __ldcg(&slot->score);
    o.d = __ldcg(&slot->d);
    o.idx = __ldcg(&slot->idx);
    o.has = __ldcg(&slot->has);
    if (better(o, best)) best = o;
  }
  best = block_best(best, tid, n_threads, warps_s, owner);
  if (owner) {
    *s.q = best.idx;
    *s.has = best.has ? 1 : 0;
    *static_cast<T*>(s.d_q) = static_cast<T>(best.d);
    *s.ticket = 0u;  // at rest again: the next launch on this stream counts from 0
  }
}

}  // namespace relp
