// Hopper (sm_90a) kernel of the dual simplex's update: dual_update.
//
// One dual pivot's arithmetic after the products with A and B^-1, in one
// launch: the new basis, statuses, xB, pi, d and row weights beta; the
// status, iteration, refactorization and flip counters; whether the pivot
// applies (do_pivot, which rank_one_basis_update reads next); and the packed
// loop flags (running, refactorization due).  It replaces the ~105 small
// PyTorch kernels of simplex/dual.py's step from p = u[r] on, whose code is
// dual_update_plain there.  No Pallas kernel corresponds: the
// JAX package's loop body is one XLA program, whose compiler fuses the same
// chain.
//
// What bounds it: latency.  Each input read once and each output written
// once, it moves 112 m + 41 n bytes under "dse" (104 m + 41 n under
// "devex"): 0.15 MB at 768 x 1536 (0.04 us at 3.35 TB/s) and 1.2 MB at
// 4,094 x 18,368 (0.36 us).  The chain it replaces is ~105 launches of
// ~1.1-1.6 us each.
//
// What the design does about it: one thread per element of the n + m
// statuses, which also covers the n reduced costs and the m basic rows.  No
// thread reads what another writes, so there is no grid synchronisation:
// every thread reads the pivot's dozen scalars (u[r], xB[r], the flips'
// product at r, d[q], vstat[q], basis[r], the bounds at basis[r] and at q,
// beta[r]) from the unmodified inputs and writes its own elements of fresh
// outputs; thread 0 also writes the scalars and the flags.
//
// Bit for bit the plain version's: csrc/ is compiled with nvcc's default
// contraction into FMA, so every f64 operation is written as its own rounded
// intrinsic (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn), in the order
// PyTorch evaluates the plain version; maximum, clamp_min and clamp return a
// NaN input as PyTorch's CUDA kernels do.
//
// Built by relp_tpu_torch/ops/cuda_build.py; the entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace relp {

// The update's operands (ops/dual_kernels.py: DualUpdateArgs).  Vectors are
// contiguous; r, q, n_flips and the flags in are 0-dim tensors.
struct DualUpdateArgs {
  // the chosen pivot (bools are torch.bool: one byte, 0 or 1)
  const int64_t* r;
  const int64_t* q;
  const int64_t* n_flips;
  const uint8_t* has_entering;
  const uint8_t* primal_feasible;
  const uint8_t* broken;
  const uint8_t* fresh;
  const uint8_t* leaving_below;
  const uint8_t* flip_mask;  // [n]
  // u = B^-1 a_q, B^-1 (A dx), tau = B^-1 rho (null under devex), rho: [m];
  // alpha = rho A: [n]
  const double* u;
  const double* bdx;
  const double* tau;
  const double* rho;
  const double* alpha;
  // the state before the step
  const int64_t* basis;  // [m]
  const int64_t* vstat;  // [n + m]
  const double* xB;      // [m]
  const double* pi;      // [m]
  const double* d;       // [n]
  const double* beta;    // [m]
  const int64_t* status;
  const int64_t* it;
  const int64_t* since_refactor;
  const int64_t* flips;
  // the column bounds [n] and with the artificials' [n + m]
  const double* lb;
  const double* ub;
  const double* lb_tot;
  const double* ub_tot;
  // outputs, each as its input above
  int64_t* basis_out;
  int64_t* vstat_out;
  double* xB_out;
  double* pi_out;
  double* d_out;
  double* beta_out;
  int64_t* status_out;
  int64_t* it_out;
  int64_t* since_refactor_out;
  int64_t* flips_out;
  uint8_t* do_pivot_out;
  uint8_t* flags_out;  // [2]: running, refactorization due
  int64_t m;
  int64_t n;
  int64_t refactor_period;
  int64_t max_iter;
  double eps_pivot;
};

}  // namespace relp

namespace {

using relp::DualUpdateArgs;

// simplex/status.py
constexpr int64_t kRunning = 0, kOptimal = 1, kInfeasible = 2;
constexpr int64_t kNbLower = 0, kNbUpper = 1, kBasic = 2, kNbFixed = 4;

constexpr int kThreads = 256;

// torch.maximum: a NaN operand, the first if both are
__device__ __forceinline__ double maximum(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmax(a, b);
}

// Tensor.clamp_min and Tensor.clamp with scalar bounds: NaN stays NaN
__device__ __forceinline__ double clamp_min(double v, double lo) {
  return v != v ? v : fmax(v, lo);
}

__device__ __forceinline__ double clamp(double v, double lo, double hi) {
  return v != v ? v : fmin(fmax(v, lo), hi);
}

template <bool kDevex>
__global__ void __launch_bounds__(kThreads) dual_update_kernel(const DualUpdateArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t m = a.m, n = a.n;
  if (i >= n + m) return;

  // the pivot's scalars, each as the plain version computes it
  const int64_t r = *a.r, q = *a.q, n_flips = *a.n_flips;
  const bool has_entering = *a.has_entering != 0;
  const bool primal_feasible = *a.primal_feasible != 0;
  const bool broken = *a.broken != 0;
  const bool leaving_below = *a.leaving_below != 0;
  const double p = a.u[r];
  const bool ok_pivot = fabs(p) > a.eps_pivot;
  const double p_safe = fabs(p) > 1e-300 ? p : 1.0;
  const bool do_pivot = !primal_feasible && has_entering && !broken && ok_pivot;
  const bool flipped = do_pivot && n_flips > 0;
  const int64_t kr = a.basis[r];
  const double xB_r = a.xB[r];
  const double xBf_r = flipped ? __dsub_rn(xB_r, a.bdx[r]) : xB_r;
  const double bound_r = leaving_below ? a.lb_tot[kr] : a.ub_tot[kr];
  const double theta_p = __ddiv_rn(__dsub_rn(xBf_r, bound_r), p_safe);
  const int64_t vq = a.vstat[q];
  const double start_val = vq == kNbUpper ? a.ub[q] : (vq == kNbLower ? a.lb[q] : 0.0);
  const double theta_d = __ddiv_rn(a.d[q], p_safe);
  const double beta_r = a.beta[r];
  const double beta_r_new = __ddiv_rn(beta_r, __dmul_rn(p_safe, p_safe));

  if (i < m) {
    const double xB = a.xB[i], u = a.u[i], pi = a.pi[i], beta = a.beta[i];
    const double xBf = flipped ? __dsub_rn(xB, a.bdx[i]) : xB;
    const double xB_new =
        i == r ? __dadd_rn(start_val, theta_p) : __dsub_rn(xBf, __dmul_rn(theta_p, u));
    const double pi_new = __dadd_rn(pi, __dmul_rn(theta_d, a.rho[i]));
    const double ratio_u = __ddiv_rn(u, p_safe);
    const double uu_beta_r = __dmul_rn(__dmul_rn(ratio_u, ratio_u), beta_r);
    double beta_new;
    if (kDevex) {
      beta_new = i == r ? clamp_min(beta_r_new, 1.0) : maximum(beta, uu_beta_r);
      beta_new = clamp(beta_new, 1e-12, 1e12);
    } else {
      beta_new = i == r ? beta_r_new
                        : __dadd_rn(__dsub_rn(beta, __dmul_rn(__dmul_rn(2.0, ratio_u), a.tau[i])),
                                    uu_beta_r);
      beta_new = clamp_min(beta_new, 1e-12);
    }
    const int64_t k = a.basis[i];
    a.basis_out[i] = do_pivot && i == r ? q : k;
    a.xB_out[i] = do_pivot ? xB_new : xB;
    a.pi_out[i] = do_pivot ? pi_new : pi;
    a.beta_out[i] = do_pivot ? beta_new : beta;
  }
  if (i < n) {
    const double d = a.d[i];
    const double d_new = i == q ? 0.0 : __dsub_rn(d, __dmul_rn(theta_d, a.alpha[i]));
    a.d_out[i] = do_pivot ? d_new : d;
  }
  {
    // flips first, then the leaving column kr, then the entering q
    const int64_t vs = a.vstat[i];
    int64_t v = vs;
    if (i < n && a.flip_mask[i] != 0) v = vs == kNbLower ? kNbUpper : kNbLower;
    if (i == kr) {
      v = a.lb_tot[kr] == a.ub_tot[kr] ? kNbFixed : (leaving_below ? kNbLower : kNbUpper);
    }
    if (i == q) v = kBasic;
    a.vstat_out[i] = do_pivot ? v : vs;
  }
  if (i == 0) {
    const bool fresh = *a.fresh != 0;
    const int64_t status = primal_feasible && fresh && !broken ? kOptimal
        : (!primal_feasible && !has_entering && fresh && !broken ? kInfeasible : *a.status);
    const bool wants_terminal = primal_feasible || (!primal_feasible && !has_entering);
    // a too-small pivot is a numerical event: rebuild and retry
    const bool force_refac = (wants_terminal && !fresh) || broken ||
                             (!primal_feasible && has_entering && !ok_pivot);
    const int64_t it = *a.it + 1;
    const int64_t since = force_refac ? a.refactor_period : *a.since_refactor + do_pivot;
    *a.status_out = status;
    *a.it_out = it;
    *a.since_refactor_out = since;
    *a.flips_out = *a.flips + (do_pivot ? n_flips : 0);
    *a.do_pivot_out = do_pivot;
    a.flags_out[0] = status == kRunning && it < a.max_iter;
    a.flags_out[1] = since >= a.refactor_period;
  }
}

}  // namespace

extern "C" {

int relp_dual_update(const relp::DualUpdateArgs* args, int devex, void* stream) {
  const int64_t total = args->n + args->m;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (devex) {
    dual_update_kernel<true><<<blocks, kThreads, 0, s>>>(*args);
  } else {
    dual_update_kernel<false><<<blocks, kThreads, 0, s>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
