// Hopper (sm_90a) kernels of the brick layout (relp_tpu_torch/ops/bricks.py).
//
// Both compute the brick contraction over one or more groups of 8-row tiles,
// each group a padded slot array data[Tg, Bg, 8, 128] with column-block ids
// idx[Tg, Bg] (empty slots: zero bricks on block 0):
//
//   out[tile_of[s] * 8 + r] = sum_{b, l} data_g[s - s_g, b, r, l] * v[idx_g[s - s_g, b] * 128 + l]
//
// for the sorted tile position s in group g (first position s_g).
//   brick_spmv:  y = A x over the row-tile bricks.  Replaces brick_spmv_pallas
//                (relp_tpu/ops/pallas_kernels.py).
//   brick_price: d = c - A^T y over the transposed (column-tile) bricks, the
//                subtraction fused; without c the sum alone.  Replaces
//                brick_pricing_pallas (relp_tpu/ops/pallas_kernels.py).
// One group is the flat layout (BrickMatrix, tile_of null: s is the tile);
// several are the grouped layout (GroupedBrickMatrix), whose tiles are sorted
// by brick count and which the JAX package un-sorts with a gather after the
// contraction.  Here the groups' descriptors travel in the launch's parameters
// and each tile stores its 8 rows at its original place, tile_of[s]: one
// launch per product and no gather launch after it.
//
// What bounds them: bytes.  Every brick is 8 x 128 values (8 KB in f64, 4 KB
// in f32) read once, each with a 128-lane row of v that L2 serves; an empty
// slot is read like a full one.  At the N = 4,096 max flow under RCM ordering
// a product reads ~200 MB, ~60 us at 3.35 TB/s.  The TPU kernel keeps the
// whole v in VMEM and walks 16 tiles per program with a scalar-prefetched id
// per slot.  Here
// - a block of 128 threads takes one tile; thread l owns lane l of every
//   brick: per slot it loads v[id * 128 + l] (the 128-lane row gather,
//   coalesced) and the brick's 8 rows at lane l (8 coalesced 512- or
//   1,024-byte rows) into 8 accumulators, so every byte of a brick is one
//   coalesced read and nothing is staged;
// - the 128 lanes then meet in a fixed order: a butterfly of shuffles inside
//   each warp, the four warps' sums added in warp order by one thread per
//   row.  No atomics: two runs give the same bits (another order than the
//   plain version's sum, so the two agree within rounding).
// v is gathered through the read-only path (__ldg); the grid is one block per
// tile, heavy tiles first under the grouped layout's sort.
//
// Built by relp_tpu_torch/ops/cuda_build.py into a shared library with a
// plain C interface; every entry point launches on the given stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace relp {

// one group as the host passes it (ops/brick_kernels.py: _Group); outside the
// unnamed namespace, so that the extern "C" entry points taking it keep
// external linkage
struct BrickGroup {
  const void* data;  // T[tiles, slots, 8, 128]
  const void* idx;   // int32[tiles, slots]
  int64_t tiles;
  int64_t slots;
};

}  // namespace relp

namespace {

using relp::BrickGroup;

constexpr int kTR = 8;          // rows of a tile (the brick's 8 axis)
constexpr int kTC = 128;        // lanes of a brick; threads of a block
constexpr int kWarps = kTC / 32;
constexpr int kMaxGroups = 16;  // ops/brick_kernels.py: MAX_GROUPS

// the groups as the kernel reads them, passed by value in the launch
template <typename T>
struct GroupTable {
  const T* data[kMaxGroups];
  const int32_t* idx[kMaxGroups];
  int64_t first[kMaxGroups + 1];  // first sorted tile of each group; [count] = all tiles
  int slots[kMaxGroups];
  int count;
};

template <typename T>
__device__ __forceinline__ void contract_tile(const GroupTable<T>& g,
                                              const int32_t* __restrict__ tile_of,
                                              const T* __restrict__ v,
                                              const T* __restrict__ c,
                                              T* __restrict__ out) {
  const int64_t s = blockIdx.x;
  int k = 0;
  while (k + 1 < g.count && s >= g.first[k + 1]) ++k;
  const int64_t local = s - g.first[k];
  const int B = g.slots[k];
  const int l = threadIdx.x;
  const int32_t* __restrict__ ids = g.idx[k] + local * B;
  const T* __restrict__ brick = g.data[k] + local * B * (kTR * kTC) + l;

  T acc[kTR];
#pragma unroll
  for (int r = 0; r < kTR; ++r) acc[r] = T(0);
#pragma unroll 2
  for (int b = 0; b < B; ++b) {
    const T* __restrict__ p = brick + static_cast<int64_t>(b) * (kTR * kTC);
    T val[kTR];
#pragma unroll
    for (int r = 0; r < kTR; ++r) val[r] = __ldg(p + r * kTC);
    const T xv = __ldg(v + static_cast<int64_t>(__ldg(ids + b)) * kTC + l);
#pragma unroll
    for (int r = 0; r < kTR; ++r) acc[r] += val[r] * xv;
  }

  // the 128 lanes meet in a fixed order: a butterfly in each warp, then the
  // warps in order
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  }
  __shared__ T part[kWarps][kTR];
  const int w = l >> 5;
  if ((l & 31) == 0) {
#pragma unroll
    for (int r = 0; r < kTR; ++r) part[w][r] = acc[r];
  }
  __syncthreads();
  if (l < kTR) {
    T sum = part[0][l];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) sum += part[i][l];
    const int64_t tile = tile_of ? static_cast<int64_t>(tile_of[s]) : s;
    const int64_t o = tile * kTR + l;
    out[o] = c ? c[o] - sum : sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTC) brick_spmv_kernel(GroupTable<T> g,
                                                         const int32_t* tile_of,
                                                         const T* x, T* y) {
  contract_tile<T>(g, tile_of, x, nullptr, y);
}

template <typename T>
__global__ void __launch_bounds__(kTC) brick_price_kernel(GroupTable<T> g,
                                                          const int32_t* tile_of,
                                                          const T* y, const T* c, T* d) {
  contract_tile<T>(g, tile_of, y, c, d);
}

template <typename T, bool kPrice>
int launch(const BrickGroup* groups, int count, const void* tile_of, const void* v,
           const void* c, void* out, int64_t tiles, void* stream) {
  if (count < 1 || count > kMaxGroups || tiles < 1 || tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GroupTable<T> g{};
  int64_t first = 0;
  for (int k = 0; k < count; ++k) {
    if (groups[k].slots < 1 || groups[k].tiles < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    g.data[k] = static_cast<const T*>(groups[k].data);
    g.idx[k] = static_cast<const int32_t*>(groups[k].idx);
    g.slots[k] = static_cast<int>(groups[k].slots);
    g.first[k] = first;
    first += groups[k].tiles;
  }
  g.first[count] = first;
  g.count = count;
  if (first != tiles) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* to = static_cast<const int32_t*>(tile_of);
  if constexpr (kPrice) {
    brick_price_kernel<T><<<static_cast<unsigned>(tiles), kTC, 0, st>>>(
        g, to, static_cast<const T*>(v), static_cast<const T*>(c), static_cast<T*>(out));
  } else {
    brick_spmv_kernel<T><<<static_cast<unsigned>(tiles), kTC, 0, st>>>(
        g, to, static_cast<const T*>(v), static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int relp_brick_spmv_f32(const BrickGroup* groups, int count, const void* tile_of,
                        const void* x, const void* c, void* y, int64_t tiles, void* stream) {
  (void)c;
  return launch<float, false>(groups, count, tile_of, x, nullptr, y, tiles, stream);
}

int relp_brick_spmv_f64(const BrickGroup* groups, int count, const void* tile_of,
                        const void* x, const void* c, void* y, int64_t tiles, void* stream) {
  (void)c;
  return launch<double, false>(groups, count, tile_of, x, nullptr, y, tiles, stream);
}

int relp_brick_price_f32(const BrickGroup* groups, int count, const void* tile_of,
                         const void* y, const void* c, void* d, int64_t tiles, void* stream) {
  return launch<float, true>(groups, count, tile_of, y, c, d, tiles, stream);
}

int relp_brick_price_f64(const BrickGroup* groups, int count, const void* tile_of,
                         const void* y, const void* c, void* d, int64_t tiles, void* stream) {
  return launch<double, true>(groups, count, tile_of, y, c, d, tiles, stream);
}

}  // extern "C"
