// Hopper (sm_90a) kernels of the brick operator (relp_tpu_torch/ops/bricks.py).
//
//   brick_spmv:  y = A x over the row tiles.  Replaces brick_spmv_pallas
//                (relp_tpu/ops/pallas_kernels.py).
//   brick_price: d = c - A^T y over the column tiles, the subtraction fused;
//                without c the sum alone.  Replaces brick_pricing_pallas
//                (relp_tpu/ops/pallas_kernels.py).
//
// Both read one orientation's compacted bricks (ops/brick_kernels.py,
// BrickTiles): the tiles of 8 rows in the layout's order (the grouped
// layout's heavy-first sort, or the natural one), ptr[s] .. ptr[s + 1] the
// nonzeros of tile s in the bricks' slot order, row-major inside each brick,
// each a value and one position word col * 8 + row (col = block id * 128 +
// lane, the element of v it multiplies; row, 3 bits, the row in the tile):
//
//   out[tile_of[s] * 8 + r] = sum over k in tile s with pos[k] & 7 == r of vals[k] * v[pos[k] >> 3]
//
// tile_of null is the identity (the flat layout).  Each tile stores its 8
// rows at its original place: one launch per product, no un-sort after it.
//
// What bounds them: bytes, counted from the nonzeros.  The TPU kernels read
// every value of dense 8 x 128 bricks, because a TPU gathers elements
// serially; at the N = 4,096 max flow a brick holds 2-3 nonzeros of its
// 1,024 values, so that layout moves ~240 MB a product where the nonzeros,
// one position word each, the offsets, tile_of and the vectors are ~1.2 MB.
// On Hopper an element gather of v (a few hundred KB) is an L2 hit, so here
// - G lanes (8, 16 or 32: the wrapper picks about one nonzero a lane for a
//   mean tile) take one tile, 128 / G tiles a block of 128 threads.  Lane j
//   takes the tile's nonzeros j, j + G, ... (coalesced reads of vals and
//   pos), loads a batch of two before the first gather, gathers v through
//   the read-only path and adds into the one of 8 row accumulators its row
//   names, by predicated adds in registers;
// - the G lanes then meet in a fixed order: a reduce-scatter by halves (4,
//   2 and 1 shuffles leave each lane one row), then a butterfly over the
//   lanes that hold the same row; one lane a row stores.  No atomics and
//   nothing staged: two runs give the same bits (another order than the
//   plain version's sum, so the two agree within rounding).
// An empty padded slot of the dense layout has no entry, so slot padding
// adds nothing to what a product reads.
//
// Built by relp_tpu_torch/ops/cuda_build.py into a shared library with a
// plain C interface; every entry point launches on the given stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// nonzeros a lane loads before its first gather: tools/sweep_torch_pricing.py
// --only bricks sweeps 2, 4 and 8; 2 was best or tied on both sides of the
// max flows (a column tile has one nonzero a lane, a row tile about four)
#ifndef RELP_BRICK_BATCH
#define RELP_BRICK_BATCH 2
#endif

constexpr int kTR = 8;          // rows of a tile
constexpr int kThreads = 128;   // threads of a block
constexpr int kBatch = RELP_BRICK_BATCH;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int G>
__device__ __forceinline__ void contract_tiles(const int32_t* __restrict__ ptr,
                                               const T* __restrict__ vals,
                                               const int32_t* __restrict__ pos,
                                               const int32_t* __restrict__ tile_of,
                                               const T* __restrict__ v,
                                               const T* __restrict__ c,
                                               T* __restrict__ out, int tiles) {
  static_assert(G == 8 || G == 16 || G == 32, "8, 16 or 32 lanes a tile");
  const int lane = threadIdx.x & (G - 1);
  const int s = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  // a tile past the end still joins its warp's shuffles, with zeros
  const bool live = s < tiles;

  T acc[kTR];
#pragma unroll
  for (int r = 0; r < kTR; ++r) acc[r] = T(0);
  if (live) {
    const int end = __ldg(ptr + s + 1);
    for (int k0 = __ldg(ptr + s) + lane; k0 < end; k0 += kBatch * G) {
      T a[kBatch], x[kBatch];
      int p[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + u * G;
        a[u] = k < end ? __ldg(vals + k) : T(0);
        p[u] = k < end ? __ldg(pos + k) : -1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) x[u] = p[u] >= 0 ? __ldg(v + (p[u] >> 3)) : T(0);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int row = p[u] & 7;
#pragma unroll
        for (int r = 0; r < kTR; ++r) {
          if (p[u] >= 0 && r == row) acc[r] += a[u] * x[u];
        }
      }
    }
  }

  // reduce-scatter by halves: the lanes of the upper half keep rows 4-7 and
  // take their partner's, the lower half rows 0-3; then pairs of rows, then
  // one row a lane: row = lane / (G / 8)
  {
    const bool up = lane & (G / 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T send = up ? acc[i] : acc[i + 4];
      const T keep = up ? acc[i + 4] : acc[i];
      acc[i] = keep + __shfl_xor_sync(kFull, send, G / 2);
    }
  }
  {
    const bool up = lane & (G / 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const T send = up ? acc[i] : acc[i + 2];
      const T keep = up ? acc[i + 2] : acc[i];
      acc[i] = keep + __shfl_xor_sync(kFull, send, G / 4);
    }
  }
  {
    const bool up = lane & (G / 8);
    const T send = up ? acc[0] : acc[1];
    const T keep = up ? acc[1] : acc[0];
    acc[0] = keep + __shfl_xor_sync(kFull, send, G / 8);
  }
  // the G / 8 lanes that hold one row: a butterfly
#pragma unroll
  for (int off = G / 16; off > 0; off >>= 1) acc[0] += __shfl_xor_sync(kFull, acc[0], off);
  if (live && (lane & (G / 8 - 1)) == 0) {
    const int64_t tile = tile_of ? static_cast<int64_t>(tile_of[s]) : s;
    const int64_t o = tile * kTR + lane / (G / 8);
    out[o] = c ? c[o] - acc[0] : acc[0];
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) brick_spmv_kernel(const int32_t* ptr, const T* vals,
                                                              const int32_t* pos,
                                                              const int32_t* tile_of,
                                                              const T* x, T* y, int tiles) {
  contract_tiles<T, G>(ptr, vals, pos, tile_of, x, nullptr, y, tiles);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) brick_price_kernel(const int32_t* ptr, const T* vals,
                                                               const int32_t* pos,
                                                               const int32_t* tile_of,
                                                               const T* y, const T* c, T* d,
                                                               int tiles) {
  contract_tiles<T, G>(ptr, vals, pos, tile_of, y, c, d, tiles);
}

template <typename T, bool kPrice, int G>
void launch_lanes(const int32_t* ptr, const T* vals, const int32_t* pos, const int32_t* tile_of,
                  const T* v, const T* c, T* out, int tiles, cudaStream_t st) {
  constexpr int per_block = kThreads / G;
  const unsigned blocks = static_cast<unsigned>((tiles + per_block - 1) / per_block);
  if constexpr (kPrice) {
    brick_price_kernel<T, G><<<blocks, kThreads, 0, st>>>(ptr, vals, pos, tile_of, v, c, out,
                                                          tiles);
  } else {
    brick_spmv_kernel<T, G><<<blocks, kThreads, 0, st>>>(ptr, vals, pos, tile_of, v, out, tiles);
  }
}

template <typename T, bool kPrice>
int launch(const void* ptr, const void* vals, const void* pos, const void* tile_of,
           const void* v, const void* c, void* out, int64_t tiles, int lanes, void* stream) {
  if (tiles < 1 || tiles > 0x7fff0000) return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const int32_t*>(ptr);
  const auto* a = static_cast<const T*>(vals);
  const auto* w = static_cast<const int32_t*>(pos);
  const auto* to = static_cast<const int32_t*>(tile_of);
  const auto* vv = static_cast<const T*>(v);
  const auto* cc = static_cast<const T*>(c);
  auto* o = static_cast<T*>(out);
  const int t = static_cast<int>(tiles);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 8: launch_lanes<T, kPrice, 8>(p, a, w, to, vv, cc, o, t, st); break;
    case 16: launch_lanes<T, kPrice, 16>(p, a, w, to, vv, cc, o, t, st); break;
    case 32: launch_lanes<T, kPrice, 32>(p, a, w, to, vv, cc, o, t, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int relp_brick_spmv_f32(const void* ptr, const void* vals, const void* pos, const void* tile_of,
                        const void* x, const void* c, void* y, int64_t tiles, int lanes,
                        void* stream) {
  (void)c;
  return launch<float, false>(ptr, vals, pos, tile_of, x, nullptr, y, tiles, lanes, stream);
}

int relp_brick_spmv_f64(const void* ptr, const void* vals, const void* pos, const void* tile_of,
                        const void* x, const void* c, void* y, int64_t tiles, int lanes,
                        void* stream) {
  (void)c;
  return launch<double, false>(ptr, vals, pos, tile_of, x, nullptr, y, tiles, lanes, stream);
}

int relp_brick_price_f32(const void* ptr, const void* vals, const void* pos, const void* tile_of,
                         const void* y, const void* c, void* d, int64_t tiles, int lanes,
                         void* stream) {
  return launch<float, true>(ptr, vals, pos, tile_of, y, c, d, tiles, lanes, stream);
}

int relp_brick_price_f64(const void* ptr, const void* vals, const void* pos, const void* tile_of,
                         const void* y, const void* c, void* d, int64_t tiles, int lanes,
                         void* stream) {
  return launch<double, true>(ptr, vals, pos, tile_of, y, c, d, tiles, lanes, stream);
}

}  // extern "C"
