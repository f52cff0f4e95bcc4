// rank_dots: inner products of each query with its own candidate block.
// (Q,d) f32 queries, (Q,C,d) f32 pre-gathered candidates -> (Q,C) f32 dots.
//
// Replaces: src/repro/kernels/rank_candidates.py, rank_dots_pallas / _kernel
// (the TPU kernel contracts a (bq, bc, bk) candidate block against its
// (bq, bk) query block on the MXU, accumulating over d-steps).
//
// What bounds it on the H100: bytes.  Every candidate row is read once for
// 2d FLOP (0.5 FLOP a byte), far below the card's fp32 balance point, so
// the kernel is a stream over the (Q,C,d) block: 52 MB at the z-order
// comparator's (1024, 128, 100), 0.016 ms at the card's memory rate, and
// ~1 GB at the multi-probe comparator's (256, ~10,000, 100), ~0.31 ms.
//
// Design: gather_rank.cu's row work without its indirection.  A block owns
// kTile candidates of one query, contiguous in memory.  A row is split
// into 4-float chunks and gets a group of G lanes (G = lanes_for(d): the
// fewest of 4, 8, 16, 32 that cover the row in kChunks chunks a lane; 8 at
// d = 100); lane i takes chunks i, i + G, ... of kRows = 2 rows at once,
// issuing every chunk load of both rows before the first multiply, so a
// warp keeps 2 * 32 / G rows in flight, and the group sums each dot with
// a log2(G)-step shuffle tree in a fixed order.  Where the row fits one
// pass (d <= 512) each lane holds its chunks of the query in registers for
// the whole block; past that the query chunks are read beside the rows',
// a pass at a time (from L1).  Chunks are 16-byte loads where d % 4 == 0
// and q and x are 16-byte aligned, four scalar loads otherwise; both sum
// the same products in the same order.  The dots go to a shared tile and
// out with coalesced stores.  Timed on the H100 and dropped: one and four
// rows a group, 4 lanes x 8 chunks a row (all slower); 256 threads and
// 256-candidate tiles (no clear change).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // threads a block
constexpr int kTile = 512;      // candidates of one query a block
constexpr int kChunks = 4;      // 4-float chunks a lane loads of a row a pass
constexpr int kRows = 2;        // rows a lane group loads at once
constexpr int kWarps = kThreads / 32;

// How a row's chunks reach the lanes.
enum Load { kScalar, kVector };

// Lanes a row gets at width d: the fewest of 4, 8, 16, 32 that cover its
// ceil(d/4) chunks with kChunks each.  A function of d alone.
int lanes_for(int d) {
  const int chunks = (d + 3) / 4;
  int g = 4;
  while (g < 32 && g * kChunks < chunks) g *= 2;
  return g;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Chunk j (elements 4j .. 4j+3) of a row, or zeros where j >= chunks;
// elements past d read as 0.
template <int kLoad>
__device__ __forceinline__ float4 load_chunk(const float* __restrict__ row,
                                             int j, int chunks, int d) {
  if (row == nullptr || j >= chunks) return make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kLoad == kVector) {
    return __ldg(reinterpret_cast<const float4*>(row) + j);
  } else {
    const int k = 4 * j;                       // k < d: j < chunks
    return make_float4(__ldg(row + k), k + 1 < d ? __ldg(row + k + 1) : 0.f,
                       k + 2 < d ? __ldg(row + k + 2) : 0.f,
                       k + 3 < d ? __ldg(row + k + 3) : 0.f);
  }
}

__device__ __forceinline__ float chunk_dot(float4 q, float4 x, float dot) {
  dot = fmaf(q.x, x.x, dot);
  dot = fmaf(q.y, x.y, dot);
  dot = fmaf(q.z, x.z, dot);
  return fmaf(q.w, x.w, dot);
}

// One block: candidates [tile * kTile, +kTile) of query blockIdx.x / tiles.
// kOnePass: the row's chunks fit G * kChunks, so the query stays in
// registers.
template <int G, int kLoad, bool kOnePass>
__global__ void __launch_bounds__(kThreads)
rank_dots_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 float* __restrict__ out, int c, int d, int tiles) {
  __shared__ float dots[kTile];
  const int chunks = (d + 3) / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = lane & (G - 1);
  const int qi = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * kTile;
  const int len = min(kTile, c - c0);
  const float* qrow = q + (size_t)qi * d;
  const float* block = x + ((size_t)qi * c + c0) * d;

  float4 qv[kChunks];
  if constexpr (kOnePass) {
#pragma unroll
    for (int p = 0; p < kChunks; ++p)
      qv[p] = load_chunk<kLoad>(qrow, li + G * p, chunks, d);
  }
  // A warp takes kRows * 32 / G rows a step, kRows a group; past the
  // tile's end a group reads no row but still joins the warp's shuffle
  // trees.
  constexpr int kStep = kRows * (32 / G);
  for (int e0 = warp * kStep; e0 < len; e0 += kWarps * kStep) {
    const float* row[kRows];
    float dot[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int e = e0 + r * (32 / G) + lane / G;
      row[r] = e < len ? block + (size_t)e * d : nullptr;
      dot[r] = 0.f;
    }
    for (int j0 = li; j0 < chunks; j0 += G * kChunks) {
      float4 xv[kRows][kChunks];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int p = 0; p < kChunks; ++p)
          xv[r][p] = load_chunk<kLoad>(row[r], j0 + G * p, chunks, d);
      if constexpr (!kOnePass) {
#pragma unroll
        for (int p = 0; p < kChunks; ++p)
          qv[p] = load_chunk<kLoad>(qrow, j0 + G * p, chunks, d);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int p = 0; p < kChunks; ++p)
          if (j0 + G * p < chunks) dot[r] = chunk_dot(qv[p], xv[r][p], dot[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float v = group_sum<G>(dot[r]);
      const int e = e0 + r * (32 / G) + lane / G;
      if (li == 0 && e < len) dots[e] = v;
    }
  }
  __syncthreads();
  float* o = out + (size_t)qi * c + c0;
  for (int p = tid; p < len; p += kThreads) o[p] = dots[p];
}

template <int G, int kLoad, bool kOnePass>
cudaError_t launch_as(const float* q, const float* x, float* out, int nq,
                      int c, int d, cudaStream_t stream) {
  const int tiles = (c + kTile - 1) / kTile;
  if ((long long)nq * tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  rank_dots_kernel<G, kLoad, kOnePass><<<nq * tiles, kThreads, 0, stream>>>(
      q, x, out, c, d, tiles);
  return cudaGetLastError();
}

// G < 32 means the row fits one pass (lanes_for); at G = 32 it may not.
template <int G>
cudaError_t launch_g(const float* q, const float* x, float* out, int nq,
                     int c, int d, bool vector, cudaStream_t stream) {
  if constexpr (G < 32) {
    if (vector) return launch_as<G, kVector, true>(q, x, out, nq, c, d,
                                                   stream);
    return launch_as<G, kScalar, true>(q, x, out, nq, c, d, stream);
  } else {
    const bool one = (d + 3) / 4 <= G * kChunks;
    if (vector && one)
      return launch_as<G, kVector, true>(q, x, out, nq, c, d, stream);
    if (vector)
      return launch_as<G, kVector, false>(q, x, out, nq, c, d, stream);
    if (one) return launch_as<G, kScalar, true>(q, x, out, nq, c, d, stream);
    return launch_as<G, kScalar, false>(q, x, out, nq, c, d, stream);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The lane group by d; the load path by d and by the alignment of q and
// x: 16-byte loads where rows are 16-byte multiples on 16-byte boundaries,
// else scalar.  Both sum the same products in the same order.
extern "C" int rank_dots_launch(const void* q, const void* x, void* out,
                                int nq, int c, int d, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* xf = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && aligned16(q) && aligned16(x);
  cudaError_t err;
  switch (lanes_for(d)) {
    case 4:
      err = launch_g<4>(qf, xf, o, nq, c, d, vec, st);
      break;
    case 8:
      err = launch_g<8>(qf, xf, o, nq, c, d, vec, st);
      break;
    case 16:
      err = launch_g<16>(qf, xf, o, nq, c, d, vec, st);
      break;
    default:
      err = launch_g<32>(qf, xf, o, nq, c, d, vec, st);
  }
  return static_cast<int>(err);
}
