// gather_rank and gather_rank_staged: fused candidate gather + exact
// re-rank.
// (Q,d) f32 queries, (N,d) f32 store, (Q,C) i32 slot ids, (Q,C) u8 valid
// -> (Q,C) f32 distances, +inf where valid == 0.  The staged variant also
// takes the cold tier's (M,d) staging arena: slots >= N read its row
// clip(slot - N, 0, M-1).
//   angular (queries arrive unit-normalised): 1 - dot / max(|x|, 1e-9)
//   l2:                                       max(|q|^2 + |x|^2 - 2 dot, 0)
//
// Replaces: src/repro/kernels/gather_rank.py, gather_rank_pallas / _kernel
// (and, as gather_rank_staged, gather_rank_staged_pallas / _kernel_staged).
//
// What bounds it on the H100: bytes.  Each valid candidate reads one
// d-float row (400 B at d = 100) for 4d FLOP, far below the card's ~20
// FLOP/B balance point for fp32.  The least traffic is every distinct row
// read once from HBM (the bound chip_smoke.py states); a row that several
// queries name is served again by the 50 MB L2.  Above that bound lie two
// ceilings (PERF.md): every read, hit or miss, crosses from L2 to the SMs;
// and the path's first reads are misses, early in the kernel, with the hits
// after them, so the two add up more than they overlap.
//
// Design (its settings picked by timing variants on the card, PERF.md):
// - A warp that takes one candidate at a time (flag, then slot, then row,
//   then reduce) waits on two dependent round trips a row with one row in
//   flight.  Instead one block owns a tile of kTile candidates of one query
//   (C = 512 on the main path: the whole row).  It first reads the tile's
//   slot ids and valid flags in one coalesced pass, together with the query
//   row, and compacts the valid candidates into a shared list with warp
//   ballots.  Invalid candidates cost nothing after that, and no row read
//   waits on a slot or flag load.  The query row is staged once, |q|^2
//   summed once a group.
// - A row is split into 4-float chunks.  Each row gets a group of G lanes
//   (G = lanes_for(d): the fewest of 4, 8, 16, 32 that cover the row in
//   kChunks chunks a lane; 8 at d = 100), lane i taking chunks i, i + G,
//   ..., every chunk load issued before the first multiply, so a warp
//   keeps 32 / G rows in flight and sums each with a log2(G)-step shuffle
//   tree.  Chunks are 16-byte loads where d % 4 == 0 and the arenas are
//   16-byte aligned, four scalar loads otherwise.  Both paths sum the same
//   products in the same order, so the load path never changes a bit of
//   the result.  Distances go to a shared tile, written back with
//   coalesced stores.
// - The arithmetic depends on d alone, never on where a row lives: both
//   kernels run rank_block(), which takes the arena as a row-pointer
//   functor, so a row copied into the staging arena ranks bit-identically
//   to the same row in the store, as the reference requires.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;   // threads a block
constexpr int kTile = 512;      // candidates of one query a block
constexpr int kChunks = 4;      // 4-float chunks a lane loads of a row a pass
constexpr int kWarps = kThreads / 32;
static_assert(kTile % kThreads == 0, "a thread reads whole tile strides");

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

// Chunk j (elements 4j .. 4j+3) of a row; elements past d read as 0.
template <int kLoad>
__device__ __forceinline__ float4 load_chunk(const float* __restrict__ row,
                                             int j, int d) {
  if constexpr (kLoad == kVector) {
    return __ldg(reinterpret_cast<const float4*>(row) + j);
  } else {
    const int k = 4 * j;                       // k < d: j < chunks
    return make_float4(__ldg(row + k), k + 1 < d ? __ldg(row + k + 1) : 0.f,
                       k + 2 < d ? __ldg(row + k + 2) : 0.f,
                       k + 3 < d ? __ldg(row + k + 3) : 0.f);
  }
}

__device__ __forceinline__ void chunk_fma(float4 q, float4 x, float& dot,
                                          float& xx) {
  dot = fmaf(q.x, x.x, dot);
  dot = fmaf(q.y, x.y, dot);
  dot = fmaf(q.z, x.z, dot);
  dot = fmaf(q.w, x.w, dot);
  xx = fmaf(x.x, x.x, xx);
  xx = fmaf(x.y, x.y, xx);
  xx = fmaf(x.z, x.z, xx);
  xx = fmaf(x.w, x.w, xx);
}

// |q|^2 in the lane-to-chunk order of a row, summed over the group.
template <int G>
__device__ __forceinline__ float query_sq(const float4* qs, int chunks,
                                          int li) {
  float qq = 0.f;
  for (int j = li; j < chunks; j += G) {
    const float4 v = qs[j];
    qq = fmaf(v.x, v.x, qq);
    qq = fmaf(v.y, v.y, qq);
    qq = fmaf(v.z, v.z, qq);
    qq = fmaf(v.w, v.w, qq);
  }
  return group_sum<G>(qq);
}

// Where a candidate's row lives.  The plain kernel reads the store at
// clip(slot, 0, N-1).  The staged (cold-tier) kernel reads slots >= N from
// the staging arena at clip(slot - N, 0, M-1) instead.  Offsets are size_t:
// the staging arena reaches tens of millions of rows.
struct StoreRows {
  const float* store;
  int n_rows, d;
  __device__ __forceinline__ const float* operator()(int s) const {
    s = s < 0 ? 0 : (s >= n_rows ? n_rows - 1 : s);
    return store + (size_t)s * d;
  }
};

struct StagedRows {
  const float* store;
  const float* staging;
  int n_rows, n_staging, d;
  __device__ __forceinline__ const float* operator()(int s) const {
    if (s < n_rows) return StoreRows{store, n_rows, d}(s);
    int t = s - n_rows;                // s >= n_rows >= 0: no overflow
    t = t >= n_staging ? n_staging - 1 : t;
    return staging + (size_t)t * d;
  }
};

// The distance of a row (null: no row, sums 0) to the query: this lane's
// chunks li, li + G, ... in that order, every load of a pass issued before
// its first multiply, then the group's shuffle trees.  Every lane of the
// warp calls it, so the trees see the whole warp.
template <int G, int kLoad>
__device__ __forceinline__ float rank_row(const float4* qs,
                                          const float* __restrict__ row,
                                          int chunks, int d, int li, float qq,
                                          bool angular) {
  float dot = 0.f, xx = 0.f;
  for (int c0 = li; c0 < chunks; c0 += G * kChunks) {
    float4 xv[kChunks];
#pragma unroll
    for (int p = 0; p < kChunks; ++p) {
      const int j = c0 + G * p;
      xv[p] = row != nullptr && j < chunks
                  ? load_chunk<kLoad>(row, j, d)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int p = 0; p < kChunks; ++p) {
      const int j = c0 + G * p;
      if (j < chunks) chunk_fma(qs[j], xv[p], dot, xx);
    }
  }
  const float dt = group_sum<G>(dot);
  const float x2 = group_sum<G>(xx);
  return angular ? 1.f - dt / fmaxf(sqrtf(x2), 1e-9f)
                 : fmaxf(__fsub_rn(__fadd_rn(qq, x2), __fmul_rn(2.f, dt)),
                         0.f);
}

// One block: candidates [tile * kTile, +kTile) of query blockIdx.x / tiles.
// Shared memory: the query row in whole chunks (zero-padded), then the
// compacted positions (cand) and slots (cslot) of the tile's valid
// candidates, then its distances.
template <int G, int kLoad, class Rows>
__device__ __forceinline__ void rank_block(const float* __restrict__ q,
                                           const int32_t* __restrict__ slots,
                                           const uint8_t* __restrict__ valid,
                                           float* __restrict__ out, int c,
                                           int d, int tiles, bool angular,
                                           Rows rows) {
  extern __shared__ float4 smem[];
  __shared__ int n_live;
  const int chunks = (d + 3) / 4;
  float4* qs = smem;
  int* cand = reinterpret_cast<int*>(qs + chunks);
  int* cslot = cand + kTile;
  float* dist = reinterpret_cast<float*>(cslot + kTile);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qi = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * kTile;
  const int len = min(kTile, c - c0);
  const size_t base = (size_t)qi * c + c0;

  // slot ids and flags first, in registers, then the query row
  constexpr int kPer = kTile / kThreads;
  int s[kPer];
  bool v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = tid + k * kThreads;
    v[k] = p < len && valid[base + p] != 0;
    s[k] = p < len ? slots[base + p] : 0;
  }
  float* qf = reinterpret_cast<float*>(qs);
  for (int k = tid; k < 4 * chunks; k += kThreads)
    qf[k] = k < d ? q[(size_t)qi * d + k] : 0.f;
  if (tid == 0) n_live = 0;
  __syncthreads();

  // compact the valid candidates (warp-aggregated slots in the list)
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = tid + k * kThreads;
    const unsigned m = __ballot_sync(0xffffffffu, v[k]);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(&n_live, __popc(m));
    at = __shfl_sync(0xffffffffu, at, 0) + __popc(m & ((1u << lane) - 1u));
    if (v[k]) {
      cand[at] = p;
      cslot[at] = s[k];
    }
    if (p < len) dist[p] = CUDART_INF_F;
  }
  __syncthreads();

  // A warp takes 32 / G list entries a step, one a group; past the list's
  // end a group reads no row but still joins the warp's shuffle trees.
  const int li = lane & (G - 1);
  const int n = n_live;
  const float qq = angular ? 0.f : query_sq<G>(qs, chunks, li);
  for (int e0 = warp * (32 / G); e0 < n; e0 += kWarps * (32 / G)) {
    const int e = e0 + lane / G;
    const float* row = e < n ? rows(cslot[e]) : nullptr;
    const float r = rank_row<G, kLoad>(qs, row, chunks, d, li, qq, angular);
    if (li == 0 && e < n) dist[cand[e]] = r;
  }
  __syncthreads();
  for (int p = tid; p < len; p += kThreads) out[base + p] = dist[p];
}

template <int G, int kLoad, class Rows>
__global__ void __launch_bounds__(kThreads)
rank_kernel(const float* __restrict__ q, const int32_t* __restrict__ slots,
            const uint8_t* __restrict__ valid, float* __restrict__ out, int c,
            int d, int tiles, int angular, Rows rows) {
  rank_block<G, kLoad>(q, slots, valid, out, c, d, tiles, angular != 0, rows);
}

template <int G, int kLoad, class Rows>
cudaError_t launch_as(const float* q, const int32_t* slots,
                      const uint8_t* valid, float* out, int nq, int c, int d,
                      int angular, Rows rows, cudaStream_t stream) {
  const int tiles = (c + kTile - 1) / kTile;
  if ((long long)nq * tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = ((d + 3) / 4) * sizeof(float4) + 3 * kTile * 4;
  auto kernel = rank_kernel<G, kLoad, Rows>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<nq * tiles, kThreads, smem, stream>>>(q, slots, valid, out, c, d,
                                                 tiles, angular, rows);
  return cudaGetLastError();
}

template <int G, class Rows>
cudaError_t launch_g(const float* q, const int32_t* slots,
                     const uint8_t* valid, float* out, int nq, int c, int d,
                     int angular, Rows rows, bool vector, cudaStream_t stream) {
  if (vector)
    return launch_as<G, kVector>(q, slots, valid, out, nq, c, d, angular,
                                 rows, stream);
  return launch_as<G, kScalar>(q, slots, valid, out, nq, c, d, angular, rows,
                               stream);
}

// The lane group by d; the load path by d and by the alignment of every
// arena the launch reads: 16-byte loads where rows are 16-byte multiples
// on 16-byte boundaries, else scalar.  Both sum the same products in the
// same order.
template <class Rows>
int launch(const void* q, const void* slots, const void* valid, void* out,
           int nq, int c, int d, int angular, Rows rows, bool aligned,
           void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* sl = static_cast<const int32_t*>(slots);
  const auto* va = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && aligned;
  cudaError_t err;
  switch (lanes_for(d)) {
    case 4:
      err = launch_g<4>(qf, sl, va, o, nq, c, d, angular, rows, vec, st);
      break;
    case 8:
      err = launch_g<8>(qf, sl, va, o, nq, c, d, angular, rows, vec, st);
      break;
    case 16:
      err = launch_g<16>(qf, sl, va, o, nq, c, d, angular, rows, vec, st);
      break;
    default:
      err = launch_g<32>(qf, sl, va, o, nq, c, d, angular, rows, vec, st);
  }
  return static_cast<int>(err);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int gather_rank_launch(const void* q, const void* store,
                                  const void* slots, const void* valid,
                                  void* out, int nq, int n_rows, int c, int d,
                                  int angular, void* stream) {
  return launch(q, slots, valid, out, nq, c, d, angular,
                StoreRows{static_cast<const float*>(store), n_rows, d},
                aligned16(store), stream);
}

// Replaces: src/repro/kernels/gather_rank.py, gather_rank_staged_pallas /
// _kernel_staged.  Bound by bytes like the plain kernel: the staged rows
// are read once each, from whichever arena holds them.
extern "C" int gather_rank_staged_launch(const void* q, const void* store,
                                         const void* staging,
                                         const void* slots, const void* valid,
                                         void* out, int nq, int n_rows,
                                         int n_staging, int c, int d,
                                         int angular, void* stream) {
  return launch(q, slots, valid, out, nq, c, d, angular,
                StagedRows{static_cast<const float*>(store),
                           static_cast<const float*>(staging), n_rows,
                           n_staging, d},
                aligned16(store) && aligned16(staging), stream);
}
