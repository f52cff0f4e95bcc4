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
// d-float store row (400 B at d = 100) for 2d FLOP of work, far below the
// card's ~20 FLOP/B balance point for fp32, so the kernel is a gather
// limited by memory traffic and by the latency of dependent row reads.
//
// Design: one warp per (query, candidate).  Lane j reads elements j, j+32,
// ... of the row at clip(slot, 0, N-1), so a warp's loads are neighbouring
// addresses (coalesced 128 B segments).  The query row is staged once per
// block in shared memory; a warp-shuffle tree reduces the dot, |x|^2 and
// |q|^2.  Invalid candidates skip their row read entirely.  The (Q,C,d)
// candidate block is never materialised.  The per-row arithmetic lives in
// rank_row(), and the whole block body in rank_block(), which both kernels
// share: the staged (cold-tier) variant differs only in which arena the row
// pointer comes from, so a row copied into the staging arena ranks
// bit-identically to the same row in the store, as the reference requires.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;            // warps (candidates in flight) per block
constexpr int kCandPerBlock = 64;    // candidates of one query per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Distance of the query in shared memory `qs` to the store row `row`;
// every lane returns the same value.
__device__ __forceinline__ float rank_row(const float* qs,
                                          const float* __restrict__ row,
                                          int d, bool angular, int lane) {
  float dot = 0.f, xx = 0.f, qq = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float xv = __ldg(row + k);
    const float qv = qs[k];
    dot = fmaf(qv, xv, dot);
    xx = fmaf(xv, xv, xx);
    qq = fmaf(qv, qv, qq);
  }
  dot = warp_sum(dot);
  xx = warp_sum(xx);
  if (angular) return 1.f - dot / fmaxf(sqrtf(xx), 1e-9f);
  qq = warp_sum(qq);
  return fmaxf(qq + xx - 2.f * dot, 0.f);
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

// One block: query blockIdx.x against candidates [blockIdx.y * 64, +64).
// Both kernels run this body; only the row pointer differs, so a row ranks
// bit-identically from either arena.
template <class Rows>
__device__ __forceinline__ void rank_block(const float* __restrict__ q,
                                           const int32_t* __restrict__ slots,
                                           const uint8_t* __restrict__ valid,
                                           float* __restrict__ out, int c,
                                           int d, int angular, Rows rows) {
  extern __shared__ float qs[];        // one query row, d floats
  const int qi = blockIdx.x;
  for (int k = threadIdx.x; k < d; k += blockDim.x)
    qs[k] = q[(size_t)qi * d + k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * kCandPerBlock;
  const int c1 = min(c0 + kCandPerBlock, c);
  for (int ci = c0 + warp; ci < c1; ci += kWarps) {
    const size_t o = (size_t)qi * c + ci;
    float dist = CUDART_INF_F;
    if (valid[o]) dist = rank_row(qs, rows(slots[o]), d, angular != 0, lane);
    if (lane == 0) out[o] = dist;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
gather_rank_kernel(const float* __restrict__ q,
                   const float* __restrict__ store,
                   const int32_t* __restrict__ slots,
                   const uint8_t* __restrict__ valid,
                   float* __restrict__ out, int n_rows, int c, int d,
                   int angular) {
  rank_block(q, slots, valid, out, c, d, angular, StoreRows{store, n_rows, d});
}

// Replaces: src/repro/kernels/gather_rank.py, gather_rank_staged_pallas /
// _kernel_staged.  Bound by bytes like the plain kernel: the staged rows
// are read once each, from whichever arena holds them.
__global__ void __launch_bounds__(kWarps * 32)
gather_rank_staged_kernel(const float* __restrict__ q,
                          const float* __restrict__ store,
                          const float* __restrict__ staging,
                          const int32_t* __restrict__ slots,
                          const uint8_t* __restrict__ valid,
                          float* __restrict__ out, int n_rows, int n_staging,
                          int c, int d, int angular) {
  rank_block(q, slots, valid, out, c, d, angular,
             StagedRows{store, staging, n_rows, n_staging, d});
}

}  // namespace

extern "C" int gather_rank_launch(const void* q, const void* store,
                                  const void* slots, const void* valid,
                                  void* out, int nq, int n_rows, int c, int d,
                                  int angular, void* stream) {
  dim3 grid(nq, (c + kCandPerBlock - 1) / kCandPerBlock);
  gather_rank_kernel<<<grid, kWarps * 32, d * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(store),
      static_cast<const int32_t*>(slots), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), n_rows, c, d, angular);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_rank_staged_launch(const void* q, const void* store,
                                         const void* staging,
                                         const void* slots, const void* valid,
                                         void* out, int nq, int n_rows,
                                         int n_staging, int c, int d,
                                         int angular, void* stream) {
  dim3 grid(nq, (c + kCandPerBlock - 1) / kCandPerBlock);
  gather_rank_staged_kernel<<<grid, kWarps * 32, d * sizeof(float),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(store),
      static_cast<const float*>(staging), static_cast<const int32_t*>(slots),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), n_rows,
      n_staging, c, d, angular);
  return static_cast<int>(cudaGetLastError());
}
