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
// comparator's (1024, 128, 100), 0.016 ms at the card's memory rate.
//
// Design: one warp per (query, candidate) row, as in gather_rank.cu but
// over a contiguous block and returning the raw dot.  Lane j reads
// elements j, j+32, ... of the row, so a warp's loads are neighbouring
// addresses (coalesced 128 B segments); the query row is staged once per
// block in shared memory and a warp-shuffle tree reduces the dot.  A
// ragged d is handled by the lane loop's bound; C and Q by the grid and
// the candidate loop.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;            // warps (rows in flight) per block
constexpr int kCandPerBlock = 64;    // candidates of one query per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One block: query blockIdx.x against candidates [blockIdx.y * 64, +64).
__global__ void __launch_bounds__(kWarps * 32)
rank_dots_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 float* __restrict__ out, int c, int d) {
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
    const float* __restrict__ row = x + o * d;
    float dot = 0.f;
    for (int k = lane; k < d; k += 32) dot = fmaf(qs[k], __ldg(row + k), dot);
    dot = warp_sum(dot);
    if (lane == 0) out[o] = dot;
  }
}

}  // namespace

extern "C" int rank_dots_launch(const void* q, const void* x, void* out,
                                int nq, int c, int d, void* stream) {
  dim3 grid(nq, (c + kCandPerBlock - 1) / kCandPerBlock);
  rank_dots_kernel<<<grid, kWarps * 32, d * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<float*>(out), c, d);
  return static_cast<int>(cudaGetLastError());
}
