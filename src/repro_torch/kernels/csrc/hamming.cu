// hamming: bit differences between packed compound keys.
// (Q,W) u32 query keys x (N,W) u32 stored keys -> (Q,N) i32,
//   out[i][j] = sum over words w of popcount(a[i][w] ^ b[j][w]).
//
// Replaces: src/repro/kernels/hamming.py, hamming_pallas / _kernel (the
// TPU kernel XORs a (bq, bn, W) tile in VMEM and sums a SWAR popcount).
//
// What bounds it on the H100: bytes, by the count of the contract.  The
// (Q,N) i32 output must be written (1.07 GB at 1024 x 262,144 keys: 0.32 ms
// at the card's memory rate) while the work is 3*W integer operations an
// output.  The popcount itself runs at a quarter of the ALU rate on sm_90
// (16 a clock per SM), which at W = 10 puts the real floor nearer 0.65 ms.
//
// Design: a block of 256 threads owns 32 query keys x 256 stored keys.
// Both key tiles go to shared memory once: the query tile row-major (every
// thread reads the same word: a broadcast), the stored tile transposed
// with a padded stride (thread t reads its own column, conflict-free).
// Each thread computes its stored key's 32 outputs with __popc, and the
// block writes them a query row at a time, so a warp's stores are 128
// contiguous bytes.  The (Q,N,W) XOR never exists anywhere.  Ragged Q and
// N are masked; W is a runtime width (the wrapper bounds it by shared
// memory).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;              // query keys per block
constexpr int kBN = 256;             // stored keys per block, one a thread
constexpr int kStride = kBN + 1;     // padded row of the transposed tile

__global__ void __launch_bounds__(kBN)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int nq, int n, int w) {
  extern __shared__ uint32_t sm[];
  uint32_t* as = sm;                   // [kBQ][w]
  uint32_t* bs = sm + kBQ * w;         // [w][kStride]
  const int q0 = blockIdx.y * kBQ, n0 = blockIdx.x * kBN;
  for (int i = threadIdx.x; i < kBQ * w; i += kBN)
    as[i] = (q0 + i / w < nq) ? a[(size_t)q0 * w + i] : 0u;
  for (int i = threadIdx.x; i < kBN * w; i += kBN) {   // coalesced reads
    const int r = i / w, k = i % w;
    bs[k * kStride + r] = (n0 + r < n) ? b[(size_t)n0 * w + i] : 0u;
  }
  __syncthreads();

  const int j = n0 + threadIdx.x;
  if (j >= n) return;
  const int rows = min(kBQ, nq - q0);
  for (int r = 0; r < rows; ++r) {
    int s = 0;
    for (int k = 0; k < w; ++k)
      s += __popc(as[r * w + k] ^ bs[k * kStride + threadIdx.x]);
    out[(size_t)(q0 + r) * n + j] = s;
  }
}

}  // namespace

extern "C" int hamming_launch(const void* a, const void* b, void* out, int nq,
                              int n, int w, void* stream) {
  dim3 grid((n + kBN - 1) / kBN, (nq + kBQ - 1) / kBQ);
  const size_t smem = (size_t)(kBQ + kStride) * w * sizeof(uint32_t);
  hamming_kernel<<<grid, kBN, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(out), nq, n, w);
  return static_cast<int>(cudaGetLastError());
}
