// lsh_hash: packed sign-random-projection keys, (N,d) f32 x (d,P) f32 ->
// (N, P/32) u32, bit j of word w (MSB first) = [x . a[:, 32w+j] >= 0].
//
// Replaces: src/repro/kernels/lsh_hash.py, lsh_hash_pallas / _kernel
// (the TPU kernel fuses sign + bit-pack into the MXU matmul epilogue).
//
// What bounds it on the H100: at the main-path shape (N = 4096 rows,
// d = 100, P = L*32 = 320) the work is 2*N*d*P = 262 MFLOP of fp32 and
// ~1.8 MB of input, so the fp32 (non-tensor-core) FMA rate bounds it,
// not memory.  Tensor cores are deliberately not used: TF32 keeps ~10
// mantissa bits and flips the sign of projections near zero, and a flipped
// bit moves an item to another hash tree.
//
// Design: one thread computes one output word, i.e. the 32 dot products
// of one row with 32 columns of A, in 32 fp32 registers.  A warp owns one
// word (the same 32 columns) for 32 consecutive rows, so every lane reads
// the same A element from shared memory (a broadcast) and its own x row
// (row stride padded to 33 floats: conflict-free).  d is walked in tiles
// of 32; the x tile and the A tile are staged in shared memory.  Ragged d
// and ragged N are masked at the loads, never padded in device memory.
// The (N, P) projection never leaves registers: only the packed words are
// written.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;            // rows per block == lanes per warp
constexpr int kWordsPerBlock = 4;    // one warp per output word
constexpr int kTileD = 32;           // depth of one shared-memory stage

__global__ void __launch_bounds__(kRows * kWordsPerBlock)
lsh_hash_kernel(const float* __restrict__ x, const float* __restrict__ a,
                uint32_t* __restrict__ out, int n, int d, int words) {
  __shared__ float xs[kRows][kTileD + 1];
  __shared__ float as[kTileD][kWordsPerBlock * 32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const int word0 = blockIdx.y * kWordsPerBlock;
  const int p = words * 32;            // columns of A
  const int col0 = word0 * 32;         // first column staged by this block

  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kTileD) {
    // x tile: kRows x kTileD, row-major loads (lane walks k)
    for (int i = threadIdx.x; i < kRows * kTileD; i += blockDim.x) {
      int r = i / kTileD, k = i % kTileD;
      int gr = row0 + r, gk = k0 + k;
      xs[r][k] = (gr < n && gk < d) ? x[(size_t)gr * d + gk] : 0.f;
    }
    // A tile: kTileD x (kWordsPerBlock*32), coalesced along columns
    for (int i = threadIdx.x; i < kTileD * kWordsPerBlock * 32;
         i += blockDim.x) {
      int k = i / (kWordsPerBlock * 32), c = i % (kWordsPerBlock * 32);
      int gk = k0 + k, gc = col0 + c;
      as[k][c] = (gk < d && gc < p) ? a[(size_t)gk * p + gc] : 0.f;
    }
    __syncthreads();
    const int kmax = min(kTileD, d - k0);
    for (int k = 0; k < kmax; ++k) {
      const float xv = xs[lane][k];
      const float* arow = &as[k][warp * 32];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = fmaf(xv, arow[j], acc[j]);
    }
    __syncthreads();
  }

  const int row = row0 + lane;
  const int word = word0 + warp;
  if (row < n && word < words) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) w |= (acc[j] >= 0.f ? 1u : 0u) << (31 - j);
    out[(size_t)row * words + word] = w;
  }
}

}  // namespace

extern "C" int lsh_hash_launch(const void* x, const void* a, void* out,
                               int n, int d, int words, void* stream) {
  dim3 grid((n + kRows - 1) / kRows,
            (words + kWordsPerBlock - 1) / kWordsPerBlock);
  lsh_hash_kernel<<<grid, kRows * kWordsPerBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<uint32_t*>(out), n, d, words);
  return static_cast<int>(cudaGetLastError());
}
