// lsh_hash: packed sign-random-projection keys, (N,d) f32 x (d,P) f32 ->
// (N, P/32) int64 keys in [0, 2^32): bit j of word w (MSB first) is
// [x . a[:, 32w+j] >= 0].
//
// Replaces: src/repro/kernels/lsh_hash.py, lsh_hash_pallas / _kernel
// (the TPU kernel fuses sign + bit-pack into the MXU matmul epilogue).
//
// What bounds it on the H100: at the main-path shapes (N = 4096 inserts or
// 1024 queries, d = 100, P = L*32 = 320) the work is 2*N*d*P = 262 (65)
// MFLOP on ~1.8 MB of input: a few microseconds at any rate.  Timed
// variants on the card put the time in two places: moving the operand
// tiles from L2 into shared memory (x is read once per column block, a
// once per row block: 25 MB at 32 x 64 tiles) and the 3xTF32 MMAs, which
// mma.sync runs at well under the tensor cores' peak.
//
// Design: the shared 3xTF32 tensor-core product of f32_product.cuh, whose
// fp32-level accuracy keeps every sign that lies 1e-4 or more from zero.
// The TMA copies a block's x tile and, in parts of 32 rows of K, its a
// tile; the MMAs on a part start as soon as it has landed.  Warps own
// 32-row x 1-word tiles (two m16 x four n8 MMA tiles).  The block tile is
// picked at launch: 64 rows x 5 words (10 warps) where that still gives
// most SMs a block (the insert batch: 128 blocks, 11.5 MB of tile
// traffic), else 64 rows x 2 words (4 warps; the query batch N = 1024: 80
// blocks).  Epilogue: each lane signs its accumulators into the bits of
// its own columns, the four lanes of a quad (which share rows) OR their
// bits together with two shuffles, and the word is written as an int64
// key, so one call is one launch.  The (N, P) projection never leaves
// registers.  Rows not 16-byte aligned (d % 4 != 0) or d > 128 (not on the
// path) take cp.async copies instead.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "f32_product.cuh"

namespace {

constexpr int kMT = 2;               // m16 row tiles a warp owns
constexpr int kWarpsM = 2;           // warps down the rows (64 rows)
constexpr int kMaxK = 128;           // one chunk up to this d, ...
constexpr int kStepK = 64;           // ... else chunks of 64, two buffers

// A block of kWarpsM x WORDS warps: 16 kMT kWarpsM rows x WORDS words.
template <int WORDS>
struct Tile {
  static constexpr int kRows = 16 * kMT * kWarpsM;
  static constexpr int kCols = 32 * WORDS;
  static constexpr int kThreads = 32 * kWarpsM * WORDS;
};

template <int WORDS>
__global__ void __launch_bounds__(Tile<WORDS>::kThreads)
lsh_hash_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap a_tail, bool tma,
                long long* __restrict__ out, int n, int d, int words, int kc,
                bool vec) {
  using T = Tile<WORDS>;
  extern __shared__ __align__(128) float smem[];
  const int row0 = blockIdx.x * T::kRows;
  const int word0 = blockIdx.y * WORDS;
  float acc[kMT][4][4];
  f32p::product_tile<T::kRows, T::kCols, kMT, 4, true>(
      x, n, a, words * 32, d, row0, word0 * 32, kc, vec,
      tma ? &x_map : nullptr, &a_map, &a_tail, smem, acc, f32p::NoHook{});

  // sign and pack: for m16 tile i, lane (g, t) holds columns 8j + 2t and
  // 8j + 2t + 1 (j < 4) of its warp's word, for rows g (c0, c1) and g + 8
  // (c2, c3); the quad's four lanes OR their bits into whole words
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int word = word0 + warp % WORDS;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    uint32_t top = 0, bot = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = 31 - (8 * j + 2 * t);
      top |= (acc[i][j][0] >= 0.f ? 1u : 0u) << s;
      top |= (acc[i][j][1] >= 0.f ? 1u : 0u) << (s - 1);
      bot |= (acc[i][j][2] >= 0.f ? 1u : 0u) << s;
      bot |= (acc[i][j][3] >= 0.f ? 1u : 0u) << (s - 1);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      top |= __shfl_xor_sync(0xffffffffu, top, off);
      bot |= __shfl_xor_sync(0xffffffffu, bot, off);
    }
    const int row = row0 + (warp / WORDS) * 16 * kMT + 16 * i + g +
                    (t == 1 ? 8 : 0);
    if (t < 2 && row < n && word < words)
      out[(size_t)row * words + word] =
          static_cast<long long>(t == 0 ? top : bot);
  }
}

template <int WORDS>
int launch(const float* x, const float* a, long long* out, int n, int d,
           int words, cudaStream_t stream) {
  using T = Tile<WORDS>;
  int kc;
  size_t smem;
  f32p::plan_chunks<T::kRows, T::kCols, true>(d, kMaxK, kStepK, &kc, &smem);
  static const cudaError_t set = f32p::allow_smem(
      lsh_hash_kernel<WORDS>,
      f32p::most_smem<T::kRows, T::kCols, true>(kMaxK, kStepK));
  if (set != cudaSuccess) return static_cast<int>(set);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0;
  // TMA copies where K is one chunk and rows are 16-byte aligned
  CUtensorMap x_map = {}, a_map = {}, a_tail = {};
  const bool tma = vec && d <= kMaxK;
  if (tma) {
    const int tail = kc - (kc - 1) / f32p::kPart * f32p::kPart;
    const int sb = T::kCols + 4;
    cudaError_t e = f32p::tensor_map(&x_map, x, n, d, T::kRows,
                                     f32p::row_stride(kc));
    if (e == cudaSuccess)
      e = f32p::tensor_map(&a_map, a, d, words * 32, f32p::kPart, sb);
    if (e == cudaSuccess)
      e = f32p::tensor_map(&a_tail, a, d, words * 32, tail, sb);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((n + T::kRows - 1) / T::kRows, (words + WORDS - 1) / WORDS);
  lsh_hash_kernel<WORDS><<<grid, T::kThreads, smem, stream>>>(
      x, a, x_map, a_map, a_tail, tma, out, n, d, words, kc, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lsh_hash_launch(const void* x, const void* a, void* out,
                               int n, int d, int words, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  long long* o = static_cast<long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 5-word tiles move the least from L2 while they still give three
  // quarters of the SMs a block; at the query batch they would leave most
  // SMs idle (scripts/kernel_variants.py times both at both batches)
  constexpr int kRows = Tile<5>::kRows;
  const long long wide = (long long)((n + kRows - 1) / kRows) *
                         ((words + 4) / 5);
  if (4 * wide >= 3LL * f32p::sm_count())
    return launch<5>(xf, af, o, n, d, words, s);
  return launch<2>(xf, af, o, n, d, words, s);
}
