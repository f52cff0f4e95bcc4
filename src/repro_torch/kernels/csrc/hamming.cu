// hamming: bit differences between packed compound keys.
// (Q,W) query keys x (N,W) stored keys, int64 holding u32 -> (Q,N) i32,
//   out[i][j] = sum over words w of popcount(a[i][w] ^ b[j][w]).
// The kernel reads the int64 keys itself and takes each one's low 32 bits
// (the reference's astype(uint32)); nothing runs beside the launch.
//
// Replaces: src/repro/kernels/hamming.py, hamming_pallas / _kernel (the
// TPU kernel XORs a (bq, bn, W) tile in VMEM and sums a SWAR popcount).
//
// What bounds it on the H100: bytes.  The (Q,N) i32 output must be written
// (1.07 GB at 1024 x 262,144 keys: 0.32 ms at the card's memory rate).  A
// popcount a word on the ALU (16 a clock per SM) alone would take about
// twice that at W = 10, so the bit count goes to the int8 tensor cores.
//
// The identity: popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b), and summed
// over the words the last term is the dot product of the two keys' 32W
// bits as {0,1} vectors: an s32-accumulated
// mma.sync.m16n8k32.row.col.s32.u8.u8.s32 a word (K = 32 bits), exact.
// The H100 has no binary tensor-core type, so the bits go in as bytes.
//
// Expansion, free of tables: which bit of a word feeds which k of the MMA
// is ours to choose, as long as A and B agree.  Lane (g, t) of a fragment
// holds k = 4t + j (register 0 of B, 0 and 1 of A) and k = 16 + 4t + j
// (the others), j = 0..3, one per byte.  Map k = 4t + j to bit t + 8j and
// k = 16 + 4t + j to bit t + 4 + 8j: the 32 bits are each used once, and a
// register is (word >> t) & 0x01010101, or (word >> (t + 4)) & 0x01010101,
// two integer instructions.  The key tiles stay packed in shared memory
// (a row stride W | 1 words: odd, so the 8 rows of a fragment fall in 8
// banks) and every fragment is built from its word as it is needed.
//
// Design: a block of 128 threads owns 64 query keys x 128 stored keys;
// each warp 64 x 32 outputs (four m16 x four n8 MMA tiles), W k32 steps.
// Blocks walk the tiles query-tile fastest, so the blocks that share a
// stored-key tile run together and read it from device memory once.  The
// key tiles arrive by 4-byte cp.async copies, all in flight at once (a
// load-then-store loop kept one round trip in flight a thread and was
// far slower); the block then sums each key's popcount once.  The stores
// leave registers directly, as in pair_dist.cu: lanes t and t^1 swap half
// their accumulators with one shuffle pair, so each lane holds 4
// neighbouring columns of one row and writes them as one 16-byte store; a
// warp's four n8 tiles fill each row's 128 bytes.  Five blocks an SM (96
// registers) keep the stores going while others stage their tiles.  Where
// N % 4 != 0 the rows are not 16-byte aligned and every output is stored
// alone; ragged Q and N are masked.  Designs timed on the H100 and
// dropped, all slower: the stores staged through shared memory so that a
// warp writes whole 128-byte rows; streaming stores (st.global.cs); a
// persistent block copying the next tile's keys during this tile's
// products (127 registers, four blocks an SM); tiles of 64 x 256 (256
// threads) and of 32 x 128; a register cap for six blocks an SM.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64, kBN = 128;   // query x stored keys of a block
constexpr int kMT = 4, kNT = 4;      // a warp: 64 x 32 outputs
static_assert(kBQ == 16 * kMT && kBN == (kThreads / 32) * 8 * kNT,
              "the warps cover the tile");
constexpr uint32_t kBit0 = 0x01010101u;

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows [r0, r0 + rows) of a (total, w) int64 key matrix -> their low words
// in a (rows, S) u32 tile, zero past `total`: one 4-byte cp.async a key
// word, from the int64's low half (little-endian), all of a thread's
// copies in flight at once (the caller waits for them).
__device__ __forceinline__ void stage(const int64_t* __restrict__ keys,
                                      int64_t total, int64_t r0, int rows,
                                      int w, int S, uint32_t* tile) {
  const int64_t have = total - r0;
  const int live = (int)(have < rows ? have : rows);
  const int64_t* src = keys + r0 * w;
  const int dr = kThreads / w, dk = kThreads % w;
  int r = threadIdx.x / w, k = threadIdx.x % w;
  for (int i = threadIdx.x; i < rows * w; i += kThreads) {
    const bool ok = r < live;
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(tile + r * S + k));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src + (ok ? i : 0)), "r"(ok ? 4 : 0));
    r += dr;
    k += dk;
    if (k >= w) {
      k -= w;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hamming_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
               int32_t* __restrict__ out, int nq, int n, int w, int q_tiles,
               bool vec) {
  extern __shared__ uint32_t sm[];
  const int S = w | 1;
  uint32_t* as = sm;                           // [kBQ][S]
  uint32_t* bs = as + kBQ * S;                 // [kBN][S]
  int* pa = reinterpret_cast<int*>(bs + kBN * S);   // [kBQ]
  int* pb = pa + kBQ;                               // [kBN]
  const int q0 = (blockIdx.x % q_tiles) * kBQ;
  const int n0 = (blockIdx.x / q_tiles) * kBN;
  stage(a, nq, q0, kBQ, w, S, as);
  stage(b, n, n0, kBN, w, S, bs);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  {
    const int r = threadIdx.x;                 // kBN == kThreads rows
    int s = 0;
    for (int k = 0; k < w; ++k) s += __popc(bs[r * S + k]);
    pb[r] = s;
    if (r < kBQ) {
      s = 0;
      for (int k = 0; k < w; ++k) s += __popc(as[r * S + k]);
      pa[r] = s;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn0 = warp * 8 * kNT;
  const uint32_t* ar = as + g * S;             // row g of m-tile 0
  const uint32_t* br = bs + (wn0 + g) * S;     // key g of n-tile 0
  int acc[kMT][kNT][4] = {};
  for (int k = 0; k < w; ++k) {
    uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const uint32_t lo = ar[(16 * i) * S + k] >> t;
      const uint32_t hi = ar[(16 * i + 8) * S + k] >> t;
      af[i][0] = lo & kBit0;
      af[i][1] = hi & kBit0;
      af[i][2] = (lo >> 4) & kBit0;
      af[i][3] = (hi >> 4) & kBit0;
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const uint32_t v = br[(8 * j) * S + k] >> t;
      bf[j][0] = v & kBit0;
      bf[j][1] = (v >> 4) & kBit0;
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_u8(acc[i][j], af[i], bf[j]);
  }

  // Lane (g, t) holds, for MMA tile (i, j), rows g (c0, c1) and g + 8 (c2,
  // c3) at columns 2t, 2t + 1; after the swap with lane t^1 an even t
  // holds row g, columns 2t..2t+3, an odd t row g + 8, columns 2t-2..2t+1.
  const bool odd = t & 1;
  const int lr = g + (odd ? 8 : 0);
  const int lc = wn0 + 2 * (t & 2);
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int r = lr + 16 * i;
    const int pr = pa[r];
    const bool live = q0 + r < nq;
    int32_t* row = out + (size_t)(q0 + r) * n + n0;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int* c = acc[i][j];
      const int s0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const int s1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      const int cl = lc + 8 * j;
      const int4 p = *reinterpret_cast<const int4*>(pb + cl);
      const int4 o = make_int4(pr + p.x - 2 * (odd ? s0 : c[0]),
                               pr + p.y - 2 * (odd ? s1 : c[1]),
                               pr + p.z - 2 * (odd ? c[2] : s0),
                               pr + p.w - 2 * (odd ? c[3] : s1));
      if (!live || n0 + cl >= n) continue;
      if (vec) {                               // n % 4 == 0: cl + 3 < n
        *reinterpret_cast<int4*>(row + cl) = o;
      } else {
        const int e[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (n0 + cl + k < n) row[cl + k] = e[k];
      }
    }
  }
}

}  // namespace

// a, b: int64 keys (their low 32 bits are the key), out: (nq, n) int32.
extern "C" int hamming_launch(const void* a, const void* b, void* out, int nq,
                              int n, int w, void* stream) {
  const int q_tiles = (nq + kBQ - 1) / kBQ;
  const long long tiles = (long long)q_tiles * ((n + kBN - 1) / kBN);
  const size_t smem = (size_t)(kBQ + kBN) * ((w | 1) + 1) * sizeof(uint32_t);
  if (w < 1 || tiles > INT_MAX || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  hamming_kernel<<<static_cast<unsigned>(tiles), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b),
      static_cast<int32_t*>(out), nq, n, w, q_tiles, vec);
  return static_cast<int>(cudaGetLastError());
}
