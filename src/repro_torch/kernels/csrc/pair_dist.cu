// pair_dist: all-pairs squared L2 distances, the brute-force oracle.
// (Q,d) f32 queries, (N,d) f32 items -> (Q,N) f32
//   out[i][j] = max(|q_i|^2 + |x_j|^2 - 2 q_i . x_j, 0)
// The kernel computes the norms itself: nothing runs beside the launch.
//
// Replaces: src/repro/kernels/pair_dist.py, pair_dist_pallas / _kernel
// (the TPU kernel accumulates q.x^T on the MXU over d-steps and fuses the
// norm finalize into the last step).
//
// What bounds it on the H100: at the oracle's shape (1024 queries x
// 500,000 items x d = 100) the product is 2*Q*N*d = 1.0e11 FLOP, which the
// fastest fp32-accurate route (3xTF32 on the dense TF32 tensor cores, 3 x
// 1.0e11 at 495 TFLOP/s) does in 0.62 ms, against 0.61 ms for the 2.05 GB
// the output must write: bytes and operations about equal, so the stores
// must overlap the products.  mma.sync reaches ~320 of the 495 TFLOP/s on
// this card, so ~0.95 ms is the floor of this route.
//
// Design: the shared 3xTF32 tensor-core product of f32_product.cuh in one
// persistent block an SM (d <= 104, rows 16-byte aligned).  The block
// keeps 128 queries in shared memory and walks 128-item tiles, which the
// TMA copies into a ring of three buffers, each filled three tiles ahead.
// Its 16 warps are two teams of 8 (64 x 32 outputs a warp: four m16 x
// four n8 MMA tiles) that take the tiles in turn: named barriers let a
// team start its MMAs only when the other has issued 3/4 of its k8 steps,
// so one team's stores run beside the other's MMAs.  The stores leave
// registers directly: lanes t and t^1 of a quad swap half their
// accumulators with one shuffle pair, so each lane holds 4 neighbouring
// columns of one row and writes them as one 16-byte streaming store
// (st.global.cs); the output's rows are padded to a multiple of 4 floats,
// so every such store is aligned, whatever N.  Designs timed on the H100
// and dropped: two independent blocks an SM ran their MMAs at the same
// times and then their stores at the same times; all 16 warps on each
// tile, with the output staged in shared memory and written by TMA bulk
// stores, stored no faster and ran the MMAs on smaller warp tiles; of the
// hand-over points 1/2, 3/4 and all of a team's k8 steps, 3/4 was
// fastest.  Tiles are walked so that the blocks of one query group take
// neighbouring item tiles together and an item tile is read from device
// memory once.  The norms are summed from the staged rows, one row a
// thread: no pass over device memory.
//
// Elsewhere (d > 104, rows of q or x not 16-byte aligned, or more query
// groups than SMs; none on the path) pair_dist_chunked_kernel: one 128 x
// 128 tile a block, K walked in double-buffered cp.async chunks of 40.
// Ragged Q, N and d are masked at the loads (zero fill) and the stores.
// An N that is not a multiple of 4, where a row's 16-byte boundaries would
// fall off the lanes' runs, was first stored realigned through a partner
// lane, which ran markedly slower per item on the H100, so the wrapper
// pads the rows instead and returns a view of the first N.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "f32_product.cuh"

namespace {

constexpr int kBM = 128, kBN = 128;  // queries x items of a tile
constexpr int kMT = 4, kNT = 4;      // warps of 64 x 32 outputs
constexpr int kWarpsN = kBN / (8 * kNT);
constexpr int kTeam = (kBM / (16 * kMT)) * kWarpsN * 32;              // 256
static_assert(kBM + kBN == kTeam, "one staged row per thread");
constexpr int kThreads = 2 * kTeam;  // persistent kernel: two teams,
constexpr int kBufs = 3;             // a ring of item tiles,
constexpr int kMaxK = 104;           // K in one chunk, and a team's turn
constexpr int kHandoffNum = 3;       // on the tensor cores ends when it
constexpr int kHandoffDen = 4;       // has issued 3/4 of its k8 steps
constexpr int kStepK = 40;           // chunked kernel: chunks of 40

// The distances of a warp's (16 MT) x (8 NT) outputs at (wm0, wn0) of a
// tile, handed to sink(r, c, o) a row at a time: o[j] = max(qn[r] +
// xn[c'] - 2 acc, 0) for the 4 neighbouring columns c' = c + 8j .. + 3
// (tile coordinates).  Lane (g, t) holds, for MMA tile (i, j), rows g (c0,
// c1) and g + 8 (c2, c3) at columns 2t, 2t + 1; after the swap with lane
// t^1 an even t holds row g, columns 2t..2t+3, an odd t row g + 8,
// columns 2t-2..2t+1.
template <int MT, int NT, class Sink>
__device__ __forceinline__ void distances(const float (&acc)[MT][NT][4],
                                          const float* qn, const float* xn,
                                          int wm0, int wn0, int lane,
                                          Sink sink) {
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  const int lr = wm0 + g + (odd ? 8 : 0);       // row of tile i = 0
  const int lc = wn0 + 2 * (t & 2);             // column of tile j = 0
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float qv = qn[lr + 16 * i];
    float4 o[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* c = acc[i][j];
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      const float v[4] = {odd ? s0 : c[0], odd ? s1 : c[1],
                          odd ? c[2] : s0, odd ? c[3] : s1};
      const int cl = lc + 8 * j;
      o[j].x = fmaxf(qv + xn[cl] - 2.f * v[0], 0.f);
      o[j].y = fmaxf(qv + xn[cl + 1] - 2.f * v[1], 0.f);
      o[j].z = fmaxf(qv + xn[cl + 2] - 2.f * v[2], 0.f);
      o[j].w = fmaxf(qv + xn[cl + 3] - 2.f * v[3], 0.f);
    }
    sink(lr + 16 * i, lc, o);
  }
}

// Writes distances straight to the output from registers with 16-byte
// streaming stores (st.global.cs).  The output's rows are `ld` floats
// apart, ld a multiple of 4 (the wrapper pads each row of N to it), so a
// lane's 4-column run is always one aligned store; a run that N cuts
// goes element-wise (writing it whole into the row's padding timed
// slower on the H100) and rows past nq are dropped.
struct GlobalSink {
  float* out;
  int nq, n, ld, row0, col0;

  template <int NT>
  __device__ __forceinline__ void operator()(int r, int c,
                                             const float4 (&o)[NT]) const {
    r += row0;
    c += col0;
    if (r >= nq) return;
    float* row = out + (size_t)r * ld;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int cj = c + 8 * j;
      if (cj < n) {
        if (cj + 3 < n) {
          __stcs(reinterpret_cast<float4*>(row + cj), o[j]);
        } else {
          const float e[4] = {o[j].x, o[j].y, o[j].z, o[j].w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (cj + k < n) __stcs(row + cj + k, e[k]);
        }
      }
    }
  }
};

// Sum of squares of a staged row of `cols` floats (a multiple of 4).
__device__ __forceinline__ float row_norm(const float* row, int cols) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float s = 0.f;
  for (int k = 0; k < cols / 4; ++k) {
    const float4 v = r[k];
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  return s;
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Block b takes work units u = b, b + gridDim.x, ... (unit u: query group
// u % groups, item tile u / groups); gridDim.x is a multiple of groups, so
// its query group is b % groups.  Its i-th tile goes to team i % 2 and to
// buffer i % kBufs.  Named barriers: 1 + team within a team; 3 + (i % 2)
// "the MMAs on tile i are far enough along", arrived at by one team after
// kHandoffNum / kHandoffDen of its k8 steps, waited on by the other.
__global__ void __launch_bounds__(kThreads, 1)
pair_dist_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap x_map, float* out,
                 int nq, int n, int ld, int kc, int groups, int units) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float qn[kBM];                     // |q|^2 of the group
  __shared__ float xn[2][kBN];                  // |x|^2, a team's tile
  __shared__ uint64_t q_bar, x_bar[kBufs];
  const int S = f32p::row_stride(kc);
  const unsigned tile_bytes = 4u * kBN * S;
  float* sq = smem;                             // then kBufs item tiles
  auto sx = [&](int buf) { return smem + (1 + buf) * kBN * S; };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team = warp / (kTeam / 32), ttid = tid % kTeam;
  const int tw = warp % (kTeam / 32);
  const int wm0 = (tw / kWarpsN) * 16 * kMT, wn0 = (tw % kWarpsN) * 8 * kNT;
  const int group = blockIdx.x % groups, row0 = group * kBM;
  const int tiles = (units - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto col0 = [&](int i) {
    return static_cast<int>((blockIdx.x + (long long)i * gridDim.x) /
                            groups) * kBN;
  };

  if (tid == 0) {
    f32p::mbar_init(&q_bar);
    for (int b = 0; b < kBufs; ++b) f32p::mbar_init(&x_bar[b]);
    f32p::mbar_arm(&q_bar, tile_bytes);
    f32p::tma_load(sq, &q_map, 0, row0, &q_bar);
    for (int i = 0; i < kBufs && i < tiles; ++i) {
      f32p::mbar_arm(&x_bar[i], tile_bytes);
      f32p::tma_load(sx(i), &x_map, 0, col0(i), &x_bar[i]);
    }
  }
  __syncthreads();
  f32p::mbar_wait(&q_bar, 0);
  if (tid < kBM) qn[tid] = row_norm(sq + tid * S, kc);
  __syncthreads();

  const int ksteps = kc / 8, handoff = ksteps * kHandoffNum / kHandoffDen;
  for (int i = team; i < tiles; i += 2) {
    const int buf = i % kBufs;
    float* xs = sx(buf);
    f32p::mbar_wait(&x_bar[buf], (i / kBufs) & 1);
    bar_sync(1 + team, kTeam);          // the team's last epilogue is done
    if (ttid < kBN) xn[team][ttid] = row_norm(xs + ttid * S, kc);
    if (i > 0) bar_sync(3 + ((i - 1) & 1), kThreads);   // the other team's
    float acc[kMT][kNT][4] = {};                        // turn is far along
    f32p::warp_mma_chunk<kMT, kNT, false>(sq, S, xs, S, handoff, wm0, wn0,
                                          acc, lane);
    if (i + 1 < tiles) bar_arrive(3 + (i & 1), kThreads);
    f32p::warp_mma_chunk<kMT, kNT, false>(sq + 8 * handoff, S,
                                          xs + 8 * handoff, S,
                                          ksteps - handoff, wm0, wn0, acc,
                                          lane);
    bar_sync(1 + team, kTeam);          // xn visible; xs read by the team
    if (ttid == 0 && i + kBufs < tiles) {
      f32p::fence_async_smem();
      f32p::mbar_arm(&x_bar[buf], tile_bytes);
      f32p::tma_load(xs, &x_map, 0, col0(i + kBufs), &x_bar[buf]);
    }
    distances(acc, qn, xn[team], wm0, wn0, lane,
              GlobalSink{out, nq, n, ld, row0, col0(i)});
  }
}

__global__ void __launch_bounds__(kTeam, 2)
pair_dist_chunked_kernel(const float* __restrict__ q,
                         const float* __restrict__ x, float* out, int nq,
                         int n, int ld, int d, int kc, int q_tiles,
                         bool vec_in) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float norms[kBM + kBN];            // |q|^2 rows, |x|^2 columns
  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x % q_tiles) * kBM;
  const int col0 = (blockIdx.x / q_tiles) * kBN;
  float nrm = 0.f;                  // row tid of the staged [q; x] tiles
  auto sum_squares = [&](const float* sA, int S, const float*, int,
                         int cols) { nrm += row_norm(sA + tid * S, cols); };
  float acc[kMT][kNT][4];
  f32p::product_tile<kBM, kBN, kMT, kNT, false>(
      q, nq, x, n, d, row0, col0, kc, vec_in, nullptr, nullptr, nullptr,
      smem, acc, sum_squares);
  norms[tid] = nrm;
  __syncthreads();
  const int warp = tid >> 5;
  distances(acc, norms, norms + kBM, (warp / kWarpsN) * 16 * kMT,
            (warp % kWarpsN) * 8 * kNT, tid & 31,
            GlobalSink{out, nq, n, ld, row0, col0});
}

}  // namespace

// out: (nq, ld) floats, 16-byte aligned, ld >= n a multiple of 4.
extern "C" int pair_dist_launch(const void* q, const void* x, void* out,
                                int nq, int n, int ld, int d, void* stream) {
  if (ld % 4 != 0 || ld < n || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_in = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (nq + kBM - 1) / kBM;
  const int sms = f32p::sm_count();
  if (vec_in && d <= kMaxK && groups <= sms) {
    const int kc = (d + 7) / 8 * 8;
    const int S = f32p::row_stride(kc);
    static const cudaError_t set = f32p::allow_smem(
        pair_dist_kernel,
        sizeof(float) * (1 + kBufs) * kBN * f32p::row_stride(kMaxK));
    if (set != cudaSuccess) return static_cast<int>(set);
    const long long units = (long long)groups * ((n + kBN - 1) / kBN);
    if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    long long grid = sms / groups * groups;     // one block an SM
    if (grid > units) grid = units;
    CUtensorMap q_map, x_map;
    cudaError_t e = f32p::tensor_map(&q_map, qf, nq, d, kBM, S);
    if (e == cudaSuccess) e = f32p::tensor_map(&x_map, xf, n, d, kBN, S);
    if (e != cudaSuccess) return static_cast<int>(e);
    pair_dist_kernel<<<static_cast<unsigned>(grid), kThreads,
                       sizeof(float) * (1 + kBufs) * kBN * S, s>>>(
        q_map, x_map, of, nq, n, ld, kc, groups, static_cast<int>(units));
  } else {
    int kc;
    size_t smem;
    f32p::plan_chunks<kBM, kBN, false>(d, 0, kStepK, &kc, &smem);
    static const cudaError_t set = f32p::allow_smem(
        pair_dist_chunked_kernel, f32p::most_smem<kBM, kBN, false>(0, kStepK));
    if (set != cudaSuccess) return static_cast<int>(set);
    const int q_tiles = (nq + kBM - 1) / kBM;
    const long long tiles = (long long)q_tiles * ((n + kBN - 1) / kBN);
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    pair_dist_chunked_kernel<<<static_cast<unsigned>(tiles), kTeam, smem,
                               s>>>(qf, xf, of, nq, n, ld, d, kc, q_tiles,
                                    vec_in);
  }
  return static_cast<int>(cudaGetLastError());
}
