// pair_dist: all-pairs squared L2 distances, the brute-force oracle.
// (Q,d) f32 queries, (N,d) f32 items, (Q,) |q|^2, (N,) |x|^2 -> (Q,N) f32
//   out[i][j] = max(qs[i] + xs[j] - 2 q_i . x_j, 0)
// The norms arrive computed (the wrapper's one reduction per row, as the
// reference computes them outside its kernel); the epilogue fuses them.
//
// Replaces: src/repro/kernels/pair_dist.py, pair_dist_pallas / _kernel
// (the TPU kernel accumulates q.x^T on the MXU over d-steps and fuses the
// norm finalize into the last step).
//
// What bounds it on the H100: operations.  At the oracle's shape (1024
// queries x 500,000 items x d = 100) the product is 2*Q*N*d = 1.0e11 FLOP,
// 1.5 ms at the card's fp32 rate outside the tensor cores, against 0.61 ms
// for the 2.05 GB the output must write.  Tensor cores are deliberately not
// used: TF32 keeps ~10 mantissa bits, which misses the reference's 1e-4
// tolerance on distances of unit vectors.
//
// Design: a shared-memory-tiled FFMA product.  A block of 256 threads owns
// a 128 x 128 output tile; each thread keeps an 8 x 8 register block
// (rows {4ty..4ty+3, 64+4ty..}, columns {4tx..4tx+3, 64+4tx..}, so the
// float4 reads of a warp hit distinct banks).  d is walked in stages of 8:
// both operand tiles are staged transposed in shared memory, and the next
// stage's global loads are issued into registers before the current
// stage's FMAs.  Ragged Q, N and d are masked at the loads (zeros) and at
// the stores, never padded in device memory.  Rows of the output are
// written as float4 where N allows it (N % 4 == 0), so a warp's stores are
// whole 256 B runs.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;                          // queries per tile
constexpr int kBN = 128;                          // items per tile
constexpr int kBK = 8;                            // depth of one stage
constexpr int kThreads = 256;                     // 16 x 16 threads
constexpr int kLoads = kBM * kBK / kThreads;      // elements a thread stages
constexpr int kPad = 4;                           // keeps float4 alignment

__device__ __forceinline__ void load4(const float* s, float* r) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

__global__ void __launch_bounds__(kThreads)
pair_dist_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 const float* __restrict__ qs, const float* __restrict__ xs,
                 float* __restrict__ out, int nq, int n, int d) {
  __shared__ __align__(16) float as[kBK][kBM + kPad];
  __shared__ __align__(16) float bs[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // element e of a stage: row e / kBK, depth e % kBK (a warp reads 4 rows
  // x 8 neighbouring floats; the transposed smem writes hit 32 banks)
  float ra[kLoads], rb[kLoads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK, gk = k0 + e % kBK;
      ra[i] = (row0 + r < nq && gk < d) ? q[(size_t)(row0 + r) * d + gk] : 0.f;
      rb[i] = (col0 + r < n && gk < d) ? x[(size_t)(col0 + r) * d + gk] : 0.f;
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < d; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      as[e % kBK][e / kBK] = ra[i];
      bs[e % kBK][e / kBK] = rb[i];
    }
    __syncthreads();
    if (k0 + kBK < d) fetch(k0 + kBK);   // in flight during the FMAs
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[8];
      load4(&as[k][4 * ty], a);
      load4(&as[k][64 + 4 * ty], a + 4);
      load4(&bs[k][4 * tx], b);
      load4(&bs[k][64 + 4 * tx], b + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool vec = (n & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (gr >= nq) continue;
    const float qv = qs[gr];
    float* orow = out + (size_t)gr * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = col0 + 64 * h + 4 * tx;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = fmaxf(qv + xs[min(gc + j, n - 1)] - 2.f * acc[i][4 * h + j],
                     0.f);
      if (vec && gc + 3 < n) {
        *reinterpret_cast<float4*>(orow + gc) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < n) orow[gc + j] = v[j];
      }
    }
  }
}

}  // namespace

extern "C" int pair_dist_launch(const void* q, const void* x, const void* qs,
                                const void* xs, void* out, int nq, int n,
                                int d, void* stream) {
  dim3 grid((n + kBN - 1) / kBN, (nq + kBM - 1) / kBM);
  pair_dist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<const float*>(qs), static_cast<const float*>(xs),
      static_cast<float*>(out), nq, n, d);
  return static_cast<int>(cudaGetLastError());
}
