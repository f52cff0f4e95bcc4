// f32_product.cuh: the fp32-accurate tensor-core product shared by
// lsh_hash.cu and pair_dist.cu.
//
// Both kernels compute a small-K fp32 product (K = d = 100 on the main
// path) and differ only in what they do with the sums, so the product is
// written once here and each kernel gives it an epilogue.
//
// Accuracy: 3xTF32.  Each operand is split into a TF32 high part and a
// remainder, hi = rna(v) and lo = v - hi (exact in fp32), and the product
// is summed as lo*hi + hi*lo + hi*hi on the tensor cores
// (mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, fp32 accumulators).  The
// tensor core reads the top 19 bits of lo, and the dropped lo*lo term is
// below 2^-22 of |a||b|, so each product is within ~2^-21 of |a||b|, as
// good as an fp32 FFMA loop: lsh_hash keeps its exact signs beyond a 1e-4
// margin and pair_dist its 1e-4 tolerance.  TF32 without the two remainder
// products keeps ~11 bits (about 5e-4 on d = 100 unit vectors) and is
// never used.
//
// Staging: a block's A tile (BM rows of a row-major (M, K) matrix) and B
// tile (BN rows of a row-major (N, K) matrix, or BN columns of a row-major
// (K, N) one) are copied to shared memory without the threads waiting on
// each copy.  Where rows are 16-byte aligned (K % 4 == 0, the path's d =
// 100) one thread asks the Tensor Memory Accelerator (TMA) for whole
// tiles or parts of them: one cp.async.bulk.tensor instruction a box,
// completing on an mbarrier, with the parts outside the matrix
// zero-filled by the copy.  A per-thread cp.async queue of ~20 copies a
// thread instead blocked every thread at issue while the memory system
// drained it (scripts/kernel_variants.py, lsh_cp_async).  Elsewhere 16- or
// 4-byte cp.async copies, which zero-fill the outside themselves.  Ragged M, N
// and K are never padded in device memory.  Where K fits one chunk (the
// host picks kc) there is one buffer; else two, and the next chunk's
// copies are issued before the current chunk's MMAs.
//
// Fragments: within each k8 step, MMA column t is depth 2t and column
// t + 4 depth 2t + 1 (the same for A and B, so the sum is unchanged).  A
// lane's two values of a row are then neighbours, one 8-byte load.
// Shared-memory strides keep those loads free of bank conflicts: a
// row-major tile's row stride is == 8 or 24 (mod 32) (row_stride), so the
// 4 rows x 8 floats of a half-warp fall in 32 banks; a (K, N) B tile's is
// BN + 4, so the rows 2t, 2t + 1 of a quad fall in distinct banks.
#pragma once
#include <cstddef>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace f32p {

// ---------------------------------------------------------------- copies
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -------------------------------------------- TMA copies on an mbarrier
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival (the barrier's only one a phase) that also expects `bytes`
// of copies to complete before the phase does.
__device__ __forceinline__ void mbar_arm(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Orders the block's earlier shared-memory reads (after a barrier) before
// the TMA copies this thread issues next into the same bytes.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The box of `map` at (column c0, row r0) into s, completing on bar.
__device__ __forceinline__ void tma_load(float* s, const CUtensorMap* map,
                                         int c0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(s)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
      "r"(smem_u32(bar))
      : "memory");
}

// A map of the row-major (rows, cols) fp32 matrix g in boxes of box_rows x
// box_cols, landing in shared memory as box_rows rows of box_cols floats;
// what lies outside the matrix arrives as zeros.  Needs cols % 4 == 0 and
// g 16-byte aligned.
inline cudaError_t tensor_map(CUtensorMap* map, const float* g, int rows,
                              int cols, int box_rows, int box_cols) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(g), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Copy rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major
// (rows, cols) matrix g (leading dimension cols) into shared memory s with
// row stride S; what lies outside the matrix is zero-filled.  vec16: g is
// 16-byte aligned and cols, c0 and C are multiples of 4, so a group of 4
// columns is wholly inside or wholly outside.
__device__ __forceinline__ void stage_box(float* s, int S, const float* g,
                                          int rows, int cols, int r0, int R,
                                          int c0, int C, bool vec16, int tid,
                                          int nthr) {
  if (vec16) {
    const int cq = C >> 2;
    for (int e = tid; e < R * cq; e += nthr) {
      const int r = e / cq, c = (e - r * cq) << 2;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rows && gc < cols;
      cp_async16(s + r * S + c, ok ? g + (size_t)gr * cols + gc : g, ok);
    }
  } else {
    for (int e = tid; e < R * C; e += nthr) {
      const int r = e / C, c = e - r * C;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rows && gc < cols;
      cp_async4(s + r * S + c, ok ? g + (size_t)gr * cols + gc : g, ok);
    }
  }
}

// ------------------------------------------------------------ 3xTF32 MMA
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a . b over the ksteps k8 steps of a warp tile of (16 MT) x
// (8 NT).  Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4), with
// MMA column t at depth 2t and t + 4 at 2t + 1:
//   A a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B b0 (k t, n g)  b1 (k t+4, n g)
//   C c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// sA is row-major [m][k] (stride SA).  B_KN: sB is [k][n] (stride SB),
// else [n][k].  For each m16 tile the small products go first, each pass
// over the NT tiles, so no two neighbouring MMAs share an accumulator.
template <int MT, int NT, bool B_KN>
__device__ __forceinline__ void warp_mma_chunk(const float* sA, int SA,
                                               const float* sB, int SB,
                                               int ksteps, int wm0, int wn0,
                                               float (&acc)[MT][NT][4],
                                               int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = ks * 8 + t2;
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = wn0 + 8 * j + g;
      float2 b;
      if (B_KN) {
        b.x = sB[k * SB + n];
        b.y = sB[(k + 1) * SB + n];
      } else {
        b = *reinterpret_cast<const float2*>(sB + n * SB + k);
      }
      split(b.x, bh[j][0], bl[j][0]);
      split(b.y, bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* r0 = sA + (wm0 + 16 * i + g) * SA + k;
      const float2 rg = *reinterpret_cast<const float2*>(r0);   // row g
      const float2 rg8 = *reinterpret_cast<const float2*>(r0 + 8 * SA);
      uint32_t ah[4], al[4];
      split(rg.x, ah[0], al[0]);
      split(rg8.x, ah[1], al[1]);
      split(rg.y, ah[2], al[2]);
      split(rg8.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], al, bh[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah, bl[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah, bh[j]);
    }
  }
}

// Row stride of a row-major tile of kc (a multiple of 8) columns: == 8 or
// 24 (mod 32), and a multiple of 4 for the 16-byte copies.
__host__ __device__ constexpr int row_stride(int kc) {
  return kc % 16 == 8 ? kc : kc + 8;
}

// Floats of one staging buffer.
template <int BM, int BN, bool B_KN>
__host__ __device__ constexpr int stage_floats(int kc) {
  return BM * row_stride(kc) +
         (B_KN ? kc * (BN + 4) : BN * row_stride(kc));
}

// The K-chunk and the dynamic shared memory of a launch: K fits one
// buffer of up to kmax columns (rounded up to 8), else chunks of kstep in
// two buffers.
template <int BM, int BN, bool B_KN>
inline void plan_chunks(int K, int kmax, int kstep, int* kc, size_t* smem) {
  const int k8 = (K + 7) / 8 * 8;
  const bool one = k8 <= kmax;
  *kc = one ? (k8 > 0 ? k8 : 8) : kstep;
  *smem = (one ? 1 : 2) * sizeof(float) * stage_floats<BM, BN, B_KN>(*kc);
}

// The most dynamic shared memory plan_chunks can ask for.
template <int BM, int BN, bool B_KN>
constexpr size_t most_smem(int kmax, int kstep) {
  return sizeof(float) * (stage_floats<BM, BN, B_KN>(kmax) >
                                  2 * stage_floats<BM, BN, B_KN>(kstep)
                              ? stage_floats<BM, BN, B_KN>(kmax)
                              : 2 * stage_floats<BM, BN, B_KN>(kstep));
}

// The device's SM count (read once).
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above the 48 KB
// default) and prefer shared memory over L1 in the SM's 256 KB.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// One block tile: acc (warp (wm, wn) owns rows [wm*16*MT, +16*MT) and
// columns [wn*8*NT, +8*NT) of the BM x BN tile) = A[m0 : m0+BM, :] .
// B[:, n0 : n0+BN] over all of K.  A is row-major (M, K); B is row-major
// (K, N) if B_KN, else row-major (N, K).  vec: both are 16-byte aligned
// and K % 4 == 0.  smem holds one buffer, or two when K > kc.
// hook(sA, SA, sB, SB, cols) runs on every thread once a piece of K has
// landed, before its MMAs, with the pointers at its first column
// (pair_dist sums its norms there).  Ends with a __syncthreads().
//
// With tensor maps (B_KN only; tmA: boxes of BM x SA, tmB: boxes of kPart
// x SB, tmB_tail: boxes of the last part's rows x SB), K must be one
// chunk: thread 0 asks the TMA for the A tile and for the B tile in parts
// of kPart rows of K, each part on its own mbarrier, all at once, and the
// MMAs on a part start as soon as it (and, for the first, the A tile) has
// landed, while the later parts are still in flight.
constexpr int kPart = 32;
constexpr int kMaxParts = 4;         // K up to 128 in one chunk of parts

template <int BM, int BN, int MT, int NT, bool B_KN, class Hook>
__device__ __forceinline__ void product_tile(
    const float* __restrict__ A, int M, const float* __restrict__ B, int N,
    int K, int m0, int n0, int kc, bool vec, const CUtensorMap* tmA,
    const CUtensorMap* tmB, const CUtensorMap* tmB_tail, float* smem,
    float (&acc)[MT][NT][4], Hook hook) {
  constexpr int WARPS_N = BN / (8 * NT);
  constexpr int NTHR = (BM / (16 * MT)) * WARPS_N * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / WARPS_N) * 16 * MT, wn0 = (warp % WARPS_N) * 8 * NT;
  const int SA = row_stride(kc), SB = B_KN ? BN + 4 : row_stride(kc);
  const int stage = stage_floats<BM, BN, B_KN>(kc);
  const int nch = (K + kc - 1) / kc;

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the MMAs over chunk c's buffer
  auto compute = [&](int c) {
    const float* sA = smem + (c & 1) * stage;
    const float* sB = sA + BM * SA;
    hook(sA, SA, sB, SB, kc);
    warp_mma_chunk<MT, NT, B_KN>(sA, SA, sB, SB, kc / 8, wm0, wn0, acc, lane);
  };

  if (B_KN && tmA != nullptr) {
    __shared__ uint64_t bars[kMaxParts];
    const int parts = (kc + kPart - 1) / kPart;
    float* sB = smem + BM * SA;
    if (tid == 0) {
      for (int p = 0; p < parts; ++p) mbar_init(&bars[p]);
      for (int p = 0; p < parts; ++p) {
        const int rows = min(kPart, kc - p * kPart);
        mbar_arm(&bars[p], 4 * (rows * SB + (p == 0 ? BM * SA : 0)));
        if (p == 0) tma_load(smem, tmA, 0, m0, &bars[0]);
        tma_load(sB + p * kPart * SB, p + 1 < parts ? tmB : tmB_tail, n0,
                 p * kPart, &bars[p]);
      }
    }
    __syncthreads();                  // the barriers are initialised
    for (int p = 0; p < parts; ++p) {
      const int k0 = p * kPart;
      mbar_wait(&bars[p], 0);
      hook(smem + k0, SA, sB + k0 * SB, SB, min(kPart, kc - k0));
      warp_mma_chunk<MT, NT, B_KN>(smem + k0, SA, sB + k0 * SB, SB,
                                   min(kPart, kc - k0) / 8, wm0, wn0, acc,
                                   lane);
    }
    __syncthreads();
    return;
  }

  auto issue = [&](int c) {
    float* sA = smem + (c & 1) * stage;
    float* sB = sA + BM * SA;
    const int k0 = c * kc;
    stage_box(sA, SA, A, M, K, m0, BM, k0, kc, vec, tid, NTHR);
    if (B_KN)
      stage_box(sB, SB, B, K, N, k0, kc, n0, BN, vec, tid, NTHR);
    else
      stage_box(sB, SB, B, N, K, n0, BN, k0, kc, vec, tid, NTHR);
    cp_async_commit();
  };
  if (nch > 0) issue(0);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      issue(c + 1);            // in flight during this chunk's MMAs
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(c);
    __syncthreads();           // the buffer is refilled two chunks on
  }
}

struct NoHook {
  __device__ __forceinline__ void operator()(const float*, int, const float*,
                                             int, int) const {}
};

}  // namespace f32p
