// Tiled squared-L2 distance matrix: (Q, d) x (C, d) -> (Q, C).
//
// Replaces the Pallas TPU kernel src/repro/kernels/l2dist.py (l2dist /
// _l2dist_kernel): max(|q|^2 - 2 q.c + |c|^2, 0) per (query, candidate)
// pair, accumulated in fp32 from fp32 or bf16 inputs.
//
// What bounds it on an H100: operations.  It reads (Q + C) * d inputs and
// writes Q * C floats, but does 2 * Q * C * d flops: at Q = 1024,
// C = 8192, d = 128 that is 2.15 GFLOP against 38 MB, ~57 flops per byte,
// above the card's fp32 (non tensor core) balance of ~20.  It stays in full
// fp32 FMAs (no TF32, no library GEMM), as the TPU kernel's fp32 MXU
// product does.
//
// What the design does about it: the fp32 SIMT tiling of
// twotower_score.cu.  One block computes a 64 x 64 output tile with 256
// threads, each a 4 x 4 register micro-tile, so every element staged in
// shared memory is reused 64 times.  d is streamed in chunks of 32 through
// shared memory (coalesced 128 B row reads, bf16 converted to fp32 on
// load); the same pass accumulates each query's and each candidate's sum
// of squares, so the norms cost no second read.  The TPU kernel's split of
// d into 512-wide tiles is not reproduced: one pass covers all of d.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTQ = 64;       // queries per tile
constexpr int kTC = 64;       // candidates per tile
constexpr int kKC = 32;       // d chunk staged per step
constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
l2dist_kernel(const T* __restrict__ q, const T* __restrict__ c,
              float* __restrict__ out, int Q, int C, int d) {
  // k-major tiles, padded by one so the transposing stores hit distinct banks
  __shared__ float qs[kKC][kTQ + 1];
  __shared__ float cs[kKC][kTC + 1];
  __shared__ float q_norm[kTQ];
  __shared__ float c_norm[kTC];
  const int q0 = blockIdx.x * kTQ, c0 = blockIdx.y * kTC;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // 16 x 16 threads, 4 x 4 each
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float ss = 0.f;  // threads [0, 64): a query's sum of squares; [64, 128): a candidate's

  for (int k0 = 0; k0 < d; k0 += kKC) {
    for (int i = tid; i < kTQ * kKC; i += kThreads) {
      const int r = i / kKC, k = i % kKC;
      const int gq = q0 + r, gk = k0 + k;
      qs[k][r] = (gq < Q && gk < d) ? load_f32(q + (long long)gq * d + gk) : 0.f;
    }
    for (int i = tid; i < kTC * kKC; i += kThreads) {
      const int r = i / kKC, k = i % kKC;
      const int gc = c0 + r, gk = k0 + k;
      cs[k][r] = (gc < C && gk < d) ? load_f32(c + (long long)gc * d + gk) : 0.f;
    }
    __syncthreads();
    if (tid < kTQ) {
#pragma unroll 8
      for (int k = 0; k < kKC; ++k) ss = fmaf(qs[k][tid], qs[k][tid], ss);
    } else if (tid < kTQ + kTC) {
#pragma unroll 8
      for (int k = 0; k < kKC; ++k)
        ss = fmaf(cs[k][tid - kTQ], cs[k][tid - kTQ], ss);
    }
#pragma unroll 4
    for (int k = 0; k < kKC; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[k][ty * 4 + i];
        b[i] = cs[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < kTQ) {
    q_norm[tid] = ss;
  } else if (tid < kTQ + kTC) {
    c_norm[tid - kTQ] = ss;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + ty * 4 + i;
    if (gq >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = c0 + tx * 4 + j;
      if (gc < C) {
        // (|q|^2 - 2 q.c) + |c|^2, in the plain version's order
        const float v = __fadd_rn(
            __fsub_rn(q_norm[ty * 4 + i], __fmul_rn(2.f, acc[i][j])),
            c_norm[tx * 4 + j]);
        out[(long long)gq * C + gc] = fmaxf(v, 0.f);
      }
    }
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q (Q, d), c (C, d) of one dtype: bf16 != 0 selects bfloat16, else fp32;
// out (Q, C) f32.  The grid's y extent is C / 64 blocks (at most 65,535).
extern "C" int l2dist(const void* q, const void* c, void* out, int Q, int C,
                      int d, int bf16, void* stream) {
  const dim3 grid((Q + kTQ - 1) / kTQ, (C + kTC - 1) / kTC);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    l2dist_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)c, (float*)out, Q, C, d);
  } else {
    l2dist_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)q, (const float*)c, (float*)out, Q, C, d);
  }
  return (int)cudaGetLastError();
}
