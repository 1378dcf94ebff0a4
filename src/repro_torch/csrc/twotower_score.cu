// Fused normalize + cosine score: GATE entry selection over the hub set.
//
// Replaces the Pallas TPU kernel src/repro/kernels/twotower_score.py
// (twotower_score / _twotower_kernel): (B, d) query latents x (H, d) hub
// latents -> (B, H) cosine similarities, both row normalizations fused, with
// the squared norm clamped at 1e-18 as the TPU kernel does.
//
// What bounds it on an H100: at the main path's shapes (H <= 128 hubs,
// d = 128) it reads ~B * d * 4 bytes and does 2 * B * H * d flops, about
// 2 * H / 4 = 32 flops per byte at H = 64: close to the fp32 (non tensor
// core) balance point of the card, so bytes and fp32 FMAs bound it about
// equally.  It stays in full fp32 (no TF32, no library GEMM), as the TPU
// kernel's fp32 MXU product does.
//
// What the design does about it: one block computes a 64 x 64 output tile
// with 256 threads, each a 4 x 4 register micro-tile, so every query and
// hub element staged in shared memory is reused 64 times.  d is streamed in
// chunks of 32 through shared memory (coalesced 128 B row reads); the same
// pass accumulates each row's sum of squares, so the normalized copies
// never exist in device memory.  The output is scaled by
// rsqrt(max(sum x^2, 1e-18)) of its query row and hub row at the end.
#include <cuda_runtime.h>

namespace {

constexpr int kTB = 64;       // queries per tile
constexpr int kTH = 64;       // hubs per tile
constexpr int kKC = 32;       // d chunk staged per step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
twotower_kernel(const float* __restrict__ q, const float* __restrict__ h,
                float* __restrict__ out, int B, int H, int d) {
  // k-major tiles, padded by one so the transposing stores hit distinct banks
  __shared__ float qs[kKC][kTB + 1];
  __shared__ float hs[kKC][kTH + 1];
  __shared__ float q_scale[kTB];
  __shared__ float h_scale[kTH];
  const int b0 = blockIdx.x * kTB, h0 = blockIdx.y * kTH;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // 16 x 16 threads, 4 x 4 each
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float ss = 0.f;  // threads [0, 64): a query row's sum of squares; [64, 128): a hub row's

  for (int k0 = 0; k0 < d; k0 += kKC) {
    for (int i = tid; i < kTB * kKC; i += kThreads) {
      const int r = i / kKC, c = i % kKC;
      const int gb = b0 + r, gk = k0 + c;
      qs[c][r] = (gb < B && gk < d) ? q[(long long)gb * d + gk] : 0.f;
    }
    for (int i = tid; i < kTH * kKC; i += kThreads) {
      const int r = i / kKC, c = i % kKC;
      const int gh = h0 + r, gk = k0 + c;
      hs[c][r] = (gh < H && gk < d) ? h[(long long)gh * d + gk] : 0.f;
    }
    __syncthreads();
    if (tid < kTB) {
#pragma unroll 8
      for (int c = 0; c < kKC; ++c) ss += qs[c][tid] * qs[c][tid];
    } else if (tid < kTB + kTH) {
#pragma unroll 8
      for (int c = 0; c < kKC; ++c) ss += hs[c][tid - kTB] * hs[c][tid - kTB];
    }
#pragma unroll 4
    for (int c = 0; c < kKC; ++c) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[c][ty * 4 + i];
        bb[i] = hs[c][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
  // rsqrt(max(sum x^2, 1e-18)) with IEEE sqrt and division
  if (tid < kTB) {
    q_scale[tid] = 1.f / sqrtf(fmaxf(ss, 1e-18f));
  } else if (tid < kTB + kTH) {
    h_scale[tid - kTB] = 1.f / sqrtf(fmaxf(ss, 1e-18f));
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gb = b0 + ty * 4 + i;
    if (gb >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gh = h0 + tx * 4 + j;
      if (gh < H)
        out[(long long)gb * H + gh] =
            acc[i][j] * q_scale[ty * 4 + i] * h_scale[tx * 4 + j];
    }
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q (B, d) f32; h (H, d) f32; out (B, H) f32.
extern "C" int twotower_score_f32(const void* q, const void* h, void* out,
                                  int B, int H, int d, void* stream) {
  const dim3 grid((B + kTB - 1) / kTB, (H + kTH - 1) / kTH);
  twotower_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)h, (float*)out, B, H, d);
  return (int)cudaGetLastError();
}
