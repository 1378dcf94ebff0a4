// Small-k selection: the k smallest of each row, ascending, with indices.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk.py (topk_min /
// _topk_kernel): (B, C) f32 -> values (B, k) f32 and indices (B, k) int32,
// ordered by (value, index), so equal values come lowest index first.  The
// TPU kernel holds a tile of rows in VMEM and runs k passes of masked
// argmin, writing +INF over each pick.
//
// What bounds it on an H100: bytes.  It must read the B x C row block once
// and does about one compare per element and pass; at B = 256, C = 1024,
// k = 32 the bound is the 1 MB read (~0.3 us), far under what k dependent
// block-wide reductions take, so in practice it is bound by the latency of
// those k reductions.
//
// What the design does about it: one block per row, and no copy of the row
// is ever written.  Each element becomes one 64-bit key, (order-preserving
// bits of the value) << 32 | index, so "smaller value, then lower index" is
// one integer compare and all keys of a row are distinct.  Pass t finds the
// smallest key strictly above pass t-1's pick (a strided scan per thread,
// then a warp-shuffle and shared-memory min): no masking, so the row can be
// read from shared memory when it fits there (staged once as 32-bit value
// keys) and straight from global memory, through L1/L2, when it does not --
// any C works.  -0.0 is keyed as +0.0 and every NaN as larger than +inf,
// which is how a stable ascending sort orders them; 3.4e38 is an ordinary
// value.  The value written is the row's own element at the picked index.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kNone = ~0ull;

// Order-preserving 32-bit key of a float (NaN last, -0.0 == +0.0).
__device__ __forceinline__ uint32_t value_key(float v) {
  if (v != v) return 0xffffffffu;
  const uint32_t u = (v == 0.f) ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long block_min(unsigned long long v,
                                                        unsigned long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (kThreads / 32) ? red[lane] : kNone;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
      v = w < v ? w : v;
    }
    if (lane == 0) red[kThreads / 32] = v;
  }
  __syncthreads();
  v = red[kThreads / 32];
  __syncthreads();  // red is reused by the next pass
  return v;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ d, float* __restrict__ vals,
            int* __restrict__ idx, int C, int k) {
  extern __shared__ uint32_t keys[];   // the row's value keys (kShared only)
  __shared__ unsigned long long red[kThreads / 32 + 1];
  const long long row = blockIdx.x;
  const float* x = d + row * C;
  if (kShared) {
    for (int i = threadIdx.x; i < C; i += kThreads) keys[i] = value_key(__ldg(x + i));
    __syncthreads();
  }
  unsigned long long prev = 0;  // the last pick (unused in pass 0)
  for (int t = 0; t < k; ++t) {
    unsigned long long best = kNone;
    for (int i = threadIdx.x; i < C; i += kThreads) {
      const uint32_t vk = kShared ? keys[i] : value_key(__ldg(x + i));
      const unsigned long long key = ((unsigned long long)vk << 32) | (uint32_t)i;
      if ((t == 0 || key > prev) && key < best) best = key;
    }
    best = block_min(best, red);
    prev = best;
    if (threadIdx.x == 0) {
      const int j = (int)(uint32_t)(best & 0xffffffffu);
      vals[row * k + t] = x[j];
      idx[row * k + t] = j;
    }
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// d (B, C) f32; vals (B, k) f32; idx (B, k) i32; 1 <= k <= C.  Rows of up
// to 10,240 values (40 KB of keys, under the 48 KB a block gets without
// opting in) are staged in shared memory.
extern "C" int topk_min_f32(const void* d, void* vals, void* idx, int B,
                            int C, int k, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)C * sizeof(uint32_t);
  if (smem <= 40 * 1024) {
    topk_kernel<true><<<B, kThreads, smem, s>>>(
        (const float*)d, (float*)vals, (int*)idx, C, k);
  } else {
    topk_kernel<false><<<B, kThreads, 0, s>>>(
        (const float*)d, (float*)vals, (int*)idx, C, k);
  }
  return (int)cudaGetLastError();
}
