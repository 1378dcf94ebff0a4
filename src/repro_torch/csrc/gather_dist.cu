// Batched in-kernel gather + distance: the beam-search hop kernels.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/gather_dist.py:
//   gather_rows_dist     (_rows_l2_kernel, _rows_cos_kernel)       -> K1
//   gather_rows_dist_q8  (_rows_q8_l2_kernel, _rows_q8_cos_kernel) -> K2
// The TPU kernels take one query's R ids as scalar prefetch and DMA one row
// per grid step.  Here one launch serves the whole batch: ids (B, R).
//
// What bounds them on an H100: device-memory bytes.  Each valid slot reads
// one database row (4d bytes fp32, or Dp + 8*nb bytes from the int8
// codebook) at a random address, and does ~3 flops per byte: far under the
// card's ~20 fp32 flops per byte of bandwidth.
//
// What the design does about it:
//   * one block per query stages q in shared memory once, so the only
//     device-memory traffic per slot is the row itself (+ inv norm);
//   * one warp per (b, r) slot: lane i reads 16 B (float4, fp32) or 4 B
//     (char4, int8) at stride 32, so a d = 128 fp32 row is one coalesced
//     512 B request and a 128-code block one 128 B request;
//   * an invalid slot (id < 0) writes 3.4e38 and loads nothing, so the
//     frozen and padded slots of a lockstep batch cost no row traffic;
//   * the warp reduces with shuffles; no shared-memory reduction, no atomics.
// The formula is repro's, element by element: sum((v - q)^2) for L2 (not the
// dot form), and 1 - sum((v * inv[v]) * q_hat) for cosine, every product and
// sum rounded on its own (no FMA contraction) as the plain PyTorch version
// rounds them, so the two differ only in the order of the d-term sum.  An
// id >= N writes NaN instead of reading out of bounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr float kInf = 3.4e38f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One term of the sum, rounded as the plain version rounds it.
template <bool kCos>
__device__ __forceinline__ float term(float v, float w, float iv) {
  if (kCos) return __fmul_rn(__fmul_rn(v, iv), w);
  const float a = __fsub_rn(v, w);
  return __fmul_rn(a, a);
}

// Stage one query row (n floats) into shared memory.
__device__ __forceinline__ void stage_query(float* qs, const float* q, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) qs[i] = q[i];
  __syncthreads();
}

template <bool kCos, bool kVec4>
__global__ void __launch_bounds__(kWarps * 32)
rows_f32_kernel(const int* __restrict__ ids, const float* __restrict__ db,
                const float* __restrict__ q, const float* __restrict__ inv,
                float* __restrict__ out, int R, long long N, int d) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  stage_query(qs, q + (long long)b * d, d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kWarps) {
    const long long slot = (long long)b * R + r;
    const int id = ids[slot];
    if (id < 0 || id >= N) {
      if (lane == 0) out[slot] = id < 0 ? kInf : __int_as_float(0x7fc00000);
      continue;
    }
    const float* row = db + (long long)id * d;
    const float iv = kCos ? __ldg(inv + id) : 0.f;
    float acc = 0.f;
    if (kVec4) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const float4* q4 = reinterpret_cast<const float4*>(qs);
      for (int i = lane; i < (d >> 2); i += 32) {
        const float4 v = __ldg(row4 + i);
        const float4 w = q4[i];
        acc = __fadd_rn(acc, term<kCos>(v.x, w.x, iv));
        acc = __fadd_rn(acc, term<kCos>(v.y, w.y, iv));
        acc = __fadd_rn(acc, term<kCos>(v.z, w.z, iv));
        acc = __fadd_rn(acc, term<kCos>(v.w, w.w, iv));
      }
    } else {  // any d, odd included: scalar loads, lane i takes i, i+32, ...
      for (int i = lane; i < d; i += 32)
        acc = __fadd_rn(acc, term<kCos>(__ldg(row + i), qs[i], iv));
    }
    acc = warp_sum(acc);
    if (lane == 0) out[slot] = kCos ? __fsub_rn(1.f, acc) : acc;
  }
}

template <bool kCos>
__global__ void __launch_bounds__(kWarps * 32)
rows_q8_kernel(const int* __restrict__ ids, const int8_t* __restrict__ codes,
               const float* __restrict__ scale, const float* __restrict__ zero,
               const float* __restrict__ q, const float* __restrict__ inv,
               float* __restrict__ out, int R, long long N, int dp, int nb,
               int blk) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  stage_query(qs, q + (long long)b * dp, dp);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  for (int r = warp; r < R; r += kWarps) {
    const long long slot = (long long)b * R + r;
    const int id = ids[slot];
    if (id < 0 || id >= N) {
      if (lane == 0) out[slot] = id < 0 ? kInf : __int_as_float(0x7fc00000);
      continue;
    }
    const char4* row4 = reinterpret_cast<const char4*>(codes + (long long)id * dp);
    const float* sc = scale + (long long)id * nb;
    const float* zr = zero + (long long)id * nb;
    const float iv = kCos ? __ldg(inv + id) : 0.f;
    float acc = 0.f;
    // 32 lanes x 4 codes = one 128-code block per step; blk % 4 == 0, so
    // a lane's 4 codes share one (scale, zero) pair
    for (int i = lane; i < (dp >> 2); i += 32) {
      const int blkid = (i << 2) / blk;
      const float s = __ldg(sc + blkid), z = __ldg(zr + blkid);
      const char4 c = __ldg(row4 + i);
      const float4 w = q4[i];
      // c * scale + zero as two rounded ops, as the plain version does
      const float v0 = __fadd_rn(__fmul_rn((float)c.x, s), z);
      const float v1 = __fadd_rn(__fmul_rn((float)c.y, s), z);
      const float v2 = __fadd_rn(__fmul_rn((float)c.z, s), z);
      const float v3 = __fadd_rn(__fmul_rn((float)c.w, s), z);
      acc = __fadd_rn(acc, term<kCos>(v0, w.x, iv));
      acc = __fadd_rn(acc, term<kCos>(v1, w.y, iv));
      acc = __fadd_rn(acc, term<kCos>(v2, w.z, iv));
      acc = __fadd_rn(acc, term<kCos>(v3, w.w, iv));
    }
    acc = warp_sum(acc);
    if (lane == 0) out[slot] = kCos ? __fsub_rn(1.f, acc) : acc;
  }
}

// Dynamic shared memory above 48 KB (d > 12288) must be opted into.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ids (B, R) i32; db (N, d) f32; q (B, d) f32 (pre-normalized under
// cosine); inv (N,) f32 or NULL (NULL selects L2); out (B, R) f32.
extern "C" int gather_rows_dist_f32(const void* ids, const void* db,
                                    const void* q, const void* inv, void* out,
                                    int B, int R, long long N, int d,
                                    void* stream) {
  const size_t smem = (size_t)d * sizeof(float);
  const bool vec4 = (d % 4 == 0) && ((uintptr_t)db % 16 == 0);
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(B), block(kWarps * 32);
  const int* i = (const int*)ids;
  const float* x = (const float*)db;
  const float* qq = (const float*)q;
  const float* iv = (const float*)inv;
  float* o = (float*)out;
  cudaError_t e;
  if (inv == nullptr && vec4) {
    if ((e = allow_smem(rows_f32_kernel<false, true>, smem))) return e;
    rows_f32_kernel<false, true><<<grid, block, smem, s>>>(i, x, qq, iv, o, R, N, d);
  } else if (inv == nullptr) {
    if ((e = allow_smem(rows_f32_kernel<false, false>, smem))) return e;
    rows_f32_kernel<false, false><<<grid, block, smem, s>>>(i, x, qq, iv, o, R, N, d);
  } else if (vec4) {
    if ((e = allow_smem(rows_f32_kernel<true, true>, smem))) return e;
    rows_f32_kernel<true, true><<<grid, block, smem, s>>>(i, x, qq, iv, o, R, N, d);
  } else {
    if ((e = allow_smem(rows_f32_kernel<true, false>, smem))) return e;
    rows_f32_kernel<true, false><<<grid, block, smem, s>>>(i, x, qq, iv, o, R, N, d);
  }
  return (int)cudaGetLastError();
}

// ids (B, R) i32; codes (N, dp) i8 (dp = nb * blk, blk % 4 == 0); scale and
// zero (N, nb) f32; q (B, dp) f32 zero-padded; inv (N,) f32 or NULL (NULL
// selects L2); out (B, R) f32.
extern "C" int gather_rows_dist_q8(const void* ids, const void* codes,
                                   const void* scale, const void* zero,
                                   const void* q, const void* inv, void* out,
                                   int B, int R, long long N, int dp, int nb,
                                   void* stream) {
  const size_t smem = (size_t)dp * sizeof(float);
  const int blk = dp / nb;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(B), block(kWarps * 32);
  const int* i = (const int*)ids;
  const int8_t* c = (const int8_t*)codes;
  const float* sc = (const float*)scale;
  const float* zr = (const float*)zero;
  const float* qq = (const float*)q;
  const float* iv = (const float*)inv;
  float* o = (float*)out;
  cudaError_t e;
  if (inv == nullptr) {
    if ((e = allow_smem(rows_q8_kernel<false>, smem))) return e;
    rows_q8_kernel<false><<<grid, block, smem, s>>>(i, c, sc, zr, qq, iv, o, R, N, dp, nb, blk);
  } else {
    if ((e = allow_smem(rows_q8_kernel<true>, smem))) return e;
    rows_q8_kernel<true><<<grid, block, smem, s>>>(i, c, sc, zr, qq, iv, o, R, N, dp, nb, blk);
  }
  return (int)cudaGetLastError();
}
