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
// product does.  A first design (64 x 64 tiles, 4 x 4 micro-tiles) made 8
// scalar shared-memory reads for 16 FMAs, which caps the FMAs near half the
// SM's lanes, and never overlapped its global loads with compute.
//
// The SGEMM design (rows of a multiple of 16 bytes on 16-byte aligned
// bases): a Hopper SIMT SGEMM with the distance epilogue fused.
//   * 128 x 128 output tiles, 256 threads, each an 8 x 8 register
//     micro-tile: rows ty + 16 i, columns tx + 16 j, a warp 4 rows x 8
//     columns of threads.  Per 4 values of k a thread makes 16 128-bit
//     shared-memory reads for 256 FMAs (8 query float4s held, one candidate
//     float4 at a time); rows sit at a stride of 36 floats (40 bf16), so
//     the 8 candidate rows of a warp hit distinct banks.  One block a SM:
//     capped at 128 registers for two, the micro-tile spills;
//   * d in chunks of 32 through a 3-stage ring of cp.async 16-byte copies
//     with commit / wait groups (one barrier a chunk): chunks k + 1 and
//     k + 2 are in flight while chunk k computes.  The copies keep the
//     inputs' row-major layout, so bf16 is converted to fp32 on the shared
//     memory -> register read; the ragged edges of Q, C and d are
//     zero-filled by the copy;
//   * the norms in the same pass: thread t sums the squares of query row t
//     (t < 128) or of candidate row t - 128 from the staged chunk;
//   * a 1-D grid of tiles, query tiles fastest, so the blocks in flight
//     share their candidate tiles in L2 and C has no limit of its own.
// Other widths and misaligned views take the first design's tiled kernel,
// also on a 1-D grid.
//
// The arithmetic is the first design's on either path, output by output:
// one accumulator fmaf'd over k = 0 .. d-1 from 0, each row's sum of squares
// as one fmaf chain in the same order, then
// max(fadd(fsub(|q|^2, fmul(2, acc)), |c|^2), 0), each op rounded on its
// own; zero-filled k adds nothing.  So both paths give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 32;       // d chunk staged per step

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// ------------------------------------------------------------ tiled path
constexpr int kTQ = 64;       // queries per tile
constexpr int kTC = 64;       // candidates per tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
l2dist_tiled(const T* __restrict__ q, const T* __restrict__ c,
             float* __restrict__ out, int Q, int C, int d, int tiles_q) {
  // k-major tiles, padded by one so the transposing stores hit distinct banks
  __shared__ float qs[kKC][kTQ + 1];
  __shared__ float cs[kKC][kTC + 1];
  __shared__ float q_norm[kTQ];
  __shared__ float c_norm[kTC];
  const int q0 = (blockIdx.x % tiles_q) * kTQ;
  const long long c0 = (long long)(blockIdx.x / tiles_q) * kTC;
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
      const long long gc = c0 + r;
      const int gk = k0 + k;
      cs[k][r] = (gc < C && gk < d) ? load_f32(c + gc * d + gk) : 0.f;
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
      const long long gc = c0 + tx * 4 + j;
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

// ------------------------------------------------------------ SGEMM path
constexpr int kBM = 128;      // queries per tile
constexpr int kBN = 128;      // candidates per tile
constexpr int kStages = 3;

// Shared-memory row stride in elements: 16-byte aligned rows, and 8
// consecutive rows on distinct banks for a warp's 128-bit (fp32) or
// 64-bit (bf16) reads.
template <typename T>
__host__ __device__ constexpr int stride_of() {
  return sizeof(T) == 4 ? kKC + 4 : kKC + 8;
}

template <typename T>
constexpr int smem_of() {
  return kStages * 2 * kBM * stride_of<T>() * (int)sizeof(T) + 2 * kBM * 4;
}

// 4 consecutive elements of a staged row as fp32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
l2dist_sgemm(const T* __restrict__ q, const T* __restrict__ c,
             float* __restrict__ out, int Q, int C, int d, int tiles_q) {
  constexpr int S = stride_of<T>();
  constexpr int EPC = 16 / sizeof(T);      // elements a 16-byte copy
  constexpr int SEGS = kKC / EPC;          // copies a row a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);    // per stage: A 128 x S, then B
  float* q_norm = reinterpret_cast<float*>(smem + kStages * 2 * kBM * S * sizeof(T));
  float* c_norm = q_norm + kBM;
  const int q0 = (blockIdx.x % tiles_q) * kBM;
  const long long c0 = (long long)(blockIdx.x / tiles_q) * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);    // columns tx + 16 j
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // rows ty + 16 i

  auto load_chunk = [&](int st, int kc) {
    T* As = ring + st * 2 * kBM * S;
    T* Bs = As + kBM * S;
    const int k0 = kc * kKC;
    for (int i = tid; i < kBM * SEGS; i += kThreads) {
      const int r = i / SEGS, k = k0 + (i % SEGS) * EPC;
      const bool okq = q0 + r < Q && k < d;
      cp_async16(As + r * S + (i % SEGS) * EPC,
                 okq ? q + (long long)(q0 + r) * d + k : q, okq);
      const bool okc = c0 + r < C && k < d;
      cp_async16(Bs + r * S + (i % SEGS) * EPC,
                 okc ? c + (c0 + r) * d + k : c, okc);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ss = 0.f;
  const int nk = (d + kKC - 1) / kKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_chunk(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kc landed; every thread is done with kc - 1
    if (kc + kStages - 1 < nk) load_chunk((kc + kStages - 1) % kStages, kc + kStages - 1);
    cp_async_commit();
    const T* As = ring + (kc % kStages) * 2 * kBM * S;
    const T* Bs = As + kBM * S;
    {
      const T* row = tid < kBM ? As + tid * S : Bs + (tid - kBM) * S;
#pragma unroll
      for (int k = 0; k < kKC; k += 4) {
        const float4 v = load4(row + k);
        ss = fmaf(v.x, v.x, ss);
        ss = fmaf(v.y, v.y, ss);
        ss = fmaf(v.z, v.z, ss);
        ss = fmaf(v.w, v.w, ss);
      }
    }
#pragma unroll
    for (int k = 0; k < kKC; k += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = load4(As + (ty + 16 * i) * S + k);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = load4(Bs + (tx + 16 * j) * S + k);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
  }
  if (tid < kBM) {
    q_norm[tid] = ss;
  } else {
    c_norm[tid - kBM] = ss;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gq = q0 + ty + 16 * i;
    if (gq >= Q) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long gc = c0 + tx + 16 * j;
      if (gc < C) {
        const float v = __fadd_rn(
            __fsub_rn(q_norm[ty + 16 * i], __fmul_rn(2.f, acc[i][j])),
            c_norm[tx + 16 * j]);
        out[(long long)gq * C + gc] = fmaxf(v, 0.f);
      }
    }
  }
}

// The launch plan: plan[0] path (1 SGEMM, 0 tiled), plan[1] and plan[2] the
// tile's query and candidate rows, plan[3] blocks (the product of the two
// tile counts; -1 past 2^31 - 1), plan[4] dynamic shared memory.  Mirrored
// in Python by repro_torch.kernels.l2dist.plan.
void make_plan(const void* q, const void* c, int Q, int C, int d, int bf16,
               int* plan) {
  const int epc = bf16 ? 8 : 4;
  const bool sgemm = d > 0 && d % epc == 0 && (uintptr_t)q % 16 == 0 &&
                     (uintptr_t)c % 16 == 0;
  const int tm = sgemm ? kBM : kTQ, tn = sgemm ? kBN : kTC;
  const long long tiles =
      (long long)((Q + tm - 1) / tm) * ((C + tn - 1) / tn);
  plan[0] = sgemm, plan[1] = tm, plan[2] = tn;
  plan[3] = tiles > 2147483647LL ? -1 : (int)tiles;
  plan[4] = !sgemm ? 0 : bf16 ? smem_of<__nv_bfloat16>() : smem_of<float>();
}

template <typename T>
cudaError_t launch(const void* q, const void* c, void* out, int Q, int C,
                   int d, const int* plan, cudaStream_t s) {
  const int tiles_q = (Q + plan[1] - 1) / plan[1];
  if (plan[0] == 0) {
    l2dist_tiled<T><<<plan[3], kThreads, 0, s>>>(
        (const T*)q, (const T*)c, (float*)out, Q, C, d, tiles_q);
    return cudaGetLastError();
  }
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        l2dist_sgemm<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_of<T>());
    if (err != cudaSuccess) return err;
    const cudaError_t err2 = cudaFuncSetAttribute(
        l2dist_sgemm<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err2 != cudaSuccess) return err2;
    granted = true;
  }
  l2dist_sgemm<T><<<plan[3], kThreads, plan[4], s>>>(
      (const T*)q, (const T*)c, (float*)out, Q, C, d, tiles_q);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The plan l2dist launches for these arguments (five ints, as make_plan).
extern "C" int l2dist_plan(const void* q, const void* c, int Q, int C, int d,
                           int bf16, int* plan) {
  make_plan(q, c, Q, C, d, bf16, plan);
  return 0;
}

// q (Q, d), c (C, d) of one dtype: bf16 != 0 selects bfloat16, else fp32;
// out (Q, C) f32.  A 1-D grid of at most 2^31 - 1 tiles.
extern "C" int l2dist(const void* q, const void* c, void* out, int Q, int C,
                      int d, int bf16, void* stream) {
  int plan[5];
  make_plan(q, c, Q, C, d, bf16, plan);
  if (plan[3] < 0) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch<__nv_bfloat16>(q, c, out, Q, C, d, plan, s)
                    : launch<float>(q, c, out, Q, C, d, plan, s));
}
