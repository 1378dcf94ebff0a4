// Small-k selection: the k smallest of each row, ascending, with indices.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk.py (topk_min /
// _topk_kernel): (B, C) f32 -> values (B, k) f32 and indices (B, k) int32,
// ordered by (value, index), so equal values come lowest index first.  The
// TPU kernel holds a tile of rows in VMEM and runs k passes of masked
// argmin, writing +INF over each pick.
//
// Keys.  Each element becomes one 64-bit key, (order-preserving bits of the
// value) << 32 | index, so "smaller value, then lower index" is one integer
// compare and all keys of a row are distinct.  -0.0 is keyed as +0.0 and
// every NaN as larger than +inf, which is how a stable ascending sort orders
// them; 3.4e38 is an ordinary value.  The value written is the row's own
// element at the picked index.  Since the keys are distinct, any exact
// selection of a row's k smallest keys, sorted, is the stable sort's answer:
// the kernel may read the row in any order.
//
// What bounds it on an H100: bytes.  It must read the B x C block once (at
// B = 1024, C = 65,536 that is 268 MB, 80 us at 3.35 TB/s) and does a few
// integer operations per element.  A first design ran k passes, each the
// smallest key above the last pick: it read a row k times, from device
// memory wherever the row did not fit in shared memory (the working set of
// 1,024 rows of 256 KB is five times the 50 MB L2), and paid k dependent
// block-wide minima with three barriers each.
//
// The select path (k <= 32) reads each row once, with no block barrier
// until the row is read:
//   * one block per row of 32-128 threads (at most four elements a thread
//     below 128); 16-byte loads (ld.global.cs: read once, evict first),
//     kUnroll of them in flight a lane, from the row's first 16-byte
//     boundary; the 0-3 elements before it and after the last whole float4
//     as scalars, so a row at any 4-byte offset (C = 130 puts every odd row
//     8 bytes off) reads the same elements;
//   * each warp keeps the 32 smallest keys it has merged as a list, one key
//     a lane, ascending across the lanes; its k-th (lane k-1) is the warp's
//     threshold.  A key at or above it cannot be among the row's k smallest
//     (k merged keys are below it), so one 64-bit compare rejects it, and a
//     warp vote skips a float4 of every lane with nothing below it;
//   * keys below it are compacted (ballot, popc) into the warp's buffer of
//     kBuf keys in shared memory.  When the next float4 of every lane might
//     not fit, and at the end, the warp flushes the buffer in batches of 32
//     keys, each filtered again against the threshold, then bitonic-sorted
//     across the lanes (15 shuffle stages) and merged into the list (the
//     lane-wise min of the list and the reversed batch is bitonic and holds
//     the 32 smallest; 5 more stages sort it).  A warp's first 128 keys
//     (every key passes an empty list) are four batches sorted side by side
//     and merged in a tree: 33 dependent stages, not 84.  A batch of at
//     most kInsert keys is inserted one by one (one shuffle up).  The threshold is re-read after each.  For random
//     rows a warp merges about k (1 + ln(n / k)) of its n keys, most of
//     them in the flush after its first float4s come in;
//   * at the end the warps' lists meet in shared memory and merge in a tree
//     (log2 of the warps barriers); warp 0 writes the first k.
// A first select design kept each lane's candidates in 8 registers and
// flushed when any lane's queue filled: a warp then merged mostly empty
// batches, and the kernel was far slower than a plain read of the rows.
// The pass path (the first design, k > 32, any k <= C): pass t picks the
// smallest key strictly above pass t-1's pick (a strided scan per thread,
// then a warp-shuffle and shared-memory min), from a copy of the row's
// value keys in shared memory when it fits (C <= 10,240) and from global
// memory when it does not.  Both paths give the same bits.
//
// make_plan is mirrored in Python by repro_torch.kernels.topk.plan.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;        // the pass path
constexpr int kSelectThreads = 128;  // the select path: at most, a row
constexpr int kCap = 32;             // select path: k <= kCap, one key a lane
constexpr int kBuf = 256;            // select path: a warp's buffered keys
constexpr int kInsert = 4;           // select path: batches inserted key by key
constexpr int kUnroll = 4;           // select path: float4 loads in flight a lane
constexpr int kStageBytes = 40 * 1024;  // pass path: rows staged up to this
constexpr u64 kNone = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving 32-bit key of a float (NaN last, -0.0 == +0.0).
__device__ __forceinline__ uint32_t value_key(float v) {
  if (v != v) return 0xffffffffu;
  const uint32_t u = (v == 0.f) ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 key_of(float v, int i) {
  return ((u64)value_key(v) << 32) | (uint32_t)i;
}

__device__ __forceinline__ u64 kmin(u64 a, u64 b) { return b < a ? b : a; }
__device__ __forceinline__ u64 kmax(u64 a, u64 b) { return b < a ? a : b; }

// ---------------------------------------------------------- the select path
// Bitonic sort of 32 keys, one a lane, ascending with the lane.
__device__ __forceinline__ u64 warp_sort(u64 x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 y = __shfl_xor_sync(kFull, x, stride);
      const bool low = ((lane & stride) == 0) == ((lane & size) == 0);
      x = low ? kmin(x, y) : kmax(x, y);
    }
  }
  return x;
}

// Four independent batches at once (their stages interleave).
__device__ __forceinline__ void warp_sort4(u64 (&x)[4], int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool low = ((lane & stride) == 0) == ((lane & size) == 0);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const u64 y = __shfl_xor_sync(kFull, x[c], stride);
        x[c] = low ? kmin(x[c], y) : kmax(x[c], y);
      }
    }
  }
}

// The 32 smallest keys of two ascending warp lists, ascending.
__device__ __forceinline__ u64 warp_merge(u64 a, u64 b, int lane) {
  u64 x = kmin(a, __shfl_sync(kFull, b, 31 - lane));  // bitonic
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const u64 y = __shfl_xor_sync(kFull, x, stride);
    x = (lane & stride) ? kmax(x, y) : kmin(x, y);
  }
  return x;
}

// Insert one key below the threshold into the list.
__device__ __forceinline__ u64 warp_insert(u64 list, u64 key, int lane) {
  const u64 up = __shfl_up_sync(kFull, list, 1);
  return lane == 0 ? kmin(list, key) : (key < up ? up : kmin(list, key));
}

// Merge the warp's n buffered keys into its list, in batches of 32, each
// filtered again against the threshold: while the list has fewer than k
// keys, four full batches at once are sorted side by side and merged in a
// tree; then a batch of more than kInsert keys is sorted and merged, and a
// smaller one is inserted key by key.
__device__ __forceinline__ void flush(const u64* buf, int n, u64& list,
                                      u64& thr, int k, int lane) {
  __syncwarp();
  int b0 = 0;
  for (; n - b0 >= 128 && thr == kNone; b0 += 128) {  // the list's first keys
    u64 x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x[c] = buf[b0 + 32 * c + lane];
      if (!(x[c] < thr)) x[c] = kNone;
    }
    warp_sort4(x, lane);
    const u64 m = warp_merge(warp_merge(x[0], x[1], lane),
                             warp_merge(x[2], x[3], lane), lane);
    list = warp_merge(list, m, lane);
    thr = __shfl_sync(kFull, list, k - 1);
  }
  for (; b0 < n; b0 += 32) {
    u64 x = b0 + lane < n ? buf[b0 + lane] : kNone;
    if (!(x < thr)) x = kNone;
    unsigned m = __ballot_sync(kFull, x != kNone);
    if (__popc(m) > kInsert) {
      list = warp_merge(list, warp_sort(x, lane), lane);
      thr = __shfl_sync(kFull, list, k - 1);
      continue;
    }
    for (; m; m &= m - 1) {
      const u64 key = __shfl_sync(kFull, x, __ffs(m) - 1);
      if (key < thr) {
        list = warp_insert(list, key, lane);
        thr = __shfl_sync(kFull, list, k - 1);
      }
    }
  }
  __syncwarp();  // the buffer is refilled next
}

__global__ void __launch_bounds__(kSelectThreads)
select_kernel(const float* __restrict__ d, float* __restrict__ vals,
              int* __restrict__ idx, int C, int k) {
  extern __shared__ u64 smem[];  // lists [warps][32], then buffers [warps][kBuf]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int threads = blockDim.x, t = threadIdx.x;
  u64* lists = smem;
  u64* buf = smem + threads + warp * kBuf;
  const long long row = blockIdx.x;
  const float* x = d + row * C;
  u64 list = kNone, thr = kNone;
  int nbuf = 0;  // the same in every lane
  const unsigned below = (1u << lane) - 1u;
  auto push = [&](u64 key, bool f) {
    const unsigned m = __ballot_sync(kFull, f);
    if (f) buf[nbuf + __popc(m & below)] = key;
    nbuf += __popc(m);
  };

  // [0, lead) before the first 16-byte boundary, n4 float4s, [rest, C) after
  const uint32_t mis = (uint32_t)(uintptr_t)x & 15u;
  const int lead = min(C, (int)(((16u - mis) & 15u) >> 2));
  const int n4 = (C - lead) >> 2;
  const int rest = lead + 4 * n4;
  {
    const u64 a = t < lead ? key_of(__ldg(x + t), t) : kNone;
    const u64 b = t < C - rest ? key_of(__ldg(x + rest + t), rest + t) : kNone;
    push(a, a != kNone);
    push(b, b != kNone);
  }
  const float4* x4 = reinterpret_cast<const float4*>(x + lead);
  for (int j0 = 0; j0 < n4; j0 += kUnroll * threads) {  // same trips a block
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * threads + t;
      v[u] = j < n4 ? __ldcs(x4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * threads + t;
      const int i = lead + 4 * j;
      const bool on = j < n4;
      const u64 k0 = key_of(v[u].x, i), k1 = key_of(v[u].y, i + 1);
      const u64 k2 = key_of(v[u].z, i + 2), k3 = key_of(v[u].w, i + 3);
      const bool f0 = on && k0 < thr, f1 = on && k1 < thr;
      const bool f2 = on && k2 < thr, f3 = on && k3 < thr;
      if (__any_sync(kFull, f0 | f1 | f2 | f3)) {
        push(k0, f0);
        push(k1, f1);
        push(k2, f2);
        push(k3, f3);
        if (nbuf > kBuf - 128) {  // room for the next float4 of every lane
          flush(buf, nbuf, list, thr, k, lane);
          nbuf = 0;
        }
      }
    }
  }
  flush(buf, nbuf, list, thr, k, lane);

  // the warps' lists, merged in a tree
  lists[warp * 32 + lane] = list;
  __syncthreads();
  for (int n = threads >> 6; n > 0; n >>= 1) {
    if (warp < n) {
      list = warp_merge(list, lists[(warp + n) * 32 + lane], lane);
      lists[warp * 32 + lane] = list;
    }
    __syncthreads();
  }
  if (warp == 0 && lane < k) {
    const int j = (int)(uint32_t)(list & 0xffffffffu);
    vals[row * k + lane] = __ldg(x + j);
    idx[row * k + lane] = j;
  }
}

// ------------------------------------------------------------ the pass path
__device__ __forceinline__ u64 block_min(u64 v, u64* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = kmin(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (kThreads / 32) ? red[lane] : kNone;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = kmin(v, __shfl_xor_sync(kFull, v, o));
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
  __shared__ u64 red[kThreads / 32 + 1];
  const long long row = blockIdx.x;
  const float* x = d + row * C;
  if (kShared) {
    for (int i = threadIdx.x; i < C; i += kThreads) keys[i] = value_key(__ldg(x + i));
    __syncthreads();
  }
  u64 prev = 0;  // the last pick (unused in pass 0)
  for (int t = 0; t < k; ++t) {
    u64 best = kNone;
    for (int i = threadIdx.x; i < C; i += kThreads) {
      const uint32_t vk = kShared ? keys[i] : value_key(__ldg(x + i));
      const u64 key = ((u64)vk << 32) | (uint32_t)i;
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

// The launch plan: plan[0] path (1 select, 0 passes), plan[1] threads a
// block, plan[2] dynamic shared memory (the select path's warp lists and
// buffers, or the pass path's staged row, 0 when it does not fit), plan[3]
// blocks (one a row).  Mirrored in Python by repro_torch.kernels.topk.plan.
void make_plan(int B, int C, int k, int* plan) {
  plan[3] = B;
  if (k <= kCap) {
    int t = 32;
    while (t < kSelectThreads && t < (C + 3LL) / 4) t <<= 1;
    plan[0] = 1, plan[1] = t;
    plan[2] = (t + t / 32 * kBuf) * (int)sizeof(u64);
    return;
  }
  const long long row_bytes = (long long)C * sizeof(uint32_t);
  plan[0] = 0, plan[1] = kThreads;
  plan[2] = row_bytes <= kStageBytes ? (int)row_bytes : 0;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The plan topk_min_f32 launches for these arguments (four ints, as
// make_plan above).
extern "C" int topk_plan(int B, int C, int k, int* plan) {
  make_plan(B, C, k, plan);
  return 0;
}

// d (B, C) f32, rows at any 4-byte offset; vals (B, k) f32; idx (B, k) i32;
// 1 <= k <= C.
extern "C" int topk_min_f32(const void* d, void* vals, void* idx, int B,
                            int C, int k, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)d;
  float* v = (float*)vals;
  int* i = (int*)idx;
  int plan[4];
  make_plan(B, C, k, plan);
  if (plan[0] == 1) {
    select_kernel<<<B, plan[1], plan[2], s>>>(x, v, i, C, k);
  } else if (plan[2] > 0) {
    topk_kernel<true><<<B, kThreads, plan[2], s>>>(x, v, i, C, k);
  } else {
    topk_kernel<false><<<B, kThreads, 0, s>>>(x, v, i, C, k);
  }
  return (int)cudaGetLastError();
}
