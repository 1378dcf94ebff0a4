// Batched in-kernel gather + distance: the beam-search hop kernels.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/gather_dist.py:
//   gather_rows_dist     (_rows_l2_kernel, _rows_cos_kernel)       -> K1
//   gather_rows_dist_q8  (_rows_q8_l2_kernel, _rows_q8_cos_kernel) -> K2
//   gather_dist          (_gather_dist_kernel, the legacy one)     -> K6
// The TPU kernels take one query's R ids as scalar prefetch and DMA one row
// per grid step.  Here one launch serves the whole batch: ids (B, R).
//
// The shape the search launches K1 and K2 at: R is the index's padded
// degree (247 on a repaired 1M NSG), and most slots are -1: a row holds its
// node's neighbours that the dedup left (~15), and a frozen query's row is
// -1 throughout.  What bounds them on an H100 is device-memory bytes (the
// ids read and the outputs written, 4 B a slot each, plus each valid row:
// 4d bytes fp32, or Dp + 8*nb from the int8 codebook) at ~3 flops per row
// byte, far under the card's ~20 fp32 flops per byte of bandwidth.  What
// kept a first design (one warp per slot, an id load, a branch and a row
// load in one dependent chain, 31 times per warp at R = 247) far from that
// bound was latency, not bytes.  This design pays a few long latencies per
// query instead:
//   * front (both kernels): one block per query; thread t reads id t in one
//     coalesced pass (looping only if R > 256), writes 3.4e38 (id < 0) or
//     NaN (id >= N) for its slot if invalid, and the valid (slot, id) pairs
//     are compacted into shared memory in slot order (a ballot and popc per
//     warp, a scan over the 8 warp counts).  A block with no valid id is
//     done: a frozen query costs one read of its ids and one write of its
//     outputs, and no read of q or of any row;
//   * rows by Hopper's bulk async copy: warp 0 issues one
//     cp.async.bulk.shared::cluster.global per valid row (one per lane) into
//     a ring of S row slots, two stages of S/2 rows, each completing on its
//     own mbarrier armed with expect_tx for the stage's bytes; q rides on
//     the first stage.  Stage k+2 is issued once every warp has consumed
//     stage k (phase parity per barrier).  S is sized from the row width so
//     q plus the ring stays near 16 KB and 8 blocks of 256 threads fit on an
//     SM (S = 32 at d = 128; K2's kernel is bounded to 5, see there);
//   * the per-row scalars too small for the bulk copy's 16-byte granule
//     (the cosine inv norm, K2's first-block scale and zero) are loaded for
//     all of a chunk's valid rows at once, one thread each, while the first
//     copies are in flight: one latency, not one per stage;
//   * compute from shared memory, one row per warp at a time: lane i takes
//     float4 (K1) or char4 (K2) i at stride 32, then the xor-shuffle tree;
//   * widths the bulk copy cannot take (a row not a multiple of 16 bytes,
//     a base not 16-byte aligned, or a ring that does not fit beside q)
//     keep the same front and load rows through registers, 4 rows of a
//     warp in flight before any is reduced.
// The formula is repro's, element by element: sum((v - q)^2) for L2 (not the
// dot form), and 1 - sum((v * inv[v]) * q_hat) for cosine, every product and
// sum rounded on its own (no FMA contraction) as the plain PyTorch version
// rounds them.  The d-term sum takes the order of PyTorch's CUDA reduction
// of a contiguous row of at least 128 floats (the plain version's torch.sum):
// lane i keeps four running sums, one per component of float4 (char4 for
// K2) i, i+32, ..., combines them as ((x + y) + z) + w, and the lanes meet
// in the xor tree (offsets 16 down to 1, as its shfl_down tree does at lane
// 0).  So the bulk paths and K2's register path give the plain version's
// bits at every width d % 4 == 0, d >= 128 (the paper's 128, 200, 384, 512,
// 960); at d = 128 a lane has one float4 and this is the first design's
// single chain.  K1's register path (a row not a multiple of 16 bytes or a
// base not 16-byte aligned) sums element i at stride 32 and differs from
// the plain version only in the order of the sum.
//
// K6 takes rows the caller has already gathered, (B, R, d) contiguous, and
// computes the TPU kernel's dot form max(|v|^2 - 2 v.q + |q|^2, 0); an
// id < 0 writes exactly 3.4e38 and reads nothing of its row, and any id >= 0
// is a valid row (only the sign is read: no NaN rule).  It is bound by the
// bytes of the block (4d per valid slot, read once, in order).  A first
// design walked each warp's slots in series (load the id, branch, load the
// row, reduce, store: one row in flight a warp, two dependent round trips
// a slot) and summed |q|^2 again for every slot.  This one pays two round
// trips a query: one block per query, each warp reads its kRegRows slots'
// ids (in flight while q is staged in shared memory), then issues every
// valid row's loads (float4 a lane on 16-byte aligned rows, scalars
// otherwise) before it reduces any, so at R <= 32 all of a block's rows are
// in flight at once; |q|^2 is summed once a warp.  That takes ~58 registers
// (4 blocks of 256 a SM, two waves at B = 1024): capping it at 32 for one
// wave spilled and was slower.  The rows sit at fixed
// places, so no gather, compaction or bulk copy is needed (a design that
// compacted the valid slots and bulk-copied each 512-byte row, as K1 does,
// was slower than the first design at (1024, 32, 128)).  Each sum keeps the
// first design's arithmetic: lane i takes float4 i at stride 32 (element i
// when d % 4 != 0) in one nested fmaf chain for each of v.v, v.q and q.q,
// then the xor tree, so every path gives the first design's bits (a
// misaligned view with d % 4 == 0, which the first design summed element by
// element, now takes the float4 order of the aligned rows).
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kInf = 3.4e38f;
// shared-memory head of K1/K2: 2 mbarriers, 8 warp counts, 256 (slot, id)
// pairs, 3 x 256 per-row scalars (scale, zero, inv); q and the ring follow,
// 16-byte aligned
constexpr int kHead = 16 + 4 * kWarps + 8 * kThreads + 12 * kThreads;
constexpr int kRingBytes = 16 * 1024;  // ring target: rows of one block
constexpr int kMaxRing = 32;           // row slots: two stages of 16
constexpr int kRegRows = 4;            // register path: rows in flight per warp
constexpr size_t kMaxSmem = 232448;    // 227 KB a block may opt into

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A lane's four running sums, one per float4 component, in the order
// PyTorch's vectorized CUDA reduction combines its four accumulators.
__device__ __forceinline__ float lane_sum(float4 a) {
  return __fadd_rn(__fadd_rn(__fadd_rn(a.x, a.y), a.z), a.w);
}

// One term of the sum, rounded as the plain version rounds it.
template <bool kCos>
__device__ __forceinline__ float term(float v, float w, float iv) {
  if (kCos) return __fmul_rn(__fmul_rn(v, iv), w);
  const float a = __fsub_rn(v, w);
  return __fmul_rn(a, a);
}

// c * scale + zero as two rounded ops, as the plain version dequantizes.
__device__ __forceinline__ float dq(signed char c, float s, float z) {
  return __fadd_rn(__fmul_rn((float)c, s), z);
}

// Stage one query row (n floats) into shared memory.
__device__ __forceinline__ void stage_query(float* qs, const float* q, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) qs[i] = q[i];
  __syncthreads();
}

// ------------------------------------------------------------- the front
// Threads read ids[r0 + t] in one coalesced pass, write 3.4e38 (id < 0) or
// NaN (id >= N) for the invalid slots, and compact the valid (slot, id)
// pairs into `pairs` in slot order.  Returns the number of valid pairs;
// ends on a block barrier, so every thread sees them.
__device__ __forceinline__ int front(const int* __restrict__ ids,
                                     float* __restrict__ out, int r0, int R,
                                     long long N, int2* pairs, int* wcount) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = r0 + threadIdx.x;
  bool ok = false;
  int id = -1;
  if (r < R) {
    id = __ldg(ids + r);
    ok = id >= 0 && id < N;
    if (!ok) out[r] = id < 0 ? kInf : __int_as_float(0x7fc00000);
  }
  const unsigned m = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) wcount[warp] = __popc(m);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = wcount[w];
    base += w < warp ? c : 0;
    total += c;
  }
  if (ok) pairs[base + __popc(m & ((1u << lane) - 1u))] = make_int2(r, id);
  __syncthreads();
  return total;
}

struct Head {
  uint64_t* bar;  // [2]
  int* wcount;    // [kWarps]
  int2* pairs;    // [kThreads]
  float* scale;   // [kThreads] per valid row: K2's first-block scale,
  float* zero;    // [kThreads]   zero,
  float* inv;     // [kThreads]   and the cosine inv norm
  char* tail;     // q, then the ring
};

__device__ __forceinline__ Head head() {
  extern __shared__ float4 smem4[];
  char* s = reinterpret_cast<char*>(smem4);
  float* scal = reinterpret_cast<float*>(s + 16 + 4 * kWarps + 8 * kThreads);
  return {reinterpret_cast<uint64_t*>(s), reinterpret_cast<int*>(s + 16),
          reinterpret_cast<int2*>(s + 16 + 4 * kWarps), scal,
          scal + kThreads, scal + 2 * kThreads, s + kHead};
}

// The bulk pipeline both kernels share, over one chunk's n valid rows.
// Stage k holds rows [k*T, min(n, (k+1)*T)) in ring half (g + k) & 1 and
// completes on bar[(g + k) & 1] at parity ((g + k) >> 1) & 1, g counting
// the stages of earlier chunks.  `q_bytes` of q ride on the chunk's first
// stage when nonzero.  Once the first two stages are in flight, every
// thread runs prologue(): the plain loads of per-row scalars too small for
// the bulk copy's 16-byte granule, one thread per valid row, all in flight
// at once (it ends on a block barrier if it stores anything).  Then every
// warp calls consume(j0, m, buf) for each stage's rows [j0, j0 + m), in
// `buf`, once they have landed.
template <typename Prologue, typename Consume>
__device__ __forceinline__ void bulk_rows(const Head& h, const char* rows,
                                          uint32_t row_bytes, int n, int T,
                                          char* ring, uint32_t& g, void* qs,
                                          const void* q, uint32_t q_bytes,
                                          Prologue prologue, Consume consume) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ns = (n + T - 1) / T;
  auto issue = [&](int k) {
    const uint32_t gk = g + k;
    const int j0 = k * T, m = min(T, n - j0);
    uint64_t* bar = &h.bar[gk & 1];
    char* buf = ring + (size_t)(gk & 1) * T * row_bytes;
    const uint32_t extra = k == 0 ? q_bytes : 0u;
    if (lane == 0) {
      mbar_expect_tx(bar, m * row_bytes + extra);
      if (extra) bulk_load(qs, q, extra, bar);
    }
    __syncwarp();
    for (int j = lane; j < m; j += 32)
      bulk_load(buf + (size_t)j * row_bytes,
                rows + (long long)h.pairs[j0 + j].y * row_bytes, row_bytes, bar);
  };
  if (warp == 0) {
    issue(0);
    if (ns > 1) issue(1);
  }
  prologue();
  for (int k = 0; k < ns; ++k) {
    const uint32_t gk = g + k;
    const int j0 = k * T;
    mbar_wait(&h.bar[gk & 1], (gk >> 1) & 1u);
    consume(j0, min(T, n - j0), ring + (size_t)(gk & 1) * T * row_bytes);
    __syncthreads();  // every warp is done with this ring half
    if (warp == 0 && k + 2 < ns) {
      fence_proxy_async();
      issue(k + 2);
    }
  }
  g += ns;
}

// ---------------------------------------------------------------- K1
template <bool kCos>
__global__ void __launch_bounds__(kThreads, 8)
rows_f32_bulk(const int* __restrict__ ids, const float* __restrict__ db,
              const float* __restrict__ q, const float* __restrict__ inv,
              float* __restrict__ out, int R, long long N, int d, int T) {
  const Head h = head();
  float* qs = reinterpret_cast<float*>(h.tail);
  char* ring = h.tail + 4 * d;
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ids += (long long)b * R;
  out += (long long)b * R;
  if (threadIdx.x == 0) {
    mbar_init(&h.bar[0]);
    mbar_init(&h.bar[1]);
    mbar_init_fence();
  }  // the front's barriers publish the init
  uint32_t g = 0;
  uint32_t q_bytes = 4u * d;  // q is copied once, with the first stage
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  for (int r0 = 0; r0 < R; r0 += kThreads) {
    const int n = front(ids, out, r0, R, N, h.pairs, h.wcount);
    if (n == 0) continue;
    const int2* pairs = h.pairs;
    bulk_rows(h, reinterpret_cast<const char*>(db), 4u * d, n, T, ring, g, qs,
              q + (long long)b * d, q_bytes,
              [&] {  // each valid row's inv norm, under cosine
      if (!kCos) return;
      if (threadIdx.x < n) h.inv[threadIdx.x] = __ldg(inv + pairs[threadIdx.x].y);
      __syncthreads();
    }, [&](int j0, int m, const char* buf) {
      for (int j = warp; j < m; j += kWarps) {
        const float iv = kCos ? h.inv[j0 + j] : 0.f;
        const float4* v4 = reinterpret_cast<const float4*>(buf) + (size_t)j * (d >> 2);
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i = lane; i < (d >> 2); i += 32) {
          const float4 v = v4[i];
          const float4 w = q4[i];
          a.x = __fadd_rn(a.x, term<kCos>(v.x, w.x, iv));
          a.y = __fadd_rn(a.y, term<kCos>(v.y, w.y, iv));
          a.z = __fadd_rn(a.z, term<kCos>(v.z, w.z, iv));
          a.w = __fadd_rn(a.w, term<kCos>(v.w, w.w, iv));
        }
        const float acc = warp_sum(lane_sum(a));
        if (lane == 0) out[pairs[j0 + j].x] = kCos ? __fsub_rn(1.f, acc) : acc;
      }
    });
    q_bytes = 0;
  }
}

// Any width or alignment: the same front, rows through registers (scalar
// loads, lane i takes i, i+32, ...), kRegRows rows of a warp in flight.
template <bool kCos>
__global__ void __launch_bounds__(kThreads)
rows_f32_regs(const int* __restrict__ ids, const float* __restrict__ db,
              const float* __restrict__ q, const float* __restrict__ inv,
              float* __restrict__ out, int R, long long N, int d) {
  const Head h = head();
  float* qs = reinterpret_cast<float*>(h.tail);
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ids += (long long)b * R;
  out += (long long)b * R;
  bool q_pending = true;
  for (int r0 = 0; r0 < R; r0 += kThreads) {
    const int n = front(ids, out, r0, R, N, h.pairs, h.wcount);
    if (n == 0) continue;
    if (q_pending) {
      stage_query(qs, q + (long long)b * d, d);
      q_pending = false;
    }
    for (int j0 = warp * kRegRows; j0 < n; j0 += kWarps * kRegRows) {
      const float* row[kRegRows];
      float iv[kRegRows], acc[kRegRows];
#pragma unroll
      for (int u = 0; u < kRegRows; ++u) {
        const bool on = j0 + u < n;
        const int id = on ? h.pairs[j0 + u].y : 0;
        row[u] = on ? db + (long long)id * d : nullptr;
        iv[u] = kCos && on ? __ldg(inv + id) : 0.f;
        acc[u] = 0.f;
      }
      for (int i = lane; i < d; i += 32) {
        float v[kRegRows];
#pragma unroll
        for (int u = 0; u < kRegRows; ++u) v[u] = row[u] ? __ldg(row[u] + i) : 0.f;
        const float w = qs[i];
#pragma unroll
        for (int u = 0; u < kRegRows; ++u)
          acc[u] = __fadd_rn(acc[u], term<kCos>(v[u], w, iv[u]));
      }
#pragma unroll
      for (int u = 0; u < kRegRows; ++u) {
        const float a = warp_sum(acc[u]);
        if (lane == 0 && row[u])
          out[h.pairs[j0 + u].x] = kCos ? __fsub_rn(1.f, a) : a;
      }
    }
  }
}

// ---------------------------------------------------------------- K2
// 32 lanes x 4 codes = one 128-code block per step; blk % 4 == 0, so a
// lane's 4 codes share one (scale, zero) pair.  Bounded to 5 blocks an SM
// (48 registers, no spill): with the four running sums, 8 blocks (32
// registers) spilled 172 bytes a thread (ptxas -v) and ran slower than
// the single-chain design on the search's calls.
template <bool kCos>
__global__ void __launch_bounds__(kThreads, 5)
rows_q8_bulk(const int* __restrict__ ids, const int8_t* __restrict__ codes,
             const float* __restrict__ scale, const float* __restrict__ zero,
             const float* __restrict__ q, const float* __restrict__ inv,
             float* __restrict__ out, int R, long long N, int dp, int nb,
             int blk, int T) {
  const Head h = head();
  float* qs = reinterpret_cast<float*>(h.tail);
  char* ring = h.tail + 4 * dp;
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ids += (long long)b * R;
  out += (long long)b * R;
  if (threadIdx.x == 0) {
    mbar_init(&h.bar[0]);
    mbar_init(&h.bar[1]);
    mbar_init_fence();
  }
  uint32_t g = 0;
  uint32_t q_bytes = 4u * dp;
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  for (int r0 = 0; r0 < R; r0 += kThreads) {
    const int n = front(ids, out, r0, R, N, h.pairs, h.wcount);
    if (n == 0) continue;
    const int2* pairs = h.pairs;
    bulk_rows(h, reinterpret_cast<const char*>(codes), (uint32_t)dp, n, T, ring,
              g, qs, q + (long long)b * dp, q_bytes,
              [&] {  // each valid row's first-block scale and zero (and inv)
      if (threadIdx.x < n) {
        const long long id = pairs[threadIdx.x].y;
        h.scale[threadIdx.x] = __ldg(scale + id * nb);
        h.zero[threadIdx.x] = __ldg(zero + id * nb);
        if (kCos) h.inv[threadIdx.x] = __ldg(inv + id);
      }
      __syncthreads();
    }, [&](int j0, int m, const char* buf) {
      for (int j = warp; j < m; j += kWarps) {
        const float sr = h.scale[j0 + j], zr = h.zero[j0 + j];
        const float iv = kCos ? h.inv[j0 + j] : 0.f;
        const long long id = pairs[j0 + j].y;
        const char4* c4 = reinterpret_cast<const char4*>(buf) + (size_t)j * (dp >> 2);
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i = lane; i < (dp >> 2); i += 32) {
          const int blkid = (i << 2) / blk;
          const float s = blkid == 0 ? sr : __ldg(scale + id * nb + blkid);
          const float z = blkid == 0 ? zr : __ldg(zero + id * nb + blkid);
          const char4 cc = c4[i];
          const float4 w = q4[i];
          a.x = __fadd_rn(a.x, term<kCos>(dq(cc.x, s, z), w.x, iv));
          a.y = __fadd_rn(a.y, term<kCos>(dq(cc.y, s, z), w.y, iv));
          a.z = __fadd_rn(a.z, term<kCos>(dq(cc.z, s, z), w.z, iv));
          a.w = __fadd_rn(a.w, term<kCos>(dq(cc.w, s, z), w.w, iv));
        }
        const float acc = warp_sum(lane_sum(a));
        if (lane == 0) out[pairs[j0 + j].x] = kCos ? __fsub_rn(1.f, acc) : acc;
      }
    });
    q_bytes = 0;
  }
}

// Any Dp the wrapper takes (blk % 4 == 0, codes 4-byte aligned): the same
// front, char4 code loads through registers, kRegRows rows in flight.
template <bool kCos>
__global__ void __launch_bounds__(kThreads)
rows_q8_regs(const int* __restrict__ ids, const int8_t* __restrict__ codes,
             const float* __restrict__ scale, const float* __restrict__ zero,
             const float* __restrict__ q, const float* __restrict__ inv,
             float* __restrict__ out, int R, long long N, int dp, int nb,
             int blk) {
  const Head h = head();
  float* qs = reinterpret_cast<float*>(h.tail);
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ids += (long long)b * R;
  out += (long long)b * R;
  bool q_pending = true;
  for (int r0 = 0; r0 < R; r0 += kThreads) {
    const int n = front(ids, out, r0, R, N, h.pairs, h.wcount);
    if (n == 0) continue;
    if (q_pending) {
      stage_query(qs, q + (long long)b * dp, dp);
      q_pending = false;
    }
    for (int j0 = warp * kRegRows; j0 < n; j0 += kWarps * kRegRows) {
      long long id[kRegRows];
      bool on[kRegRows];
      float iv[kRegRows];
      float4 acc[kRegRows];
#pragma unroll
      for (int u = 0; u < kRegRows; ++u) {
        on[u] = j0 + u < n;
        id[u] = on[u] ? h.pairs[j0 + u].y : 0;
        iv[u] = kCos && on[u] ? __ldg(inv + id[u]) : 0.f;
        acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int i = lane; i < (dp >> 2); i += 32) {
        const int blkid = (i << 2) / blk;
        char4 c[kRegRows];
        float s[kRegRows], z[kRegRows];
#pragma unroll
        for (int u = 0; u < kRegRows; ++u) {
          c[u] = on[u] ? __ldg(reinterpret_cast<const char4*>(codes + id[u] * dp) + i)
                       : make_char4(0, 0, 0, 0);
          s[u] = on[u] ? __ldg(scale + id[u] * nb + blkid) : 0.f;
          z[u] = on[u] ? __ldg(zero + id[u] * nb + blkid) : 0.f;
        }
        const float4 w = q4[i];
#pragma unroll
        for (int u = 0; u < kRegRows; ++u) {
          acc[u].x = __fadd_rn(acc[u].x, term<kCos>(dq(c[u].x, s[u], z[u]), w.x, iv[u]));
          acc[u].y = __fadd_rn(acc[u].y, term<kCos>(dq(c[u].y, s[u], z[u]), w.y, iv[u]));
          acc[u].z = __fadd_rn(acc[u].z, term<kCos>(dq(c[u].z, s[u], z[u]), w.z, iv[u]));
          acc[u].w = __fadd_rn(acc[u].w, term<kCos>(dq(c[u].w, s[u], z[u]), w.w, iv[u]));
        }
      }
#pragma unroll
      for (int u = 0; u < kRegRows; ++u) {
        const float a = warp_sum(lane_sum(acc[u]));
        if (lane == 0 && on[u])
          out[h.pairs[j0 + u].x] = kCos ? __fsub_rn(1.f, a) : a;
      }
    }
  }
}

// ---------------------------------------------------------------- K6
// One row's |v|^2 and v.q terms of float4 i, in the first design's chains.
__device__ __forceinline__ void dot4(float4 v, float4 w, float& vn, float& vq) {
  vn = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, vn))));
  vq = fmaf(v.x, w.x, fmaf(v.y, w.y, fmaf(v.z, w.z, fmaf(v.w, w.w, vq))));
}

// |q|^2 of the staged query, as every slot of the first design summed it.
template <bool kVec4>
__device__ __forceinline__ float q_norm(const float* qs, int d, int lane) {
  float qn = 0.f;
  if (kVec4) {
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int i = lane; i < (d >> 2); i += 32) {
      const float4 w = q4[i];
      qn = fmaf(w.x, w.x, fmaf(w.y, w.y, fmaf(w.z, w.z, fmaf(w.w, w.w, qn))));
    }
  } else {
    for (int i = lane; i < d; i += 32) qn = fmaf(qs[i], qs[i], qn);
  }
  return warp_sum(qn);
}

__device__ __forceinline__ float dot_l2(float vn, float vq, float qn) {
  return fmaxf(vn - 2.f * vq + qn, 0.f);
}

// One block per query, kRegRows slots a warp at a time.  kVec4: d % 4 == 0,
// summed in float4 groups; kLoad4: the rows are 16-byte aligned and loaded
// as float4, else element by element.
template <bool kVec4, bool kLoad4>
__global__ void __launch_bounds__(kThreads)
gathered_l2(const float* __restrict__ vecs, const float* __restrict__ q,
            const int* __restrict__ ids, float* __restrict__ out, int R,
            int d) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ids += (long long)b * R;
  out += (long long)b * R;
  const float* rows = vecs + (long long)b * R * d;
  // the warp's first slots' ids are in flight while q is staged
  const int r0 = warp * kRegRows;
  int id[kRegRows];
#pragma unroll
  for (int u = 0; u < kRegRows; ++u) id[u] = r0 + u < R ? __ldg(ids + r0 + u) : -1;
  stage_query(qs, q + (long long)b * d, d);
  const float qn = q_norm<kVec4>(qs, d, lane);
  for (int r = r0; r < R; r += kWarps * kRegRows) {
    if (r != r0) {
#pragma unroll
      for (int u = 0; u < kRegRows; ++u) id[u] = r + u < R ? __ldg(ids + r + u) : -1;
    }
    float vn[kRegRows], vq[kRegRows];
#pragma unroll
    for (int u = 0; u < kRegRows; ++u) vn[u] = vq[u] = 0.f;
    if (kVec4) {
      const float4* q4 = reinterpret_cast<const float4*>(qs);
      for (int i = lane; i < (d >> 2); i += 32) {
        const float* p = rows + (long long)r * d + 4 * i;
        float4 v[kRegRows];  // every valid row's float4 in flight first
#pragma unroll
        for (int u = 0; u < kRegRows; ++u, p += d) {
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (id[u] < 0) continue;
          v[u] = kLoad4 ? __ldg(reinterpret_cast<const float4*>(p))
                        : make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
        }
        const float4 w = q4[i];
#pragma unroll
        for (int u = 0; u < kRegRows; ++u) dot4(v[u], w, vn[u], vq[u]);
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        float v[kRegRows];
#pragma unroll
        for (int u = 0; u < kRegRows; ++u)
          v[u] = id[u] < 0 ? 0.f : __ldg(rows + (long long)(r + u) * d + i);
        const float w = qs[i];
#pragma unroll
        for (int u = 0; u < kRegRows; ++u) {
          vn[u] = fmaf(v[u], v[u], vn[u]);
          vq[u] = fmaf(v[u], w, vq[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRegRows; ++u) {
      if (r + u >= R) break;
      if (id[u] < 0) {
        if (lane == 0) out[r + u] = kInf;
        continue;
      }
      const float a = warp_sum(vn[u]), c = warp_sum(vq[u]);
      if (lane == 0) out[r + u] = dot_l2(a, c, qn);
    }
  }
}

// Dynamic shared memory above 48 KB (d > 12288) must be opted into.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Ring rows for a row of `row_bytes`: ~kRingBytes, even, 2..kMaxRing.
int ring_rows(size_t row_bytes) {
  size_t s = kRingBytes / row_bytes;
  s = s < 2 ? 2 : (s > kMaxRing ? kMaxRing : s);
  return (int)(s & ~(size_t)1);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The bulk path's ring rows for rows of `row_bytes` (4 d for K1, the padded
// code width for K2), as the launches below size it.
extern "C" int gather_dist_ring_rows(long long row_bytes) {
  return ring_rows((size_t)row_bytes);
}

// ids (B, R) i32; db (N, d) f32; q (B, d) f32 (pre-normalized under
// cosine); inv (N,) f32 or NULL (NULL selects L2); out (B, R) f32.
extern "C" int gather_rows_dist_f32(const void* ids, const void* db,
                                    const void* q, const void* inv, void* out,
                                    int B, int R, long long N, int d,
                                    void* stream) {
  const int S = ring_rows(4 * (size_t)d);
  const size_t bulk_smem = kHead + 4 * (size_t)d * (1 + S);
  const bool bulk = d % 4 == 0 && (uintptr_t)db % 16 == 0 &&
                    (uintptr_t)q % 16 == 0 && bulk_smem <= kMaxSmem;
  const size_t smem = bulk ? bulk_smem : kHead + 4 * (size_t)d;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(B), block(kThreads);
  const int* i = (const int*)ids;
  const float* x = (const float*)db;
  const float* qq = (const float*)q;
  const float* iv = (const float*)inv;
  float* o = (float*)out;
  cudaError_t e;
  if (bulk && inv == nullptr) {
    if ((e = allow_smem(rows_f32_bulk<false>, smem))) return e;
    rows_f32_bulk<false><<<grid, block, smem, s>>>(i, x, qq, iv, o, R, N, d, S / 2);
  } else if (bulk) {
    if ((e = allow_smem(rows_f32_bulk<true>, smem))) return e;
    rows_f32_bulk<true><<<grid, block, smem, s>>>(i, x, qq, iv, o, R, N, d, S / 2);
  } else if (inv == nullptr) {
    if ((e = allow_smem(rows_f32_regs<false>, smem))) return e;
    rows_f32_regs<false><<<grid, block, smem, s>>>(i, x, qq, iv, o, R, N, d);
  } else {
    if ((e = allow_smem(rows_f32_regs<true>, smem))) return e;
    rows_f32_regs<true><<<grid, block, smem, s>>>(i, x, qq, iv, o, R, N, d);
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
  const int S = ring_rows((size_t)dp);
  const size_t bulk_smem = kHead + 4 * (size_t)dp + (size_t)S * dp;
  const bool bulk = dp % 16 == 0 && (uintptr_t)codes % 16 == 0 &&
                    (uintptr_t)q % 16 == 0 && bulk_smem <= kMaxSmem;
  const size_t smem = bulk ? bulk_smem : kHead + 4 * (size_t)dp;
  const int blk = dp / nb;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(B), block(kThreads);
  const int* i = (const int*)ids;
  const int8_t* c = (const int8_t*)codes;
  const float* sc = (const float*)scale;
  const float* zr = (const float*)zero;
  const float* qq = (const float*)q;
  const float* iv = (const float*)inv;
  float* o = (float*)out;
  cudaError_t e;
  if (bulk && inv == nullptr) {
    if ((e = allow_smem(rows_q8_bulk<false>, smem))) return e;
    rows_q8_bulk<false><<<grid, block, smem, s>>>(i, c, sc, zr, qq, iv, o, R, N, dp, nb, blk, S / 2);
  } else if (bulk) {
    if ((e = allow_smem(rows_q8_bulk<true>, smem))) return e;
    rows_q8_bulk<true><<<grid, block, smem, s>>>(i, c, sc, zr, qq, iv, o, R, N, dp, nb, blk, S / 2);
  } else if (inv == nullptr) {
    if ((e = allow_smem(rows_q8_regs<false>, smem))) return e;
    rows_q8_regs<false><<<grid, block, smem, s>>>(i, c, sc, zr, qq, iv, o, R, N, dp, nb, blk);
  } else {
    if ((e = allow_smem(rows_q8_regs<true>, smem))) return e;
    rows_q8_regs<true><<<grid, block, smem, s>>>(i, c, sc, zr, qq, iv, o, R, N, dp, nb, blk);
  }
  return (int)cudaGetLastError();
}

// vecs (B, R, d) f32 rows already gathered; q (B, d) f32; ids (B, R) i32
// (only their sign is read); out (B, R) f32.
extern "C" int gather_dist_f32(const void* vecs, const void* q,
                               const void* ids, void* out, int B, int R, int d,
                               void* stream) {
  const size_t smem = (size_t)d * sizeof(float);
  const bool vec4 = d % 4 == 0;
  const bool load4 = vec4 && (uintptr_t)vecs % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(B), block(kThreads);
  const float* v = (const float*)vecs;
  const float* qq = (const float*)q;
  const int* i = (const int*)ids;
  float* o = (float*)out;
  cudaError_t e;
  if (load4) {
    if ((e = allow_smem(gathered_l2<true, true>, smem))) return e;
    gathered_l2<true, true><<<grid, block, smem, s>>>(v, qq, i, o, R, d);
  } else if (vec4) {
    if ((e = allow_smem(gathered_l2<true, false>, smem))) return e;
    gathered_l2<true, false><<<grid, block, smem, s>>>(v, qq, i, o, R, d);
  } else {
    if ((e = allow_smem(gathered_l2<false, false>, smem))) return e;
    gathered_l2<false, false><<<grid, block, smem, s>>>(v, qq, i, o, R, d);
  }
  return (int)cudaGetLastError();
}
