// Fused normalize + cosine score: GATE entry selection over the hub set.
//
// Replaces the Pallas TPU kernel src/repro/kernels/twotower_score.py
// (twotower_score / _twotower_kernel): (B, d) query latents x (H, d) hub
// latents -> (B, H) cosine similarities, both row normalizations fused, with
// the squared norm clamped at 1e-18 as the TPU kernel does.
//
// The shapes the main path launches: (B, H, d) = (10,000, 64, 128) once per
// search and (1024, 64, 128) once per serve request; GateIndex only scores
// the flat hub set when H <= flat_score_max = 128.  There the work is small
// (2 B H d flops: 164 MFLOP, 2.4 us at the card's 67 TFLOP/s fp32 outside
// the tensor cores; 5.4 MB read), and on an H100 the kernel is bound by
// latency: every output is one chain of d dependent FMAs (the order is
// fixed, see below), every block first needs the whole hub matrix, and the
// call is short enough that its launch and first global reads count.  A
// first design (64 x 64 output tiles, d in chunks of 32 through shared
// memory by scalar transposing loads, two barriers a chunk) ran 157 blocks
// at B = 10,000 and 16 at B = 1024, with no load in flight while its FMAs
// ran.
//
// The resident design (H <= 128, d <= 128, both multiples of 4, 16-byte
// aligned rows):
//   * the hub matrix lands in shared memory once per cluster of 4 CTAs:
//     each CTA issues a quarter of the rows as multicast bulk copies
//     (cp.async.bulk ... multicast::cluster) that land in all four, and
//     each CTA's mbarrier counts all H rows.  Every block needs every hub,
//     and 128-316 blocks asking the same 32 KB of L2 at once was the
//     slowest part of a block's life;
//   * persistent blocks walk the query tiles with stride gridDim.x; each
//     tile of TB rows lands by one bulk copy a row in a two-stage ring on
//     two mbarriers, so tile t + 2 is in flight while tile t + 1 computes.
//     The plan halves TB from 64 while there are fewer than 2 tiles a SM,
//     down to 16 (TB = 32 at B = 10,000: 313 tiles; TB = 16 at B = 1024);
//   * a warp covers 4 hub groups (16 hubs) for 8 query rows, 4 (8 at
//     H > 64) warps side by side cover the hub set; a thread owns 4
//     adjacent hubs of RI rows: per 4 values of k it makes RI + 4 128-bit
//     shared-memory reads for 16 RI FMAs.  Hub rows sit in shared memory in
//     the order (hub % 4, hub / 4) and all rows at a stride of 4 (mod 8)
//     floats, so a warp's 4 hub rows and 8 query rows fall on distinct
//     banks;
//   * the row norms are not recomputed by every warp that reads a row: the
//     first warp of each side-by-side group sums a query row's squares and
//     publishes its scale, and thread t sums the squares of the hub in
//     shared-memory slot t beside its first tile's products;
//   * the output rows go out as float4 stores, 4 adjacent hubs a lane.
// Any other shape (more hubs, wider rows up to the TPU kernel's d <= 512 and
// past it, widths not a multiple of 4, misaligned views) takes the tiled
// kernel of the first design.
//
// The arithmetic is the first design's on either path, output by output:
// one accumulator fmaf'd over k = 0 .. d-1 from 0, each row's sum of squares
// as one chain in the same order, and acc * q_scale * h_scale with
// 1 / sqrtf(max(sum x^2, 1e-18)); so both paths give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;

// ------------------------------------------------------------ tiled path
constexpr int kTB = 64;       // queries per tile
constexpr int kTH = 64;       // hubs per tile
constexpr int kKC = 32;       // d chunk staged per step

__global__ void __launch_bounds__(kThreads)
twotower_tiled(const float* __restrict__ q, const float* __restrict__ h,
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

// --------------------------------------------------------- resident path
constexpr int kMaxH = 128;            // hubs the resident path holds
constexpr int kMaxD = 128;            // widths it takes
constexpr int kBlocksPerSm = 2;
constexpr int kHead = 32 + 4 * kMaxH + 2 * 4 * 64;  // 3 mbarriers, hub and
                                                   // query-row scales
constexpr int kCluster = 4;           // CTAs that share one load of the hubs
constexpr int kSmemPerSm = 233472;    // 228 KB of shared memory an SM has
constexpr int kSmemPerBlock = 232448; // 227 KB a block may opt into

// Row stride in shared memory: 4 (mod 8) floats, so rows r .. r + 7 start
// on 8 distinct 16-byte bank groups.
__host__ __device__ __forceinline__ int row_stride(int d) {
  return d % 8 == 0 ? d + 4 : d;
}

// Copy query tile t (its rows that exist) into one ring stage, a bulk copy
// a row into rows at the padded stride P; warp 0.
__device__ __forceinline__ void issue_tile(float* stage, uint64_t* bar,
                                           const float* __restrict__ q, int t,
                                           int tb, int B, int d, int P) {
  const int lane = threadIdx.x & 31;
  const int rows = min(tb, B - t * tb);
  if (lane == 0) mbar_expect_tx(bar, (uint32_t)rows * d * 4);
  __syncwarp();
  for (int r = lane; r < rows; r += 32)
    bulk_load(stage + r * P, q + ((long long)t * tb + r) * d, d * 4, bar);
}

// RI: query rows a thread owns in one tile (TB / rows per pass, at least 1).
template <int RI>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, kBlocksPerSm)
twotower_resident(const float* __restrict__ q, const float* __restrict__ h,
                  float* __restrict__ out, int B, int H, int d, int tb,
                  int gp_log) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // stage 0, 1; hubs
  const int gp = 1 << gp_log;  // hub groups of 4, rounded to a power of 2
  const int P = row_stride(d);
  float* h_scale = reinterpret_cast<float*>(smem + 32);  // kMaxH
  float* q_scale = h_scale + kMaxH;                       // two stages of 64
  float* hub = reinterpret_cast<float*>(smem + kHead);  // 4 gp slots of P floats
  float* ring = hub + 4 * gp * P;          // two stages of tb rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (B + tb - 1) / tb;

  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    mbar_init(&bars[2]);
    mbar_init_fence();
  }
  cluster_sync();  // every CTA's barriers are initialized before any copy
  if (warp == 0) {
    // the hubs, once per cluster: CTA `rank` copies rows rank, rank + 4, ...
    // to the same place in all four CTAs, and each CTA's barrier counts
    // all H rows
    if (lane == 0) mbar_expect_tx(&bars[2], (uint32_t)H * d * 4);
    __syncwarp();
    for (int c = (int)cluster_ctarank() + kCluster * lane; c < H;
         c += kCluster * 32)
      bulk_load_multicast(hub + ((c & 3) * gp + (c >> 2)) * P,
                          h + (long long)c * d, d * 4, &bars[2],
                          (1u << kCluster) - 1);
    for (int s = 0; s < 2; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < ntiles) issue_tile(ring + s * tb * P, &bars[s], q, t, tb, B, d, P);
    }
  }
  mbar_wait(&bars[2], 0);
  // thread t sums the squares of the hub in slot t (hub 4 (t % gp) + t / gp)
  // beside its first tile's products: consecutive slots, distinct banks
  const int hub_c = 4 * (tid & (gp - 1)) + tid / gp;
  const bool hub_norm = tid < 4 * gp && hub_c < H;
  const float* hrow = hub + tid * P;
  float hs = 0.f;

  // a warp covers gw hub groups of 32 / gw query rows, and hsplit warps
  // side by side cover the hub set; lane: hub group g (hubs 4g .. 4g + 3)
  // of query rows r0 + i * rpp
  const int gw_log = min(gp_log, 2), gw = 1 << gw_log;
  const int hsplit = gp >> gw_log;
  const int g = (warp % hsplit) * gw + (lane & (gw - 1));
  const int rpp = (blockDim.x >> 5) / hsplit * (32 >> gw_log);  // rows per pass
  const int r0 = warp / hsplit * (32 >> gw_log) + (lane >> gw_log);
  const bool hubs_ok = 4 * g < H;
  const bool row_norms = warp % hsplit == 0;  // the warps that sum q's squares
  int hoff[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) hoff[j] = (j * gp + g) * P;

  for (int it = 0;; ++it) {
    const int t = blockIdx.x + it * gridDim.x;
    if (t >= ntiles) break;
    const int s = it & 1;
    float* stage = ring + s * tb * P;
    mbar_wait(&bars[s], (it >> 1) & 1);
    float acc[RI][4], ss[RI];
    int qoff[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      ss[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      qoff[i] = min(r0 + i * rpp, tb - 1) * P;  // rows past the tile: never stored
    }
#pragma unroll 4
    for (int k = 0; k < d; k += 4) {
      float4 hv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hv[j] = *reinterpret_cast<const float4*>(hub + hoff[j] + k);
      if (it == 0 && hub_norm) {
        const float4 v = *reinterpret_cast<const float4*>(hrow + k);
        hs += v.x * v.x;
        hs += v.y * v.y;
        hs += v.z * v.z;
        hs += v.w * v.w;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(stage + qoff[i] + k);
        if (row_norms) {
          ss[i] += qv.x * qv.x;
          ss[i] += qv.y * qv.y;
          ss[i] += qv.z * qv.z;
          ss[i] += qv.w * qv.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(qv.x, hv[j].x, acc[i][j]);
          acc[i][j] = fmaf(qv.y, hv[j].y, acc[i][j]);
          acc[i][j] = fmaf(qv.z, hv[j].z, acc[i][j]);
          acc[i][j] = fmaf(qv.w, hv[j].w, acc[i][j]);
        }
      }
    }
    if (it == 0 && hub_norm) h_scale[hub_c] = 1.f / sqrtf(fmaxf(hs, 1e-18f));
    if (row_norms) {
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = r0 + i * rpp;
        if (r < tb) q_scale[s * 64 + r] = 1.f / sqrtf(fmaxf(ss[i], 1e-18f));
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (warp == 0) {
      const int tn = t + 2 * gridDim.x;
      if (tn < ntiles) {
        fence_proxy_async();
        issue_tile(stage, &bars[s], q, tn, tb, B, d, P);
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = r0 + i * rpp;
      const long long b = (long long)t * tb + r;
      if (r < tb && b < B && hubs_ok) {
        const float qs = q_scale[s * 64 + r];
        const float4 hsc = *reinterpret_cast<const float4*>(h_scale + 4 * g);
        float4 o;
        o.x = acc[i][0] * qs * hsc.x;
        o.y = acc[i][1] * qs * hsc.y;
        o.z = acc[i][2] * qs * hsc.z;
        o.w = acc[i][3] * qs * hsc.w;
        *reinterpret_cast<float4*>(out + b * H + 4 * g) = o;
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer's copies may still target it
}

// The launch plan: plan[0] path (1 resident, 0 tiled), plan[1] query rows a
// tile (TB), plan[2] blocks, plan[3] dynamic shared memory, plan[4] log2 of
// the hub groups, plan[5] query rows a thread (RI), plan[6] threads a
// block.  Mirrored in Python by
// repro_torch.kernels.twotower_score.plan.
void make_plan(const void* q, const void* h, int B, int H, int d, int n_sm,
               int* plan) {
  const bool resident = H > 0 && H <= kMaxH && H % 4 == 0 && d > 0 &&
                        d <= kMaxD && d % 4 == 0 &&
                        (uintptr_t)q % 16 == 0 && (uintptr_t)h % 16 == 0;
  if (!resident) {
    plan[0] = 0, plan[1] = kTB, plan[3] = 0, plan[4] = 0, plan[5] = 0;
    plan[6] = kThreads;
    plan[2] = ((B + kTB - 1) / kTB) * ((H + kTH - 1) / kTH);
    return;
  }
  int tb = 64;
  while (tb > 16 && (B + tb - 1) / tb < 2 * n_sm) tb /= 2;
  int gp_log = 0;
  while ((1 << gp_log) < H / 4) ++gp_log;
  const int gw_log = gp_log < 2 ? gp_log : 2;
  const int hsplit = 1 << (gp_log - gw_log);
  const int threads = 32 * hsplit > 128 ? 32 * hsplit : 128;
  const int rpp = threads / 32 / hsplit * (32 >> gw_log);
  const int smem = kHead + (4 * (1 << gp_log) + 2 * tb) * row_stride(d) * 4;
  // blocks a SM: shared memory, 128 registers a thread, at most 8
  int per_sm = kSmemPerSm / (smem + 1024);
  if (per_sm > 65536 / (threads * 128)) per_sm = 65536 / (threads * 128);
  if (per_sm > 8) per_sm = 8;
  const int ntiles = (B + tb - 1) / tb;
  plan[0] = 1, plan[1] = tb, plan[3] = smem, plan[4] = gp_log;
  // whole clusters: a CTA without a tile still loads its share of the hubs
  const int blocks = ntiles < per_sm * n_sm ? ntiles : per_sm * n_sm;
  plan[2] = (blocks + kCluster - 1) / kCluster * kCluster;
  plan[5] = tb / rpp > 1 ? tb / rpp : 1;
  plan[6] = threads;
}

int sm_count(int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

template <int RI>
cudaError_t launch_resident(const float* q, const float* h, float* out, int B,
                            int H, int d, const int* plan, cudaStream_t s) {
  static int granted = 0;  // dynamic shared memory this instance may take
  if (plan[3] > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        twotower_resident<RI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemPerBlock);
    if (err != cudaSuccess) return err;
    const cudaError_t err2 = cudaFuncSetAttribute(
        twotower_resident<RI>, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err2 != cudaSuccess) return err2;
    granted = kSmemPerBlock;
  }
  twotower_resident<RI><<<plan[2], plan[6], plan[3], s>>>(
      q, h, out, B, H, d, plan[1], plan[4]);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The plan twotower_score_f32 launches for these arguments (seven ints, as
// make_plan above); returns the CUDA error of reading the SM count.
extern "C" int twotower_score_plan(const void* q, const void* h, int B, int H,
                                   int d, int* plan) {
  int n_sm = 0;
  const int err = sm_count(&n_sm);
  if (err == 0) make_plan(q, h, B, H, d, n_sm, plan);
  return err;
}

// q (B, d) f32; h (H, d) f32; out (B, H) f32.
extern "C" int twotower_score_f32(const void* q, const void* h, void* out,
                                  int B, int H, int d, void* stream) {
  int n_sm = 0, plan[7];
  const int err = sm_count(&n_sm);
  if (err != 0) return err;
  make_plan(q, h, B, H, d, n_sm, plan);
  const cudaStream_t s = (cudaStream_t)stream;
  const float *qf = (const float*)q, *hf = (const float*)h;
  float* of = (float*)out;
  if (plan[0] == 0) {
    const dim3 grid((B + kTB - 1) / kTB, (H + kTH - 1) / kTH);
    twotower_tiled<<<grid, kThreads, 0, s>>>(qf, hf, of, B, H, d);
    return (int)cudaGetLastError();
  }
  switch (plan[5]) {
    case 1: return (int)launch_resident<1>(qf, hf, of, B, H, d, plan, s);
    case 2: return (int)launch_resident<2>(qf, hf, of, B, H, d, plan, s);
    case 4: return (int)launch_resident<4>(qf, hf, of, B, H, d, plan, s);
    default: return (int)launch_resident<8>(qf, hf, of, B, H, d, plan, s);
  }
}
