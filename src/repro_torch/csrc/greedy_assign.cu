// Sequential greedy balanced assignment (paper Algorithm 2, greedy mode).
//
// A port-only kernel: repro runs this pass as a lax.scan over rows
// (src/repro/core/hbkm.py::_assign_greedy), with no Pallas kernel.  Given
// d2 (n, k) f32, the squared distances of each row to the k <= 32 centres,
// rows are assigned one after another; row i picks
//     argmin_j  d2[i, j] + lam * ((2 * count_j - 2 * target) + 1)
// (ties to the lowest j, as jnp.argmin) against the counts of the rows
// before it, then adds one to count_j.  Each rounding is the reference's:
// the penalty is computed term by term with __fmul_rn / __fadd_rn /
// __fsub_rn, so the compiler cannot contract it into an FMA, and the counts
// are floats incremented by 1.0 (exact up to 2^24 rows).
//
// What bounds it: the chain of rows.  Row i + 1's penalty needs row i's
// pick, so the pass is a dependent sequence of n warp-wide argmins; the
// d2 read (n * k * 4 bytes) is a small fraction of that time.  Design: one
// block of one warp.  Lane j keeps count_j in a register and reads column
// j of each row; each row is one float -> order-preserving uint32 key, a
// warp min (redux.sync) and a ballot of the lanes holding it, whose lowest
// set bit is the pick.  Rows are read kUnroll at a time one chunk ahead,
// so the loads of the next chunk are in flight while this one is walked.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 16;

// Order-preserving key of a float: a < b  <=>  key(a) < key(b).  -0.0 keys
// as +0.0 (they compare equal, so the lower lane wins, as in argmin) and
// NaN as the smallest key (argmin returns the first NaN).
__device__ __forceinline__ unsigned key_of(float v) {
  if (v != v) return 0u;
  if (v == 0.f) v = 0.f;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(32, 1)
greedy_assign_kernel(const float* __restrict__ d2, int n, int k, float lam,
                     float two_t, int* __restrict__ assign) {
  const int lane = threadIdx.x;
  const bool live = lane < k;
  const unsigned kmask = k == 32 ? 0xffffffffu : ((1u << k) - 1u);
  float count = 0.f;
  float cur[kUnroll], nxt[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    cur[u] = (live && u < n) ? __ldcs(d2 + (size_t)u * k + lane) : 0.f;
  for (int base = 0; base < n; base += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + kUnroll + u;
      nxt[u] = (live && r < n) ? __ldcs(d2 + (size_t)r * k + lane) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u;
      if (r >= n) break;  // uniform across the warp
      const float pen = __fmul_rn(
          lam, __fadd_rn(__fsub_rn(__fmul_rn(2.f, count), two_t), 1.f));
      const unsigned key = live ? key_of(__fadd_rn(cur[u], pen)) : 0xffffffffu;
      const unsigned m = __reduce_min_sync(0xffffffffu, key);
      const unsigned hit = __ballot_sync(0xffffffffu, key == m) & kmask;
      const int j = __ffs(hit) - 1;
      if (lane == j) count = __fadd_rn(count, 1.f);
      if (lane == 0) assign[r] = j;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// d2: (n, k) row-major f32 on the device, 1 <= k <= 32; assign: (n,) int32.
// two_t is 2 * target rounded to f32, as the reference computes it.
extern "C" int greedy_assign_f32(const float* d2, int n, int k, float lam,
                                 float two_t, int* assign, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > 32) return (int)cudaErrorInvalidValue;
  greedy_assign_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(d2, n, k, lam,
                                                           two_t, assign);
  return (int)cudaGetLastError();
}
