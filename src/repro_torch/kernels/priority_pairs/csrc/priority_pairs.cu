// <Node_un, P_mean> pair reduction (paper Eq. 1) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/priority_pairs/kernel.py
// (`priority_pairs_call` -> `_pairs_kernel`): for every (job j, block b)
// row of the per-vertex priority array [J, B_N, Vb],
//
//   node_un[j,b] = #{v: p[j,b,v] > 0}
//   p_mean[j,b]  = sum_{v: p > 0} p[j,b,v] / max(node_un[j,b], 1)
//
// Layout.  The Pallas grid (J, B_N) reduces one [Vb] stripe per step.
// Here one warp owns one row: its lanes stride the Vb values, keep a
// count and a masked sum each, and reduce both by warp shuffles; lane 0
// writes.  Eight rows per 256-thread block.
//
// Bound.  It reads each priority once and writes two floats per row:
// about 0.5 operation per byte, so device-memory bytes bound it; at the
// slice's [4, 1024, 64] (1 MB) a call is bound by its launch, not by
// either.  Consecutive lanes read consecutive addresses (coalesced).
//
// Exact arithmetic.  node_un sums small integers, so it is exact.  The
// lane sums add in another order than the plain version's, so p_mean
// agrees to rounding (held at rtol 1e-6); the division is an IEEE
// __fdiv_rn.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock) pairs_kernel(
    const float* __restrict__ p, float* __restrict__ node_un,
    float* __restrict__ p_mean, int64_t rows, int vb) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform over the warp: shuffles stay full
  const float* r = p + row * vb;
  float n = 0.f, s = 0.f;
  for (int x = lane; x < vb; x += 32) {
    const float v = r[x];
    if (v > 0.f) {
      n += 1.f;
      s += v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    n += __shfl_xor_sync(0xffffffffu, n, off);
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) {
    node_un[row] = n;
    p_mean[row] = __fdiv_rn(s, fmaxf(n, 1.f));
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the cudaError_t of the
// launch (0 on success).

extern "C" const char* pp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int pp_priority_pairs(const float* p, float* node_un,
                                 float* p_mean, int64_t rows, int vb,
                                 void* stream) {
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  pairs_kernel<<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(p, node_un, p_mean,
                                                      rows, vb);
  return static_cast<int>(cudaGetLastError());
}
