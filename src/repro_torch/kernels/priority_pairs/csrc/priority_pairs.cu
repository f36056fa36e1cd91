// <Node_un, P_mean> pair reduction (paper Eq. 1) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/priority_pairs/kernel.py
// (`priority_pairs_call` -> `_pairs_kernel`): for every (job j, block b)
// row of the per-vertex priority array [J, B_N, Vb],
//
//   node_un[j,b] = #{v: p[j,b,v] > 0}
//   p_mean[j,b]  = sum_{v: p > 0} p[j,b,v] / max(node_un[j,b], 1)
//
// The Pallas grid (J, B_N) reduces one [Vb] stripe per step.  Here a
// segment of lanes owns one row.
//
// Bound.  Each priority is read once and two floats per row are written:
// about 0.5 operation per byte, so bytes bound it, never operations.
//   - At the entry point's [4, 1024, 64] (1 MB, left in L2 by whoever
//     computed the priorities) the bytes take a fraction of a
//     microsecond; the launch itself bounds the call.  So the grid has
//     enough blocks to put every SM to work at once (4096 rows / 16 rows
//     per block = 256 blocks on 132 SMs) and no block does more than one
//     round of loads.
//   - At [16, 16384, 64] (64 MB, more than the 50 MB L2) device memory
//     bounds it: (64 + 2) MiB / 3.35 TB/s = 20.7 us.  Loads are 16 bytes
//     a thread with neighbouring threads on neighbouring addresses, and
//     eight 256-thread blocks per SM keep 32 KB per SM in flight.
//
// Two variants, picked by the wrapper (kernel.py `pick_variant`):
//   vector   Vb % 4 == 0 and 16-byte aligned rows.  A row is read as Vb/4
//            float4s by a segment of LANES threads, LANES the next power
//            of two >= Vb/4, at most 32 (16 at Vb = 64: two rows per
//            warp); longer rows loop.  The count (an int) and the masked
//            sum reduce over the segment with __shfl_xor_sync(width =
//            LANES): four steps at Vb = 64.
//   scalar   any other Vb or a misaligned pointer: one warp per row, the
//            lanes stride the Vb values with 4-byte loads.
// Both stage the block's results in shared memory and write node_un and
// p_mean as two contiguous runs, not one lane's scattered store per row.
// The output is one [2, rows] buffer: node_un, then p_mean.
//
// Exact arithmetic.  node_un is an integer count, so it is exact.  The
// sum adds in another order than the plain version's, so p_mean agrees to
// rounding (held at rtol 1e-6); the division is an IEEE __fdiv_rn.  Build
// without --use_fast_math.  NaN and -0.0 are not > 0 and are left out;
// +inf is counted (the rule of the reference's ref.py).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void tally(float v, int& n, float& s) {
  if (v > 0.f) {
    ++n;
    s += v;
  }
}

// Lane 0 of each row's segment stages (node_un, p_mean); then the block
// writes both as contiguous runs of kRows floats.
template <int kRows>
__device__ __forceinline__ void finish(float* stage, int seg, bool leader,
                                       int n, float s, float* __restrict__ out,
                                       int64_t row0, int64_t rows) {
  if (leader) {
    const float nf = static_cast<float>(n);
    stage[seg] = nf;
    stage[kRows + seg] = __fdiv_rn(s, fmaxf(nf, 1.f));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * kRows; i += kThreads) {
    const int half = i / kRows;
    const int64_t row = row0 + (i - half * kRows);
    if (row < rows) out[half * rows + row] = stage[i];
  }
}

template <int kLanes>
__global__ void __launch_bounds__(kThreads) pairs_vector(
    const float4* __restrict__ p, float* __restrict__ out, int64_t rows,
    int vb4) {
  constexpr int kRows = kThreads / kLanes;
  __shared__ float stage[2 * kRows];
  const int seg = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t row = row0 + seg;
  int n = 0;
  float s = 0.f;
  if (row < rows) {  // rows past the end still join the shuffles below
    const float4* r = p + row * vb4;
    for (int c = lane; c < vb4; c += kLanes) {
      const float4 v = __ldg(r + c);
      tally(v.x, n, s);
      tally(v.y, n, s);
      tally(v.z, n, s);
      tally(v.w, n, s);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    n += __shfl_xor_sync(0xffffffffu, n, off, kLanes);
    s += __shfl_xor_sync(0xffffffffu, s, off, kLanes);
  }
  finish<kRows>(stage, seg, lane == 0, n, s, out, row0, rows);
}

__global__ void __launch_bounds__(kThreads) pairs_scalar(
    const float* __restrict__ p, float* __restrict__ out, int64_t rows,
    int vb) {
  constexpr int kRows = kThreads / 32;
  __shared__ float stage[2 * kRows];
  const int seg = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t row = row0 + seg;
  int n = 0;
  float s = 0.f;
  if (row < rows) {
    const float* r = p + row * vb;
    for (int x = lane; x < vb; x += 32) tally(r[x], n, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    n += __shfl_xor_sync(0xffffffffu, n, off);
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  finish<kRows>(stage, seg, lane == 0, n, s, out, row0, rows);
}

__global__ void empty_kernel() {}

template <int kLanes>
int launch_vector(const float* p, float* out, int64_t rows, int vb,
                  cudaStream_t stream) {
  constexpr int kRows = kThreads / kLanes;
  const int64_t blocks = (rows + kRows - 1) / kRows;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  pairs_vector<kLanes><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(p), out, rows, vb / 4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns the cudaError_t of
// the launch (0 on success).

extern "C" const char* pp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// p [rows, vb] float32; out [2, rows] float32 (node_un, p_mean).  lanes:
// the vector variant's lanes per row (1, 2, 4, 8, 16 or 32; needs vb % 4
// == 0 and a 16-byte aligned p), or 0 for the scalar variant.
extern "C" int pp_priority_pairs(const float* p, float* out, int64_t rows,
                                 int vb, int lanes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || vb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) {
    const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    if (blocks > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    pairs_scalar<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        p, out, rows, vb);
    return static_cast<int>(cudaGetLastError());
  }
  if (vb % 4 != 0 || reinterpret_cast<uintptr_t>(p) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  switch (lanes) {
    case 1: return launch_vector<1>(p, out, rows, vb, s);
    case 2: return launch_vector<2>(p, out, rows, vb, s);
    case 4: return launch_vector<4>(p, out, rows, vb, s);
    case 8: return launch_vector<8>(p, out, rows, vb, s);
    case 16: return launch_vector<16>(p, out, rows, vb, s);
    case 32: return launch_vector<32>(p, out, rows, vb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One launch of an empty kernel: the least that any lone launch costs.
extern "C" int pp_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
