// Multi-job block SpMM (the paper's CAJS: one tile read serves every job)
// for sm_90a, in both semirings.
//
// Replaces the TPU kernel src/repro/kernels/mj_spmm/kernel.py
// (`mj_spmm_call` -> `_plus_kernel`, `_min_kernel`):
//
//   plus-times  out[i,k,j,w] = sum_v d[i,j,v] * t[i,k,v,w]
//   min-plus    out[i,k,j,w] = min_v (d[i,j,v] + t[i,k,v,w])
//
// with t[i,k] = tiles[tile_index[i], k] when an index is given (read
// straight from the [B_N, K, Vb, Vb] block-ELL array: the [q, K, Vb, Vb]
// gathered copy is never written), else tiles[i, k].  Index entries
// outside [0, num_tiles) are clamped, as the reference's gather clamps.
//
// Layout.  The Pallas grid (q, K, J/Jb) keeps the tile resident in VMEM
// while the job chunks stream against it.  Here one thread block owns one
// (i, k): up to Vb = 128 it stages the [Vb, Vb] tile in shared memory once
// and then walks the job chunks, staging each chunk's d rows beside it;
// each thread owns one (job, lane w) output and loops over v in order.
// So each tile is read from device memory once per call, whatever J is.
// From Vb = 256 a tile (256 KB, 1 MB) exceeds a thread block's shared
// memory: each job chunk then streams the tile through shared memory in
// 64 KB slices of RS = rows(Vb) source rows (one contiguous block, the
// tile being row-major by source lane) with the same RS lanes of its d
// rows, carrying each output's sum from slice to slice in v order, so
// every sum keeps the whole-tile order.  A job chunk after the first
// reads the tile again; with a tile of 1 MB per thread block in flight
// that read mostly misses L2 (PERF.md §6 has its share of the bound).
//
// Bound.  A call reads q*K tiles (q*K*Vb^2*4 bytes) and does 2*J*Vb^2
// operations per tile: at J=4 that is 2 operations per byte, far below
// the card's float32 ratio, so device-memory bytes bound it.  The design
// answers that by reading each tile once (up to Vb = 128; from 256 once
// per job chunk), with 16-byte loads,
// and by keeping enough thread blocks (one per tile) in flight to cover
// the load latency; no double buffer yet.
//
// Exact arithmetic.  Build without --use_fast_math: min-plus is an IEEE
// add then fminf from +inf, bit-equal to the plain version (min is exact
// in any order).  Plus-times accumulates fmaf in v order, so it agrees
// with the plain version to rounding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Source rows of a tile staged at once: the whole tile up to Vb = 128, a
// 64 KB slice above (mirrored by kernel.py).
__host__ __device__ constexpr int rows(int vb) {
  return vb >= 256 ? 16384 / vb : vb;
}

template <int VB, bool MIN>
__global__ void __launch_bounds__(1024) mj_spmm_kernel(
    const float* __restrict__ d, const float* __restrict__ tiles,
    const int* __restrict__ tile_index, float* __restrict__ out, int num_k,
    int num_jobs, int jb, int num_tiles) {
  constexpr int RS = rows(VB), NSL = VB / RS;
  extern __shared__ __align__(16) float smem[];
  float* t_s = smem;             // [RS*VB]
  float* d_s = smem + RS * VB;   // [jb*RS]
  const int64_t bid = blockIdx.x;
  const int i = static_cast<int>(bid / num_k);
  const int k = static_cast<int>(bid % num_k);
  int ti = i;
  if (tile_index != nullptr) ti = min(max(tile_index[i], 0), num_tiles - 1);
  const float4* tg = reinterpret_cast<const float4*>(
      tiles + (static_cast<int64_t>(ti) * num_k + k) * VB * VB);
  float4* ts4 = reinterpret_cast<float4*>(t_s);
  const int jj = threadIdx.x / VB, w = threadIdx.x % VB;
  const bool live = jj < jb;
  for (int j0 = 0; j0 < num_jobs; j0 += jb) {
    const float* dg = d + (static_cast<int64_t>(i) * num_jobs + j0) * VB;
    float acc = MIN ? INFINITY : 0.f;
    for (int sl = 0; sl < NSL; ++sl) {
      if (NSL > 1 || j0 == 0)    // a whole tile is staged once
        for (int x = threadIdx.x; x < RS * VB / 4; x += blockDim.x)
          ts4[x] = tg[sl * (RS * VB / 4) + x];
      for (int x = threadIdx.x; x < jb * RS; x += blockDim.x)
        d_s[x] = dg[(x / RS) * VB + sl * RS + x % RS];
      __syncthreads();
      if (live) {
        const float* dr = d_s + jj * RS;
#pragma unroll 16
        for (int v = 0; v < RS; ++v) {
          if constexpr (MIN) {
            acc = fminf(acc, __fadd_rn(dr[v], t_s[v * VB + w]));
          } else {
            acc = fmaf(dr[v], t_s[v * VB + w], acc);
          }
        }
      }
      __syncthreads();
    }
    if (live)
      out[((static_cast<int64_t>(i) * num_k + k) * num_jobs + j0 + jj) * VB +
          w] = acc;
  }
}

inline int smem_bytes(int jb, int vb) {
  return static_cast<int>(sizeof(float)) * (rows(vb) * vb + jb * rows(vb));
}

template <int VB, bool MIN>
int launch(const float* d, const float* tiles, const int* tile_index,
           float* out, int q, int num_k, int num_jobs, int jb, int num_tiles,
           cudaStream_t stream) {
  const int smem = smem_bytes(jb, VB);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mj_spmm_kernel<VB, MIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = (jb * VB + 31) / 32 * 32;
  const int64_t blocks = static_cast<int64_t>(q) * num_k;
  mj_spmm_kernel<VB, MIN><<<static_cast<unsigned>(blocks), threads, smem,
                            stream>>>(d, tiles, tile_index, out, num_k,
                                      num_jobs, jb, num_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool MIN>
int dispatch(const float* d, const float* tiles, const int* tile_index,
             float* out, int q, int num_k, int num_jobs, int jb,
             int num_tiles, int vb, cudaStream_t s) {
  switch (vb) {
#define MS_CASE(V)                                                         \
  case V:                                                                  \
    return launch<V, MIN>(d, tiles, tile_index, out, q, num_k, num_jobs,  \
                          jb, num_tiles, s);
    MS_CASE(8) MS_CASE(16) MS_CASE(32) MS_CASE(64) MS_CASE(128)
    MS_CASE(256) MS_CASE(512)
#undef MS_CASE
    default: return -1;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the cudaError_t of the
// launch (0 on success); -1 for an unsupported Vb.

extern "C" int ms_smem_bytes(int jb, int vb) { return smem_bytes(jb, vb); }

extern "C" const char* ms_error_string(int code) {
  if (code == -1) return "unsupported block size";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int ms_mj_spmm(const float* d, const float* tiles,
                          const int* tile_index, float* out, int q,
                          int num_k, int num_jobs, int jb, int num_tiles,
                          int vb, int min_plus, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return min_plus ? dispatch<true>(d, tiles, tile_index, out, q, num_k,
                                   num_jobs, jb, num_tiles, vb, s)
                  : dispatch<false>(d, tiles, tile_index, out, q, num_k,
                                    num_jobs, jb, num_tiles, vb, s);
}
