// Fused CAJS superstep over destination-sorted block pairs, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/fused_superstep/kernel.py
// (`fused_superstep_call` -> `_make_plus_kernel`, `_make_min_kernel`): one
// push of every selected block for every job of a view, fused with the
// <Node_un, P_sum> priority update of each destination block.
//
//   plus-times  out[j,b] = base[j,b] + sum_{p: dst[p]=b} d[j,src[p]] @ tiles[p]
//   min-plus    cand[j,b,w] = min_{p: dst[p]=b} min_v d[j,src[p],v] + t[p,v,w]
//               v_new = min(v_old, cand); d_new = min(dbase, v_new < v_old ?
//               v_new : inf)
//   flush       node_un[j,b] = #{w: pr > 0}, p_sum[j,b] = sum_w pr with
//               pr = |out| >= tol ? |out| : 0   (plus-times)
//               pr = isfinite(d_new) ? 1/(1+d_new) : 0   (min-plus)
//
// Layout.  The Pallas kernel walks a sequential grid and keeps one output
// block resident across a destination run.  Thread blocks here run in no
// order, so each thread block owns one (destination run r, job chunk):
// it loops over its run's pairs run_start[r]..run_start[r+1] in order, and
// each thread owns one (job jj, lane w) output.  No atomics; the result is
// deterministic.  Plus-times starts its accumulator from `base` and adds
// one per-pair partial after another, as the Pallas kernel does.
//
// Bound.  Each call sweeps all P tiles (selection is encoded by masking
// `d` rows to the semiring identity), so it moves P*Vb^2*4 bytes of tiles
// and does 2*J*P*Vb^2 flops: about 0.4 flop per byte at J=4, far below the
// card's float32 ratio, so it is bound by device-memory bytes.  The design
// answers that with a cp.async double buffer: pair p+1's tile and d rows
// stream into shared memory while pair p is computed.  Each tile is read
// once per job chunk, and the job chunk spans the whole job axis whenever
// shared memory and the 1024-thread limit allow.
//
// Width contract.  `d` is indexed at the global source width [J, bn_src,
// Vb]; base/values and every output at the local width [J, bn_loc, Vb].
// Runs whose destination lies outside [0, bn_loc) are dropped; pairs whose
// source lies outside [0, bn_src) contribute the semiring identity.
//
// Exact arithmetic.  Build without --use_fast_math: min-plus must be an
// IEEE float add followed by fminf, and the priority an IEEE 1/(1+d), so
// min-plus values, deltas and node_un are bit-equal to the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage pair p: its [VB, VB] tile and the chunk's jb gathered d rows.
template <int VB>
__device__ __forceinline__ void stage_pair(
    float* tile_s, float* d_s, const float* __restrict__ tiles,
    const float* __restrict__ d, int p, int s, int j0, int jb, int bn_src,
    float identity) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* tg = tiles + static_cast<size_t>(p) * VB * VB;
  for (int i = tid; i < VB * VB / 4; i += nt) cp_async16(tile_s + 4 * i, tg + 4 * i);
  constexpr int R4 = VB / 4;
  const bool ok = s >= 0 && s < bn_src;
  for (int i = tid; i < jb * R4; i += nt) {
    const int jj = i / R4, c = 4 * (i % R4);
    if (ok) {
      const float* row =
          d + (static_cast<size_t>(j0 + jj) * bn_src + s) * VB;
      cp_async16(d_s + jj * VB + c, row + c);
    } else {
      for (int k = 0; k < 4; ++k) d_s[jj * VB + c + k] = identity;
    }
  }
}

// Sum (un, pr) over the VB lanes of each job row; lane 0 of the row
// writes.  Every thread of the block calls it (it may __syncthreads).
template <int VB>
__device__ __forceinline__ void row_reduce_store(float un, float pr, int jj,
                                                 int w, bool live,
                                                 float* red, float* nu_out,
                                                 float* ps_out) {
  constexpr int W = VB < 32 ? VB : 32;
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    un += __shfl_xor_sync(0xffffffffu, un, off);
    pr += __shfl_xor_sync(0xffffffffu, pr, off);
  }
  if constexpr (VB <= 32) {
    if (live && w == 0) {
      *nu_out = un;
      *ps_out = pr;
    }
  } else {
    constexpr int NW = VB / 32;
    if (live && (w & 31) == 0) {
      red[(jj * NW + (w >> 5)) * 2] = un;
      red[(jj * NW + (w >> 5)) * 2 + 1] = pr;
    }
    __syncthreads();
    if (live && w == 0) {
      float u = 0.f, s = 0.f;
      for (int k = 0; k < NW; ++k) {
        u += red[(jj * NW + k) * 2];
        s += red[(jj * NW + k) * 2 + 1];
      }
      *nu_out = u;
      *ps_out = s;
    }
  }
}

template <int VB>
__global__ void __launch_bounds__(1024) plus_times_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const int* __restrict__ run_start, const float* __restrict__ d,
    const float* __restrict__ base, const float* __restrict__ tiles,
    float* __restrict__ out, float* __restrict__ node_un,
    float* __restrict__ p_sum, int jb, int bn_src, int bn_loc, float tol) {
  extern __shared__ __align__(16) float smem[];
  float* tile_s = smem;                    // [2][VB*VB]
  float* d_s = smem + 2 * VB * VB;         // [2][jb*VB]
  float* red = d_s + 2 * jb * VB;          // [jb][VB/32][2]
  const int r = blockIdx.x;
  const int j0 = blockIdx.y * jb;
  const int p0 = run_start[r], p1 = run_start[r + 1];
  const int b = dst[p0];
  if (b < 0 || b >= bn_loc) return;        // dropped run: the whole block
  const int tid = threadIdx.x;
  const int jj = tid / VB, w = tid % VB;
  const bool live = jj < jb;
  const size_t o = (static_cast<size_t>(j0 + jj) * bn_loc + b) * VB + w;
  float acc = live ? base[o] : 0.f;

  stage_pair<VB>(tile_s, d_s, tiles, d, p0, src[p0], j0, jb, bn_src, 0.f);
  cp_async_commit();
  for (int p = p0; p < p1; ++p) {
    const int cur = (p - p0) & 1;
    if (p + 1 < p1) {
      stage_pair<VB>(tile_s + (cur ^ 1) * VB * VB, d_s + (cur ^ 1) * jb * VB,
                     tiles, d, p + 1, src[p + 1], j0, jb, bn_src, 0.f);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const float* t = tile_s + cur * VB * VB;
      const float* dr = d_s + cur * jb * VB + jj * VB;
      float part = 0.f;
#pragma unroll 16
      for (int v = 0; v < VB; ++v) part = fmaf(dr[v], t[v * VB + w], part);
      acc += part;
    }
    __syncthreads();
  }

  float un = 0.f, pr = 0.f;
  if (live) {
    out[o] = acc;
    const float a = fabsf(acc);
    pr = a >= tol ? a : 0.f;
    un = pr > 0.f ? 1.f : 0.f;
  }
  const size_t pb = static_cast<size_t>(j0 + jj) * bn_loc + b;
  row_reduce_store<VB>(un, pr, jj, w, live, red, node_un + pb, p_sum + pb);
}

template <int VB>
__global__ void __launch_bounds__(1024) min_plus_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const int* __restrict__ run_start, const float* __restrict__ d,
    const float* __restrict__ values, const float* __restrict__ dbase,
    const float* __restrict__ tiles, float* __restrict__ vout,
    float* __restrict__ dout, float* __restrict__ node_un,
    float* __restrict__ p_sum, int jb, int bn_src, int bn_loc) {
  extern __shared__ __align__(16) float smem[];
  float* tile_s = smem;
  float* d_s = smem + 2 * VB * VB;
  float* red = d_s + 2 * jb * VB;
  const int r = blockIdx.x;
  const int j0 = blockIdx.y * jb;
  const int p0 = run_start[r], p1 = run_start[r + 1];
  const int b = dst[p0];
  if (b < 0 || b >= bn_loc) return;
  const int tid = threadIdx.x;
  const int jj = tid / VB, w = tid % VB;
  const bool live = jj < jb;
  float cand = INFINITY;

  stage_pair<VB>(tile_s, d_s, tiles, d, p0, src[p0], j0, jb, bn_src,
                 INFINITY);
  cp_async_commit();
  for (int p = p0; p < p1; ++p) {
    const int cur = (p - p0) & 1;
    if (p + 1 < p1) {
      stage_pair<VB>(tile_s + (cur ^ 1) * VB * VB, d_s + (cur ^ 1) * jb * VB,
                     tiles, d, p + 1, src[p + 1], j0, jb, bn_src, INFINITY);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const float* t = tile_s + cur * VB * VB;
      const float* dr = d_s + cur * jb * VB + jj * VB;
      float c = INFINITY;
#pragma unroll 16
      for (int v = 0; v < VB; ++v) c = fminf(c, __fadd_rn(dr[v], t[v * VB + w]));
      cand = fminf(cand, c);
    }
    __syncthreads();
  }

  float un = 0.f, pr = 0.f;
  if (live) {
    const size_t o = (static_cast<size_t>(j0 + jj) * bn_loc + b) * VB + w;
    const float v_old = values[o];
    const float v_new = fminf(v_old, cand);
    vout[o] = v_new;
    const float dn = fminf(dbase[o], v_new < v_old ? v_new : INFINITY);
    dout[o] = dn;
    pr = isfinite(dn) ? __fdiv_rn(1.0f, __fadd_rn(1.0f, dn)) : 0.f;
    un = pr > 0.f ? 1.f : 0.f;
  }
  const size_t pb = static_cast<size_t>(j0 + jj) * bn_loc + b;
  row_reduce_store<VB>(un, pr, jj, w, live, red, node_un + pb, p_sum + pb);
}

inline int smem_bytes(int jb, int vb) {
  const int nw = vb >= 32 ? vb / 32 : 1;
  return static_cast<int>(sizeof(float)) *
         (2 * vb * vb + 2 * jb * vb + 2 * jb * nw);
}

inline int threads_for(int jb, int vb) { return (jb * vb + 31) / 32 * 32; }

template <typename K>
int prepare(K kernel, int smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <int VB>
int launch_plus(const int* src, const int* dst, const int* run_start,
                int num_runs, const float* d, const float* base,
                const float* tiles, float* out, float* node_un, float* p_sum,
                int j, int jb, int bn_src, int bn_loc, float tol,
                cudaStream_t stream) {
  const int smem = smem_bytes(jb, VB);
  int rc = prepare(plus_times_kernel<VB>, smem);
  if (rc) return rc;
  dim3 grid(num_runs, j / jb);
  plus_times_kernel<VB><<<grid, threads_for(jb, VB), smem, stream>>>(
      src, dst, run_start, d, base, tiles, out, node_un, p_sum, jb, bn_src,
      bn_loc, tol);
  return static_cast<int>(cudaGetLastError());
}

template <int VB>
int launch_min(const int* src, const int* dst, const int* run_start,
               int num_runs, const float* d, const float* values,
               const float* dbase, const float* tiles, float* vout,
               float* dout, float* node_un, float* p_sum, int j, int jb,
               int bn_src, int bn_loc, cudaStream_t stream) {
  const int smem = smem_bytes(jb, VB);
  int rc = prepare(min_plus_kernel<VB>, smem);
  if (rc) return rc;
  dim3 grid(num_runs, j / jb);
  min_plus_kernel<VB><<<grid, threads_for(jb, VB), smem, stream>>>(
      src, dst, run_start, d, values, dbase, tiles, vout, dout, node_un,
      p_sum, jb, bn_src, bn_loc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each launcher returns the
// cudaError_t of the launch (0 on success); -1 for an unsupported Vb.

extern "C" int fs_smem_bytes(int jb, int vb) { return smem_bytes(jb, vb); }

extern "C" const char* fs_error_string(int code) {
  if (code == -1) return "unsupported block size";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int fs_plus_times(const int* src, const int* dst,
                             const int* run_start, int num_runs,
                             const float* d, const float* base,
                             const float* tiles, float* out, float* node_un,
                             float* p_sum, int j, int jb, int bn_src,
                             int bn_loc, int vb, float tol, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vb) {
    case 16: return launch_plus<16>(src, dst, run_start, num_runs, d, base, tiles, out, node_un, p_sum, j, jb, bn_src, bn_loc, tol, s);
    case 32: return launch_plus<32>(src, dst, run_start, num_runs, d, base, tiles, out, node_un, p_sum, j, jb, bn_src, bn_loc, tol, s);
    case 64: return launch_plus<64>(src, dst, run_start, num_runs, d, base, tiles, out, node_un, p_sum, j, jb, bn_src, bn_loc, tol, s);
    case 128: return launch_plus<128>(src, dst, run_start, num_runs, d, base, tiles, out, node_un, p_sum, j, jb, bn_src, bn_loc, tol, s);
    default: return -1;
  }
}

extern "C" int fs_min_plus(const int* src, const int* dst,
                           const int* run_start, int num_runs,
                           const float* d, const float* values,
                           const float* dbase, const float* tiles,
                           float* vout, float* dout, float* node_un,
                           float* p_sum, int j, int jb, int bn_src,
                           int bn_loc, int vb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vb) {
    case 16: return launch_min<16>(src, dst, run_start, num_runs, d, values, dbase, tiles, vout, dout, node_un, p_sum, j, jb, bn_src, bn_loc, s);
    case 32: return launch_min<32>(src, dst, run_start, num_runs, d, values, dbase, tiles, vout, dout, node_un, p_sum, j, jb, bn_src, bn_loc, s);
    case 64: return launch_min<64>(src, dst, run_start, num_runs, d, values, dbase, tiles, vout, dout, node_un, p_sum, j, jb, bn_src, bn_loc, s);
    case 128: return launch_min<128>(src, dst, run_start, num_runs, d, values, dbase, tiles, vout, dout, node_un, p_sum, j, jb, bn_src, bn_loc, s);
    default: return -1;
  }
}
