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
// Bound.  A call moves the [Vb, Vb] tile and the jb d rows of every LIVE
// pair (source selected) once, and does 2*J*Vb^2 flops per live pair:
// about 0.5 flop per byte at J=4, far below the card's float32 ratio, so
// it is bound by device-memory bytes, and by how many of them are in
// flight.  The design answers that in four parts.
//
// 1. Work items.  The Pallas kernel walks a sequential grid and keeps one
//    output block resident across a destination run.  Here each thread
//    block owns one (chunk, job chunk): a chunk is at most C consecutive
//    pairs of one run (`chunk_start`, `chunk_run`, built on the host), so
//    a power-law graph's longest run no longer sets the call's length.  A
//    run of one chunk flushes directly.  Otherwise each block writes its
//    partial (plus-times sum, min-plus candidate) to `partial [n_chunks,
//    J, Vb]` (L2-resident), fences and counts itself in at the run's
//    arrival counter; the last block to arrive combines the run's
//    partials in chunk order (base + part_0 + part_1 + ..., or fminf,
//    which is order-free), flushes and sets the counter back to 0, so no
//    memset launch is needed.  The result does not depend on which block
//    is last: two calls on the same inputs are bit-identical.
// 2. A TMA ring.  A pair's tile is contiguous; thread 0 issues it as one
//    1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx) into one of
//    NS stages, with the jb d rows of its source on the same mbarrier.
//    Every thread keeps its (job, lane) output and waits on the stage's
//    full barrier; each warp releases the stage on its empty barrier,
//    and thread 0 refills it NS pairs ahead.
// 3. Live pairs only.  `src_live [bn_src]` (null: all live) marks the
//    selected source blocks.  Each block compacts its chunk's live pairs
//    into shared memory (ballot + prefix, WINDOW pairs per pass) and
//    stages only those.  The caller's d rows of unselected sources are
//    the semiring identity, so skipping them is exact (min-plus bitwise,
//    plus-times up to the sign of a zero).  A chunk with no live pair
//    still writes its identity partial and arrives.
// 4. A device gate.  `gate` (null: open) is a device bool read at entry:
//    when false every block returns before any load and the outputs are
//    left undefined (the device driver discards them).
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

// Live pairs compacted per pass (the shared-memory list's capacity).
constexpr int WINDOW = 256;

// Ring depth: 3 thread blocks per SM at Vb = 64 (4 x 17 KB stages each).
__host__ __device__ constexpr int stages(int vb) {
  return vb >= 128 ? 3 : (vb >= 64 ? 4 : 6);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t tx) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(tx)
      : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One 1-D bulk copy global -> shared, completing on `bar`'s tx count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The first chunk and one past the last chunk of run r, around chunk c:
// the chunks of a run are consecutive, so one warp reads 32 neighbours at
// a time and counts the matching prefix.  Every lane gets the result.
__device__ __forceinline__ void run_chunks(const int* __restrict__ chunk_run,
                                           int n_chunks, int c, int r,
                                           int lane, int& lo, int& hi) {
  lo = c;
  for (;;) {
    const int k = lo - 1 - lane;
    const unsigned m = __ballot_sync(0xffffffffu, k >= 0 && chunk_run[k] == r);
    const int step = __popc(~m) ? __ffs(~m) - 1 : 32;   // matching prefix
    lo -= step;
    if (step < 32) break;
  }
  hi = c + 1;
  for (;;) {
    const int k = hi + lane;
    const unsigned m =
        __ballot_sync(0xffffffffu, k < n_chunks && chunk_run[k] == r);
    const int step = __popc(~m) ? __ffs(~m) - 1 : 32;
    hi += step;
    if (step < 32) break;
  }
}

struct Args {
  const int* src;            // [P] source block of each pair
  const int* dst;            // [P] destination block (non-decreasing)
  const int* run_start;      // [R+1]
  const int* chunk_start;    // [n_chunks+1]
  const int* chunk_run;      // [n_chunks]
  int n_chunks;
  const unsigned char* src_live;  // [bn_src] or null (all live)
  const unsigned char* gate;      // 0-dim device bool or null (open)
  int* arrivals;             // [R * J/jb], zero between calls
  float* partial;            // [n_chunks, J, Vb] scratch
  const float* d;            // [J, bn_src, Vb]
  const float* base;         // [J, bn_loc, Vb]  plus: base; min: dbase
  const float* values;       // [J, bn_loc, Vb]  min-plus only
  const float* tiles;        // [P, Vb, Vb]
  float* out;                // plus: out; min: values out
  float* dout;               // min-plus: deltas out
  float* node_un;            // [J, bn_loc]
  float* p_sum;              // [J, bn_loc]
  int j, jb, bn_src, bn_loc;
  float tol;
};

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

// Stage load number g (ring stage g % NS) of pair p, source s: wait until
// every warp has released the stage's previous load, then one bulk copy
// of the tile and one of each of the job chunk's d rows on its full
// barrier.  Thread 0 only.
template <int VB>
__device__ __forceinline__ void issue_load(
    const float* __restrict__ tiles, const float* __restrict__ d, int jb,
    int bn_src, float* tile_s, float* d_s, uint64_t* full, uint64_t* empty,
    int g, int p, int s, int j0) {
  constexpr int NS = stages(VB);
  constexpr uint32_t tile_bytes = VB * VB * 4, row_bytes = VB * 4;
  const int st = g % NS;
  if (g >= NS) mbar_wait(&empty[st], ((g / NS) + 1) & 1);
  mbar_expect_tx(&full[st], tile_bytes + jb * row_bytes);
  bulk_load(tile_s + st * VB * VB, tiles + static_cast<size_t>(p) * VB * VB,
            tile_bytes, &full[st]);
  for (int k = 0; k < jb; ++k)
    bulk_load(d_s + (st * jb + k) * VB,
              d + (static_cast<size_t>(j0 + k) * bn_src + s) * VB, row_bytes,
              &full[st]);
}

// Shared memory of one thread block, in bytes (mirrored by kernel.py):
// NS stages of a [VB, VB] tile and jb d rows, the live-pair list (pair
// and source), per-warp counts, the flush's per-warp sums, four ints,
// then 2*NS mbarriers.
__host__ __device__ constexpr int smem_floats(int jb, int vb) {
  return stages(vb) * (vb * vb + jb * vb) + 2 * WINDOW + 32 +
         2 * jb * (vb >= 32 ? vb / 32 : 1) + 4;
}

inline int smem_bytes(int jb, int vb) {
  return 4 * smem_floats(jb, vb) + 16 * stages(vb);
}

template <int VB, bool MIN>
__global__ void __launch_bounds__(1024) superstep_kernel(const Args a) {
  if (a.gate != nullptr && *a.gate == 0) return;   // gated: no load at all
  constexpr int NS = stages(VB);
  constexpr int NW = VB >= 32 ? VB / 32 : 1;
  extern __shared__ __align__(16) float smem[];
  const int jb = a.jb;
  float* tile_s = smem;                             // [NS][VB*VB]
  float* d_s = tile_s + NS * VB * VB;               // [NS][jb*VB]
  int* list_p = reinterpret_cast<int*>(d_s + NS * jb * VB);  // [WINDOW]
  int* list_s = list_p + WINDOW;                    // [WINDOW]
  int* wcnt = list_s + WINDOW;                      // [32]
  float* red = reinterpret_cast<float*>(wcnt + 32); // [jb][NW][2]
  int* misc = reinterpret_cast<int*>(red + 2 * jb * NW);     // [4]
  uint64_t* full = reinterpret_cast<uint64_t*>(misc + 4);    // [NS]
  uint64_t* empty = full + NS;                      // [NS]

  const int c = blockIdx.x;
  const int r = a.chunk_run[c];
  const int r0 = a.run_start[r], r1 = a.run_start[r + 1];
  const int b = a.dst[r0];
  if (b < 0 || b >= a.bn_loc) return;               // dropped run
  const int p0 = a.chunk_start[c], p1 = a.chunk_start[c + 1];
  const bool single = p0 == r0 && p1 == r1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int jj = tid / VB, w = tid % VB;
  const bool live = jj < jb;
  const int j0 = blockIdx.y * jb;
  const size_t o = (static_cast<size_t>(j0 + jj) * a.bn_loc + b) * VB + w;
  // a run of one chunk starts from `base` and flushes directly
  float acc = MIN ? INFINITY : ((live && single) ? a.base[o] : 0.f);

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nwarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!single && warp == nwarps - 1) {   // the run's chunks, for the flush
    int lo, hi;
    run_chunks(a.chunk_run, a.n_chunks, c, r, lane, lo, hi);
    if (lane == 0) {
      misc[1] = lo;
      misc[2] = hi;
    }
  }
  __syncthreads();

  int g = 0;                     // stage loads so far
  for (int w0 = p0; w0 < p1; w0 += WINDOW) {
    const int w1 = min(p1, w0 + WINDOW);
    // compact the window's live pairs into (list_p, list_s), in order
    int n = 0;
    for (int q0 = w0; q0 < w1; q0 += nt) {
      const int p = q0 + tid;
      int s = -1;
      bool ok = false;
      if (p < w1) {
        s = a.src[p];
        ok = s >= 0 && s < a.bn_src &&
             (a.src_live == nullptr || a.src_live[s] != 0);
      }
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) wcnt[warp] = __popc(m);
      __syncthreads();
      int off = n, tot = 0;
      for (int k = 0; k < nwarps; ++k) {
        const int cnt = wcnt[k];
        off += k < warp ? cnt : 0;
        tot += cnt;
      }
      if (ok) {
        const int i = off + __popc(m & ((1u << lane) - 1u));
        list_p[i] = p;
        list_s[i] = s;
      }
      n += tot;
      __syncthreads();
    }
    if (tid == 0)                // fill the ring
      for (int i = 0; i < n && i < NS; ++i)
        issue_load<VB>(a.tiles, a.d, jb, a.bn_src, tile_s, d_s, full, empty,
                       g + i, list_p[i], list_s[i], j0);
    for (int i = 0; i < n; ++i, ++g) {
      const int st = g % NS;
      mbar_wait(&full[st], (g / NS) & 1);
      if (live) {
        const float* t = tile_s + st * VB * VB + w;
        const float4* dr =
            reinterpret_cast<const float4*>(d_s + (st * jb + jj) * VB);
        float part = MIN ? INFINITY : 0.f;
#pragma unroll
        for (int v4 = 0; v4 < VB / 4; ++v4) {
          const float4 dv = dr[v4];
          const float* tv = t + 4 * v4 * VB;
          if constexpr (MIN) {
            part = fminf(part, __fadd_rn(dv.x, tv[0]));
            part = fminf(part, __fadd_rn(dv.y, tv[VB]));
            part = fminf(part, __fadd_rn(dv.z, tv[2 * VB]));
            part = fminf(part, __fadd_rn(dv.w, tv[3 * VB]));
          } else {
            part = fmaf(dv.x, tv[0], part);
            part = fmaf(dv.y, tv[VB], part);
            part = fmaf(dv.z, tv[2 * VB], part);
            part = fmaf(dv.w, tv[3 * VB], part);
          }
        }
        if constexpr (MIN) acc = fminf(acc, part);
        else acc += part;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (tid == 0 && i + NS < n)
        issue_load<VB>(a.tiles, a.d, jb, a.bn_src, tile_s, d_s, full, empty,
                       g + NS, list_p[i + NS], list_s[i + NS], j0);
    }
  }

  if (!single) {
    // count in at the run's counter; the last block to arrive combines
    if (live) a.partial[(static_cast<size_t>(c) * a.j + j0 + jj) * VB + w] = acc;
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* cnt = a.arrivals + static_cast<size_t>(r) * gridDim.y + blockIdx.y;
      const int last = atomicAdd(cnt, 1) == misc[2] - misc[1] - 1;
      if (last) *cnt = 0;                  // ready for the next call
      misc[0] = last;
    }
    __syncthreads();
    if (!misc[0]) return;
    __threadfence();
    if (live) {
      float v = MIN ? INFINITY : a.base[o];
#pragma unroll 8
      for (int k = misc[1]; k < misc[2]; ++k) {
        const float pk =
            k == c ? acc
                   : __ldcg(a.partial +
                            (static_cast<size_t>(k) * a.j + j0 + jj) * VB + w);
        if constexpr (MIN) v = fminf(v, pk);
        else v += pk;
      }
      acc = v;
    }
  }

  float un = 0.f, pr = 0.f;
  if (live) {
    if constexpr (MIN) {
      const float v_old = a.values[o];
      const float v_new = fminf(v_old, acc);
      a.out[o] = v_new;
      const float dn = fminf(a.base[o], v_new < v_old ? v_new : INFINITY);
      a.dout[o] = dn;
      pr = isfinite(dn) ? __fdiv_rn(1.0f, __fadd_rn(1.0f, dn)) : 0.f;
    } else {
      a.out[o] = acc;
      const float av = fabsf(acc);
      pr = av >= a.tol ? av : 0.f;
    }
    un = pr > 0.f ? 1.f : 0.f;
  }
  const size_t pb = static_cast<size_t>(j0 + jj) * a.bn_loc + b;
  row_reduce_store<VB>(un, pr, jj, w, live, red, a.node_un + pb,
                       a.p_sum + pb);
}

inline int threads_for(int jb, int vb) { return (jb * vb + 31) / 32 * 32; }

template <int VB, bool MIN>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes(a.jb, VB);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        superstep_kernel<VB, MIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(a.n_chunks, a.j / a.jb);
  superstep_kernel<VB, MIN><<<grid, threads_for(a.jb, VB), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int VB, bool MIN>
int occupancy(int jb) {
  int n = 0;
  const int smem = smem_bytes(jb, VB);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(superstep_kernel<VB, MIN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, superstep_kernel<VB, MIN>, threads_for(jb, VB), smem) !=
      cudaSuccess)
    return -1;
  return n;
}

template <bool MIN>
int dispatch(const Args& a, int vb, cudaStream_t s) {
  switch (vb) {
    case 16: return launch<16, MIN>(a, s);
    case 32: return launch<32, MIN>(a, s);
    case 64: return launch<64, MIN>(a, s);
    case 128: return launch<128, MIN>(a, s);
    default: return -1;
  }
}

Args common_args(const int* src, const int* dst, const int* run_start,
                 const int* chunk_start, const int* chunk_run, int n_chunks,
                 const unsigned char* src_live, const unsigned char* gate,
                 int* arrivals, float* partial, const float* d, int j,
                 int jb, int bn_src, int bn_loc) {
  Args a{};
  a.src = src;
  a.dst = dst;
  a.run_start = run_start;
  a.chunk_start = chunk_start;
  a.chunk_run = chunk_run;
  a.n_chunks = n_chunks;
  a.src_live = src_live;
  a.gate = gate;
  a.arrivals = arrivals;
  a.partial = partial;
  a.d = d;
  a.j = j;
  a.jb = jb;
  a.bn_src = bn_src;
  a.bn_loc = bn_loc;
  return a;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each launcher returns the
// cudaError_t of the launch (0 on success); -1 for an unsupported Vb.

extern "C" int fs_smem_bytes(int jb, int vb) { return smem_bytes(jb, vb); }

// Thread blocks of one kernel that fit one SM at (jb, vb); -1 on error.
extern "C" int fs_blocks_per_sm(int jb, int vb, int min_plus) {
  switch (vb * 2 + (min_plus ? 1 : 0)) {
    case 32: return occupancy<16, false>(jb);
    case 33: return occupancy<16, true>(jb);
    case 64: return occupancy<32, false>(jb);
    case 65: return occupancy<32, true>(jb);
    case 128: return occupancy<64, false>(jb);
    case 129: return occupancy<64, true>(jb);
    case 256: return occupancy<128, false>(jb);
    case 257: return occupancy<128, true>(jb);
    default: return -1;
  }
}

extern "C" const char* fs_error_string(int code) {
  if (code == -1) return "unsupported block size";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int fs_plus_times(const int* src, const int* dst,
                             const int* run_start, const int* chunk_start,
                             const int* chunk_run, int n_chunks,
                             const unsigned char* src_live,
                             const unsigned char* gate, int* arrivals,
                             float* partial, const float* d,
                             const float* base, const float* tiles,
                             float* out, float* node_un, float* p_sum, int j,
                             int jb, int bn_src, int bn_loc, int vb,
                             float tol, void* stream) {
  Args a = common_args(src, dst, run_start, chunk_start, chunk_run, n_chunks,
                       src_live, gate, arrivals, partial, d, j, jb, bn_src,
                       bn_loc);
  a.base = base;
  a.tiles = tiles;
  a.out = out;
  a.node_un = node_un;
  a.p_sum = p_sum;
  a.tol = tol;
  return dispatch<false>(a, vb, static_cast<cudaStream_t>(stream));
}

extern "C" int fs_min_plus(const int* src, const int* dst,
                           const int* run_start, const int* chunk_start,
                           const int* chunk_run, int n_chunks,
                           const unsigned char* src_live,
                           const unsigned char* gate, int* arrivals,
                           float* partial, const float* d,
                           const float* values, const float* dbase,
                           const float* tiles, float* vout, float* dout,
                           float* node_un, float* p_sum, int j, int jb,
                           int bn_src, int bn_loc, int vb, void* stream) {
  Args a = common_args(src, dst, run_start, chunk_start, chunk_run, n_chunks,
                       src_live, gate, arrivals, partial, d, j, jb, bn_src,
                       bn_loc);
  a.values = values;
  a.base = dbase;
  a.tiles = tiles;
  a.out = vout;
  a.dout = dout;
  a.node_un = node_un;
  a.p_sum = p_sum;
  return dispatch<true>(a, vb, static_cast<cudaStream_t>(stream));
}
