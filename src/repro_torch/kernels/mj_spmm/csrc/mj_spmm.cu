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
// Bound.  A call reads q*K tiles (q*K*Vb^2*4 bytes) and does 2*J*Vb^2
// operations per tile: at J=4 that is 2 operations per byte, far below
// the card's float32 ratio, so device-memory bytes bound it at every Vb.
// The design reads each tile once per pass of JR jobs, ceil(J/JR) times
// (once for any J <= JR = 8, so J = 4 and J = 7 read each tile once at
// every Vb), and keeps 96-192 KB of it in flight on each SM.
//
// 1. Jobs in registers.  A consumer thread owns UPT (tile, lane w)
//    units of a stage and carries the sums of up to JP jobs of each in
//    registers (JP = 4 for a pass of at most 4 jobs, else JR), so the
//    jobs no longer take threads: a pass is jb <= JR jobs (min(job_block,
//    JR); the wrapper's own choice is min(J, JR)) and the last pass of a
//    J that jb does not divide is partial.  The JP = 4 instance is 1.4-
//    3.3% faster than JR at J = 4 on Vb = 8 and 512 (an A/B on the card;
//    PERF.md), the common case of a view's four job slots.
// 2. Work items.  One item is (selected row i, a run of consecutive ELL
//    slots k, a pass).  Row i's tiles tiles[ti, k0:k0+nk] are one
//    contiguous block, and so are their outputs out[i, k0:k0+nk].  A run
//    is two stages of whole tiles up to Vb = 64 (128 tiles of 256 B at
//    Vb = 8 in a stage, 2 of 16 KB at 64) and one tile from Vb = 128 (a
//    tile is then 2 to 32 stages, slices of ROWS = rows(Vb) source
//    rows).  The item's d[i] rows (jn x Vb floats, contiguous) are
//    staged once per item into one of two d buffers.  The pass is the
//    fastest index of the item order, so the passes over a tile run side
//    by side and the second reads it from L2.
// 3. A TMA ring.  The grid is persistent (blocks = SMs x blocks an SM,
//    at most one per item); block b takes items b, b + grid, ...  Its
//    producer warp (one thread) walks the same items and cuts each run
//    into stages of SF floats (32 KB), each one 1-D bulk copy
//    (cp.async.bulk ... mbarrier::complete_tx) into one of NS ring
//    stages, after the consumers released the stage (empty barrier,
//    one arrival a consumer warp); the item's d rows go the same way
//    into d buffer (item count & 1).  The consumer warps wait on the
//    stage's full barrier, compute, release it, and store their outputs
//    once a tile's last slice is done.  Copies run NS stages ahead of
//    the compute, across item boundaries.
// 4. Stores.  out[i,k,j0+jj,w] for consecutive w sit at consecutive
//    addresses and a warp's 32 units are 32 consecutive lanes (from Vb =
//    32) or 32/Vb tiles' whole rows, so every store instruction writes
//    whole 32-byte sectors.  The same units make the tile loads of Vb = 8
//    and 16 4- and 2-way bank conflicts (the 32/Vb tiles' equal (row, w)
//    share a bank); from Vb = 32 they are conflict-free.
//
// Exact arithmetic.  Build without --use_fast_math: min-plus is an IEEE
// add then fminf from +inf, bit-equal to the plain version (min is exact
// in any order).  Plus-times accumulates fmaf from 0 in v order, one sum
// per output carried across slices, so it agrees with the plain version
// to rounding and a tile_index read is bit-equal to the gathered read.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int JR = 8;      // jobs a pass carries in registers, at most
constexpr int SF = 8192;   // floats a ring stage holds (32 KB)
constexpr int NS = 3;      // ring stages
constexpr int MAX_NC = 256;  // consumer threads a block, at most

// The geometry, mirrored by kernel.py.  Up to Vb = 64 a stage holds
// whole tiles; from 128 a slice of ROWS source rows of one tile.
__host__ __device__ constexpr int rows(int vb) {
  return vb * vb <= SF ? vb : SF / vb;
}
__host__ __device__ constexpr int tiles_per_stage(int vb) {
  return vb * vb <= SF ? SF / (vb * vb) : 1;
}
__host__ __device__ constexpr int consumers(int vb) {
  return tiles_per_stage(vb) * vb < MAX_NC ? tiles_per_stage(vb) * vb
                                           : MAX_NC;
}
__host__ __device__ constexpr int run_tiles(int vb) {
  return vb * vb <= SF ? 2 * tiles_per_stage(vb) : 1;
}
__host__ __device__ constexpr int job_pass(int jb) {
  return jb <= 4 ? 4 : JR;
}

// Shared memory of one thread block, in bytes: NS ring stages, two d
// buffers of [JP, Vb], then 2*NS + 4 mbarriers.
__host__ __device__ constexpr int smem_bytes_of(int jp, int vb) {
  return 4 * (NS * SF + 2 * jp * vb) + 8 * (2 * NS + 4);
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

struct Params {
  const float* d;          // [q, J, Vb]
  const float* tiles;      // [num_tiles, K, Vb, Vb]
  const int* tile_index;   // [q] or null (row i reads tiles[i])
  float* out;              // [q, K, J, Vb]
  int num_k, num_jobs, jb, num_tiles, runs, passes;
  long long items;         // q * runs * passes
};

// Work item n: row i, slots [k0, k0 + nk), jobs [j0, j0 + jn).
struct Item {
  int i, k0, nk, j0, jn;
};

template <int VB>
__device__ __forceinline__ Item item_of(const Params& p, long long n) {
  Item it;
  const int pass = static_cast<int>(n % p.passes);
  const long long rest = n / p.passes;
  const int c = static_cast<int>(rest % p.runs);
  it.i = static_cast<int>(rest / p.runs);
  it.k0 = c * run_tiles(VB);
  it.nk = min(run_tiles(VB), p.num_k - it.k0);
  it.j0 = pass * p.jb;
  it.jn = min(p.jb, p.num_jobs - it.j0);
  return it;
}

// The producer: one thread walks the block's items and fills the ring.
template <int VB, int JP>
__device__ void produce(const Params& p, float* ring, float* dbuf,
                        uint64_t* full, uint64_t* empty, uint64_t* dfull,
                        uint64_t* dempty) {
  int g = 0, cnt = 0;       // stage loads so far, items so far
  for (long long n = blockIdx.x; n < p.items; n += gridDim.x, ++cnt) {
    const Item it = item_of<VB>(p, n);
    const int db = cnt & 1;
    if (cnt >= 2) mbar_wait(&dempty[db], ((cnt >> 1) + 1) & 1);
    const uint32_t dbytes = 4u * it.jn * VB;
    mbar_expect_tx(&dfull[db], dbytes);
    bulk_load(dbuf + db * JP * VB,
              p.d + (static_cast<size_t>(it.i) * p.num_jobs + it.j0) * VB,
              dbytes, &dfull[db]);
    int ti = it.i;
    if (p.tile_index != nullptr)
      ti = min(max(p.tile_index[it.i], 0), p.num_tiles - 1);
    const float* src =
        p.tiles + (static_cast<size_t>(ti) * p.num_k + it.k0) * VB * VB;
    const int total = it.nk * VB * VB;       // the run's floats
    for (int off = 0; off < total; off += SF, ++g) {
      const int st = g % NS;
      if (g >= NS) mbar_wait(&empty[st], ((g / NS) + 1) & 1);
      const uint32_t bytes = 4u * min(SF, total - off);
      mbar_expect_tx(&full[st], bytes);
      bulk_load(ring + st * SF, src + off, bytes, &full[st]);
    }
  }
}

// One stage's products: UPT units (tile tt, lane w) of this thread, v
// over the stage's ROWS source rows (d lanes from `ds`), JP jobs each.
template <int VB, int JP, bool MIN, int UPT>
__device__ __forceinline__ void stage_products(const float* ts,
                                               const float* ds,
                                               float (&acc)[UPT][JP],
                                               int tid) {
  constexpr int ROWS = rows(VB), NC = consumers(VB);
  const float* t[UPT];
#pragma unroll
  for (int r = 0; r < UPT; ++r) {
    const int u = tid + r * NC;
    t[r] = ts + (u / VB) * ROWS * VB + u % VB;
  }
  const float4* d4 = reinterpret_cast<const float4*>(ds);
#pragma unroll 2
  for (int v4 = 0; v4 < ROWS / 4; ++v4) {
    float4 dv[JP];
#pragma unroll
    for (int j = 0; j < JP; ++j) dv[j] = d4[j * (VB / 4) + v4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int r = 0; r < UPT; ++r) {
        const float x = t[r][(4 * v4 + rr) * VB];
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          const float dj = rr == 0 ? dv[j].x
                         : rr == 1 ? dv[j].y
                         : rr == 2 ? dv[j].z : dv[j].w;
          if constexpr (MIN) {
            acc[r][j] = fminf(acc[r][j], __fadd_rn(dj, x));
          } else {
            acc[r][j] = fmaf(dj, x, acc[r][j]);
          }
        }
      }
    }
  }
}

template <int VB, int JP, bool MIN>
__global__ void __launch_bounds__(consumers(VB) + 32, 2)
    mj_spmm_kernel(const Params p) {
  constexpr int ROWS = rows(VB), NSL = VB / ROWS, TPS = tiles_per_stage(VB);
  constexpr int NC = consumers(VB), NCW = NC / 32, UPT = TPS * VB / NC;
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;                                 // [NS][SF]
  float* dbuf = ring + NS * SF;                       // [2][JP*VB]
  uint64_t* full = reinterpret_cast<uint64_t*>(dbuf + 2 * JP * VB);
  uint64_t* empty = full + NS;
  uint64_t* dfull = empty + NS;
  uint64_t* dempty = dfull + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCW);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&dfull[b], 1);
      mbar_init(&dempty[b], NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == NCW) {                                  // the producer warp
    if (lane == 0) produce<VB, JP>(p, ring, dbuf, full, empty, dfull, dempty);
    return;
  }

  float acc[UPT][JP];
  int g = 0, cnt = 0;
  for (long long n = blockIdx.x; n < p.items; n += gridDim.x, ++cnt) {
    const Item it = item_of<VB>(p, n);
    const int db = cnt & 1;
    mbar_wait(&dfull[db], (cnt >> 1) & 1);
    const float* ds = dbuf + db * JP * VB;
    const int nst = NSL == 1 ? (it.nk + TPS - 1) / TPS : it.nk * NSL;
    for (int s = 0; s < nst; ++s, ++g) {
      const int st = g % NS, sl = s % NSL;
      if (sl == 0) {
#pragma unroll
        for (int r = 0; r < UPT; ++r)
#pragma unroll
          for (int j = 0; j < JP; ++j) acc[r][j] = MIN ? INFINITY : 0.f;
      }
      mbar_wait(&full[st], (g / NS) & 1);
      stage_products<VB, JP, MIN, UPT>(ring + st * SF, ds + sl * ROWS, acc,
                                       tid);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (sl == NSL - 1) {                  // a tile's last rows: store
        const int kt = it.k0 + (NSL == 1 ? s * TPS : s / NSL);
        const int nt = NSL == 1 ? min(TPS, it.k0 + it.nk - kt) : 1;
#pragma unroll
        for (int r = 0; r < UPT; ++r) {
          const int u = tid + r * NC, tt = u / VB, w = u % VB;
          if (tt >= nt) continue;           // past a partial stage's tiles
          float* o = p.out + ((static_cast<size_t>(it.i) * p.num_k + kt +
                               tt) * p.num_jobs + it.j0) * VB + w;
#pragma unroll
          for (int j = 0; j < JP; ++j)
            if (j < it.jn) o[static_cast<size_t>(j) * VB] = acc[r][j];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&dempty[db]);
  }
}

constexpr int MAX_DEVICES = 64;

// Lets the kernel take its dynamic shared memory on the current device,
// as every launch must first.
template <int VB, int JP, bool MIN>
cudaError_t allow_smem() {
  const int smem = smem_bytes_of(JP, VB);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(mj_spmm_kernel<VB, JP, MIN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// Blocks of the kernel one SM holds (less than 0: a cudaError_t, negated).
template <int VB, int JP, bool MIN>
int blocks_per_sm() {
  cudaError_t e = allow_smem<VB, JP, MIN>();
  if (e != cudaSuccess) return -static_cast<int>(e);
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, mj_spmm_kernel<VB, JP, MIN>, consumers(VB) + 32,
      smem_bytes_of(JP, VB));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// The persistent grid's size on the current device, SMs x blocks an SM
// (queried once a device), into *cap.  Returns 0, a cudaError_t, or -2
// when not one block fits an SM.
template <int VB, int JP, bool MIN>
int grid_cap(int* cap) {
  static int caps[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES && caps[dev] > 0) {
    *cap = caps[dev];
    return static_cast<int>(allow_smem<VB, JP, MIN>());
  }
  const int per_sm = blocks_per_sm<VB, JP, MIN>();
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0) return -2;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  *cap = sms * per_sm;
  if (dev < MAX_DEVICES) caps[dev] = *cap;
  return 0;
}

template <int VB, int JP, bool MIN>
int launch(Params p, int q, cudaStream_t stream) {
  int cap = 0;
  const int rc = grid_cap<VB, JP, MIN>(&cap);
  if (rc != 0) return rc;
  p.runs = (p.num_k + run_tiles(VB) - 1) / run_tiles(VB);
  p.passes = (p.num_jobs + p.jb - 1) / p.jb;
  p.items = static_cast<long long>(q) * p.runs * p.passes;
  const long long grid = p.items < cap ? p.items : cap;
  mj_spmm_kernel<VB, JP, MIN><<<static_cast<unsigned>(grid),
                                consumers(VB) + 32,
                                smem_bytes_of(JP, VB), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Every Vb the kernel is instantiated for (kernel.py SUPPORTED_VB).
#define MS_FOR_EACH_VB(X) X(8) X(16) X(32) X(64) X(128) X(256) X(512)

template <int JP, bool MIN>
int dispatch(const Params& p, int q, int vb, cudaStream_t s) {
  switch (vb) {
#define MS_CASE(V) \
  case V: return launch<V, JP, MIN>(p, q, s);
    MS_FOR_EACH_VB(MS_CASE)
#undef MS_CASE
    default: return -1;
  }
}

template <int JP, bool MIN>
int occupancy(int vb) {
  switch (vb) {
#define MS_CASE(V) \
  case V: return blocks_per_sm<V, JP, MIN>();
    MS_FOR_EACH_VB(MS_CASE)
#undef MS_CASE
    default: return -1;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the cudaError_t of the
// launch (0 on success); -1 for an unsupported Vb, -2 when not one block
// fits an SM, -3 for a pass jb outside [1, JR].

// The geometry of a pass of jb jobs at `vb` into g[0..6]: rows a stage
// holds of a tile, tiles a stage, consumer threads, units a consumer
// thread, slots a run, jobs the instance carries (JP), shared memory
// bytes.  Returns -1 for an unsupported Vb, -3 for jb outside [1, JR].
extern "C" int ms_geometry(int jb, int vb, int* g) {
  switch (vb) {
#define MS_CASE(V) case V:
    MS_FOR_EACH_VB(MS_CASE)
#undef MS_CASE
      break;
    default: return -1;
  }
  if (jb < 1 || jb > JR) return -3;
  g[0] = rows(vb);
  g[1] = tiles_per_stage(vb);
  g[2] = consumers(vb);
  g[3] = tiles_per_stage(vb) * vb / consumers(vb);
  g[4] = run_tiles(vb);
  g[5] = job_pass(jb);
  g[6] = smem_bytes_of(job_pass(jb), vb);
  return 0;
}

extern "C" int ms_blocks_per_sm(int jb, int vb, int min_plus) {
  const bool four = job_pass(jb) == 4;
  if (min_plus)
    return four ? occupancy<4, true>(vb) : occupancy<JR, true>(vb);
  return four ? occupancy<4, false>(vb) : occupancy<JR, false>(vb);
}

extern "C" const char* ms_error_string(int code) {
  if (code == -1) return "unsupported block size";
  if (code == -2) return "no thread block fits an SM";
  if (code == -3) return "a pass of no jobs or of more than JR";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int ms_mj_spmm(const float* d, const float* tiles,
                          const int* tile_index, float* out, int q,
                          int num_k, int num_jobs, int jb, int num_tiles,
                          int vb, int min_plus, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{};
  p.d = d;
  p.tiles = tiles;
  p.tile_index = tile_index;
  p.out = out;
  p.num_k = num_k;
  p.num_jobs = num_jobs;
  p.jb = jb;
  p.num_tiles = num_tiles;
  if (jb < 1 || jb > JR) return -3;
  const bool four = job_pass(jb) == 4;
  if (min_plus)
    return four ? dispatch<4, true>(p, q, vb, s)
                : dispatch<JR, true>(p, q, vb, s);
  return four ? dispatch<4, false>(p, q, vb, s)
              : dispatch<JR, false>(p, q, vb, s);
}
