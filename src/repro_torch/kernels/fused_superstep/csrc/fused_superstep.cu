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
// Bound.  A call moves the [Vb, Vb] tile of every LIVE pair (source
// selected) and the d rows of its live jobs, and does 2*Vb^2 operations a
// live pair and live job.  At a few jobs that is bound by device-memory
// bytes; at the tens of jobs a view holds, by the shared-memory reads and
// the arithmetic of each staging.  The design answers both in five parts.
//
// 1. Work items.  An item is (chunk, sub-item): a chunk is at most C
//    consecutive pairs of one run (`chunk_start`, `chunk_run`, built on
//    the host), and when a call has fewer chunks than the card has SMs
//    the host splits each chunk's live pairs into `split` shares (item =
//    chunk * split + share), so every SM gets an item.  An item whose run
//    has one item flushes directly.  Otherwise each item writes its
//    partial (plus-times sum, min-plus candidate) of every live job to
//    `partial [n_items, J, Vb]` (L2-resident), fences and counts itself in
//    at the run's arrival counter; the last to arrive combines the run's
//    partials in item order (base + part_0 + part_1 + ..., or fminf,
//    which is order-free), flushes and sets the counter back to 0, so no
//    memset launch is needed.  The result does not depend on which item
//    is last: two calls on the same inputs are bit-identical.
// 2. Live jobs, packed.  `job_live [J]` (null: all live) marks the jobs
//    with a live row: a job without one contributes the semiring
//    identity, so skipping it is exact.  A first kernel packs the live
//    jobs' d rows of the live sources source-major, [bn_src][NSL][J][RS]
//    (slot k = the k-th live job), so the rows of a pass at one (source,
//    slice) are one contiguous block: one copy a stage, not one a job.  A
//    dead job costs no byte and no arithmetic: the first item of each run
//    writes its base through (min-plus: values and base) and flushes it.
// 3. Jobs in registers, in passes.  A thread owns one lane w of JR jobs
//    (1, or JW(Vb) in blocks of 4) and a thread block holds `groups`
//    groups of Vb threads: a pass is PJ = JR * groups live jobs.  The
//    host's table picks JR = 1 (a thread a (job, lane)) where the view's J
//    jobs fit 1024 threads, else JW; each is its own kernel instance, with
//    its own registers.  An item walks ceil(live / PJ) passes and streams
//    its live pairs once a pass, so each live tile is staged that many
//    times (`counts[0]` adds live pairs x passes); a call with no live job
//    stages nothing.  A group past the pass's live jobs skips the
//    arithmetic, and a thread only computes its live blocks of 4 jobs.
// 4. A TMA ring.  A pair's tile is contiguous and row-major by source
//    lane, so a slice of RS = rows(Vb) source rows is one contiguous
//    block of RS*Vb floats: thread 0 issues it as one 1-D bulk copy
//    (cp.async.bulk ... mbarrier::complete_tx) into one of NS stages,
//    with the pass's packed d rows of its source (one more copy) on the
//    same mbarrier.  Up to Vb = 128 a slice is the whole tile (RS = Vb);
//    from Vb = 256 a tile (256 KB, 1 MB) takes Vb/RS stages of 32 KB.
//    Every warp waits on the stage's full barrier, releases it on its
//    empty barrier, and thread 0 refills it NS slices ahead.  A thread
//    sums a pair's slices in source-lane order into one partial before it
//    meets the pair's other partials, so the order of every sum is the
//    whole-tile design's at any RS and any JR.
// 5. Live pairs only.  `src_live [bn_src]` (null: all live) marks the
//    selected source blocks.  Each item compacts its chunk's live pairs
//    into shared memory (ballot + prefix, WINDOW pairs per pass) and
//    stages only its share of them.  The caller's d rows of unselected
//    sources are the semiring identity, so skipping them is exact
//    (min-plus bitwise, plus-times up to the sign of a zero).  An item
//    with no live pair still writes its identity partial and arrives.
// A device gate.  `gate` (null: open) is a device bool read at entry of
// both kernels: when false every block returns before any load and the
// outputs are left undefined (the device driver discards them).
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

// Source rows of a tile that one stage holds: the whole tile up to Vb =
// 128, a 32 KB slice above.
__host__ __device__ constexpr int rows(int vb) {
  return vb >= 256 ? 8192 / vb : vb;
}

// Jobs a thread carries in the many-jobs layout (JW), in blocks of 4: 12
// from Vb = 256, where a pair's sum over its slices needs registers of
// its own (20 spilled and ran J = 4 8% slower on the H100).
__host__ __device__ constexpr int wide_jobs(int vb) {
  return vb >= 256 ? 12 : 8;
}

// Warps of one Vb-lane row (a row's flush sums over them).
__host__ __device__ constexpr int row_warps(int vb) {
  return vb >= 32 ? vb / 32 : 1;
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

// Append the jobs q < j whose live flag equals `want` to jid[n, ...), in
// order; returns the new count to every thread.  Every thread of the
// block calls it.
__device__ int list_jobs(const unsigned char* __restrict__ job_live, int j,
                         bool want, int* jid, int* wcnt, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  for (int q0 = 0; q0 < j; q0 += nt) {
    const int q = q0 + tid;
    const bool ok =
        q < j && (job_live == nullptr || job_live[q] != 0) == want;
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) wcnt[warp] = __popc(m);
    __syncthreads();
    int off = n, tot = 0;
    for (int k = 0; k < nwarps; ++k) {
      off += k < warp ? wcnt[k] : 0;
      tot += wcnt[k];
    }
    if (ok) jid[off + __popc(m & ((1u << lane) - 1u))] = q;
    n += tot;
    __syncthreads();
  }
  return n;
}

// jid[0, n) <- the live jobs in order, jid[n, j) <- the others in order;
// returns n, the live count.
__device__ int live_jobs(const unsigned char* __restrict__ job_live, int j,
                         int* jid, int* wcnt) {
  const int n = list_jobs(job_live, j, true, jid, wcnt, 0);
  if (n < j) list_jobs(job_live, j, false, jid, wcnt, n);
  return n;
}

// Pack the live jobs' d rows of the live sources, source-major:
// d_pack[((s * NSL + sl) * J + k) * RS + r] = d[jid[k], s, sl * RS + r].
// Dynamic shared memory: 32 + J ints.
template <int VB>
__global__ void superstep_kernel_pack(const float* __restrict__ d,
                                      float* __restrict__ d_pack,
                                      const unsigned char* job_live,
                                      const unsigned char* src_live,
                                      const unsigned char* gate, int j,
                                      int bn_src) {
  if (gate != nullptr && *gate == 0) return;
  constexpr int RS = rows(VB), NSL = VB / RS, V4 = VB / 4;
  extern __shared__ int sm_pack[];
  int* wcnt = sm_pack;
  int* jid = sm_pack + 32;
  const int n = live_jobs(job_live, j, jid, wcnt);
  const long long total = static_cast<long long>(bn_src) * n * V4;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += step) {
    const int v = 4 * static_cast<int>(e % V4);
    const long long rest = e / V4;
    const int k = static_cast<int>(rest % n);
    const int s = static_cast<int>(rest / n);
    if (src_live != nullptr && src_live[s] == 0) continue;
    const float4 x = *reinterpret_cast<const float4*>(
        d + (static_cast<size_t>(jid[k]) * bn_src + s) * VB + v);
    *reinterpret_cast<float4*>(
        d_pack + ((static_cast<size_t>(s) * NSL + v / RS) * j + k) * RS +
        v % RS) = x;
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
  const unsigned char* job_live;  // [J] or null (all live)
  const unsigned char* gate;      // 0-dim device bool or null (open)
  unsigned long long* counts;     // [2] (stagings, jobs skipped) or null
  int* arrivals;             // [R], zero between calls
  float* partial;            // [n_chunks * split, J, Vb] scratch
  const float* d;            // [J, bn_src, Vb]
  float* d_pack;             // [bn_src, NSL, J, RS] scratch
  const float* base;         // [J, bn_loc, Vb]  plus: base; min: dbase
  const float* values;       // [J, bn_loc, Vb]  min-plus only
  const float* tiles;        // [P, Vb, Vb]
  float* out;                // plus: out; min: values out
  float* dout;               // min-plus: deltas out
  float* node_un;            // [J, bn_loc]
  float* p_sum;              // [J, bn_loc]
  int j, jr, groups, ns, split, bn_src, bn_loc;
  float tol;
};

// Shared memory of one thread block, in bytes (mirrored by kernel.py):
// 2*NS mbarriers, NS stages of an [RS, VB] tile slice and [PJ, RS] packed
// d rows, the flush's per-warp sums of PJ rows, the live-pair list (pair
// and source), per-warp counts, four ints, then the J job ids.
__host__ __device__ constexpr int smem_bytes_of(int vb, int j, int jr,
                                                int groups, int ns) {
  return 16 * ns +
         4 * (ns * (rows(vb) * vb + jr * groups * rows(vb)) +
              2 * jr * groups * row_warps(vb) + 2 * WINDOW + 32 + 4 + j);
}

// The flush of one job's row: sum (un, pr) over the VB lanes of the
// thread's group (a warp's lanes by shuffles); up to Vb = 32 lane 0 of the
// group writes them for `job`, above each warp's lane 0 puts its sums at
// red[slot] for `rows_finish`.  Every lane of the warp calls it.
template <int VB>
__device__ __forceinline__ void row_sums(float un, float pr, int w, int slot,
                                         bool valid, int job, int b,
                                         int bn_loc, float* red,
                                         float* node_un, float* p_sum) {
  constexpr int W = VB < 32 ? VB : 32;
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    un += __shfl_xor_sync(0xffffffffu, un, off);
    pr += __shfl_xor_sync(0xffffffffu, pr, off);
  }
  if constexpr (VB <= 32) {
    if (valid && w == 0) {
      const size_t pb = static_cast<size_t>(job) * bn_loc + b;
      node_un[pb] = un;
      p_sum[pb] = pr;
    }
  } else {
    constexpr int NW = VB / 32;
    if (valid && (w & 31) == 0) {
      red[(slot * NW + (w >> 5)) * 2] = un;
      red[(slot * NW + (w >> 5)) * 2 + 1] = pr;
    }
  }
}

// Above Vb = 32, the flush's last step for a group's njr jobs mine[0..]
// (slots gi * JR + jj of `red`): thread w < njr of the group sums job w's
// per-warp sums in warp order and writes them.  Every thread of the block
// calls it.
template <int VB, int JR>
__device__ __forceinline__ void rows_finish(int gi, int w, int njr,
                                            const int* mine, int b,
                                            int bn_loc, const float* red,
                                            float* node_un, float* p_sum) {
  if constexpr (VB > 32) {
    constexpr int NW = VB / 32;
    __syncthreads();
    if (w < njr) {        // VB > 32 >= JR: one thread a job
      float u = 0.f, s = 0.f;
      for (int k = 0; k < NW; ++k) {
        u += red[((gi * JR + w) * NW + k) * 2];
        s += red[((gi * JR + w) * NW + k) * 2 + 1];
      }
      const size_t pb = static_cast<size_t>(mine[w]) * bn_loc + b;
      node_un[pb] = u;
      p_sum[pb] = s;
    }
    __syncthreads();
  }
}

// The state update of one (job, lane) from its combined value `acc`:
// writes the outputs at o and returns (un, pr).
template <bool MIN>
__device__ __forceinline__ void finalize(const Args& a, size_t o, float acc,
                                         float& un, float& pr) {
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

// One stage's products for a thread's JR jobs: v over the stage's RS
// source rows of lane w (`t` = the stage's tile + w), the jobs' packed d
// rows at `dr` ([JR][RS]), `nb` live blocks of JB jobs.
template <int VB, bool MIN, int JR>
__device__ __forceinline__ void stage_products(const float* t,
                                               const float* dr,
                                               float (&part)[JR], int nb) {
  constexpr int RS = rows(VB), JB = JR < 4 ? JR : 4, NB = JR / JB;
  const float4* d4 = reinterpret_cast<const float4*>(dr);
#pragma unroll
  for (int v4 = 0; v4 < RS / 4; ++v4) {
    const float* tv = t + 4 * v4 * VB;
    const float x0 = tv[0], x1 = tv[VB], x2 = tv[2 * VB], x3 = tv[3 * VB];
#pragma unroll
    for (int bk = 0; bk < NB; ++bk) {
      if (bk < nb) {
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          const int q = bk * JB + jj;
          const float4 dv = d4[q * (RS / 4) + v4];
          if constexpr (MIN) {
            part[q] = fminf(part[q], __fadd_rn(dv.x, x0));
            part[q] = fminf(part[q], __fadd_rn(dv.y, x1));
            part[q] = fminf(part[q], __fadd_rn(dv.z, x2));
            part[q] = fminf(part[q], __fadd_rn(dv.w, x3));
          } else {
            part[q] = fmaf(dv.x, x0, part[q]);
            part[q] = fmaf(dv.y, x1, part[q]);
            part[q] = fmaf(dv.z, x2, part[q]);
            part[q] = fmaf(dv.w, x3, part[q]);
          }
        }
      }
    }
  }
}

// The block's shared memory, carved (see smem_bytes_of).
struct Smem {
  uint64_t* full;
  uint64_t* empty;
  float* tile_s;   // [NS][RS*VB]
  float* d_s;      // [NS][PJ][RS]
  float* red;      // [PJ][NW][2]
  int* list_p;     // [WINDOW]
  int* list_s;     // [WINDOW]
  int* wcnt;       // [32]
  int* misc;       // [4]
  int* jid;        // [J]: live jobs, then the others
};

// A stage load into ring stage st: slice `sl` (source rows sl*RS to
// sl*RS + RS) of pair p, source s, with the pass's npj packed d rows
// (packed slots k0..k0+npj) of the same rows.  First waits, where `wait`,
// until every warp has released the stage's previous load (empty phase
// `parity`).  Every copy is a multiple of 16 bytes at a 16-byte aligned
// address (RS >= 8).  Thread 0 only.
template <int VB>
__device__ __forceinline__ void issue_load(const Args& a, const Smem& sm,
                                           int pj, int st, bool wait,
                                           uint32_t parity, int p, int s,
                                           int sl, int k0, int npj) {
  constexpr int RS = rows(VB), NSL = VB / RS;
  constexpr uint32_t slice_bytes = RS * VB * 4, row_bytes = RS * 4;
  if (wait) mbar_wait(&sm.empty[st], parity);
  mbar_expect_tx(&sm.full[st], slice_bytes + npj * row_bytes);
  bulk_load(sm.tile_s + static_cast<size_t>(st) * RS * VB,
            a.tiles + (static_cast<size_t>(p) * VB + sl * RS) * VB,
            slice_bytes, &sm.full[st]);
  bulk_load(sm.d_s + static_cast<size_t>(st) * pj * RS,
            a.d_pack + ((static_cast<size_t>(s) * NSL + sl) * a.j + k0) * RS,
            npj * row_bytes, &sm.full[st]);
}

// A thread's jobs of a pass of npj live jobs, `per` a group, group gi
// from pass slot gi * per; returns how many (0 past the pass).  Min-plus,
// bound by its arithmetic, spreads the pass's jobs evenly over the groups
// in whole blocks of JB, so every group works; plus-times fills the
// groups in turn, JR each (the fixed stride ran 6-14% faster on the
// H100, PERF.md).
template <int JR, bool MIN>
__device__ __forceinline__ int my_jobs(int npj, int groups, int gi,
                                       int& per) {
  constexpr int JB = JR < 4 ? JR : 4;
  per = MIN ? ((npj + groups - 1) / groups + JB - 1) / JB * JB : JR;
  return gi < groups ? max(0, min(per, npj - gi * per)) : 0;
}

// The item's live pairs, pass by pass, for JR jobs a thread.
template <int VB, bool MIN, int JR>
__device__ void walk(const Args& a, const Smem& sm, int n_live, int c,
                     int sub, int r, int b, int p0, int p1, bool single) {
  constexpr int RS = rows(VB), NSL = VB / RS, JB = JR < 4 ? JR : 4;
  constexpr float IDENT = MIN ? INFINITY : 0.f;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int gi = tid / VB, w = tid % VB;
  const int pj = JR * a.groups;
  const int n_pass = (n_live + pj - 1) / pj;
  const int item = c * a.split + sub;
  float acc[JR];  // the thread's jobs' running sums
  int g = 0;             // stage loads so far, across windows and passes
  int st = 0;            // g's ring stage, g % NS
  uint32_t ph = 0;       // g's full phase, (g / NS) & 1
  int n_item = 0;        // the item's live pairs
  for (int pass = 0; pass < n_pass; ++pass) {
    const int k0 = pass * pj, npj = min(pj, n_live - k0);
    const int* jobs = sm.jid + k0;
    int per;
    const int njr = my_jobs<JR, MIN>(npj, a.groups, gi, per);
    const int* mine = jobs + gi * per;
    const int nb = (njr + JB - 1) / JB;
#pragma unroll
    for (int jj = 0; jj < JR; ++jj) {
      float x = IDENT;
      if (!MIN && single && jj < njr)   // one item: start from base
        x = a.base[(static_cast<size_t>(mine[jj]) * a.bn_loc + b) * VB + w];
      acc[jj] = x;
    }
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
        if (lane == 0) sm.wcnt[warp] = __popc(m);
        __syncthreads();
        int off = n, tot = 0;
        for (int k = 0; k < nwarps; ++k) {
          const int cnt = sm.wcnt[k];
          off += k < warp ? cnt : 0;
          tot += cnt;
        }
        if (ok) {
          const int i = off + __popc(m & ((1u << lane) - 1u));
          sm.list_p[i] = p;
          sm.list_s[i] = s;
        }
        n += tot;
        __syncthreads();
      }
      // this item's share of them
      const int i0 = n * sub / a.split, i1 = n * (sub + 1) / a.split;
      if (pass == 0) n_item += i1 - i0;
      const int nl = (i1 - i0) * NSL;   // the window's stage loads
      if (tid == 0)                     // fill the ring
        for (int l = 0; l < nl && l < a.ns; ++l)
          issue_load<VB>(a, sm, pj, (g + l) % a.ns, g + l >= a.ns,
                         (((g + l) / a.ns) + 1) & 1,
                         sm.list_p[i0 + l / NSL], sm.list_s[i0 + l / NSL],
                         l % NSL, k0, npj);
      // plus-times sums a pair's slices apart before the pair meets its
      // other partials; min is order-free and folds straight into acc
      float part[MIN ? 1 : JR];
      for (int l = 0; l < nl; ++l, ++g) {
        const int sl = l % NSL;
        mbar_wait(&sm.full[st], ph);
        if (nb > 0) {
          const float* t = sm.tile_s + static_cast<size_t>(st) * RS * VB + w;
          const float* dr =
              sm.d_s + (static_cast<size_t>(st) * pj + gi * per) * RS;
          if constexpr (MIN) {
            stage_products<VB, MIN, JR>(t, dr, acc, nb);
          } else {
            if (sl == 0) {
#pragma unroll
              for (int jj = 0; jj < JR; ++jj) part[jj] = 0.f;
            }
            stage_products<VB, MIN, JR>(t, dr, part, nb);
            if (sl == NSL - 1) {
#pragma unroll
              for (int jj = 0; jj < JR; ++jj) acc[jj] += part[jj];
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[st]);
        if (tid == 0 && l + a.ns < nl) {    // load g + NS, the same stage
          const int i = i0 + (l + a.ns) / NSL;
          issue_load<VB>(a, sm, pj, st, true, ph, sm.list_p[i],
                         sm.list_s[i], (l + a.ns) % NSL, k0, npj);
        }
        if (++st == a.ns) {
          st = 0;
          ph ^= 1u;
        }
      }
    }
    if (single) {
#pragma unroll
      for (int jj = 0; jj < JR; ++jj) {
        float un = 0.f, pr = 0.f;
        const int job = jj < njr ? mine[jj] : 0;
        if (jj < njr)
          finalize<MIN>(a, (static_cast<size_t>(job) * a.bn_loc + b) * VB + w,
                        acc[jj], un, pr);
        row_sums<VB>(un, pr, w, gi * JR + jj, jj < njr, job, b, a.bn_loc,
                     sm.red, a.node_un, a.p_sum);
      }
      rows_finish<VB, JR>(gi, w, njr, mine, b, a.bn_loc, sm.red, a.node_un,
                          a.p_sum);
    } else {
#pragma unroll
      for (int jj = 0; jj < JR; ++jj)
        if (jj < njr)
          a.partial[(static_cast<size_t>(item) * a.j + mine[jj]) * VB + w] =
              acc[jj];
    }
  }
  if (tid == 0 && a.counts != nullptr && n_item > 0)
    atomicAdd(&a.counts[0],
              static_cast<unsigned long long>(n_item) * n_pass);
  if (single) return;

  // count in at the run's counter; the last item to arrive combines
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = a.arrivals + r;
    const int n_items = (sm.misc[2] - sm.misc[1]) * a.split;
    const int last = atomicAdd(cnt, 1) == n_items - 1;
    if (last) *cnt = 0;                  // ready for the next call
    sm.misc[0] = last;
  }
  __syncthreads();
  if (!sm.misc[0]) return;
  __threadfence();
  const int it0 = sm.misc[1] * a.split, it1 = sm.misc[2] * a.split;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int k0 = pass * pj, npj = min(pj, n_live - k0);
    int per;
    const int njr = my_jobs<JR, MIN>(npj, a.groups, gi, per);
    const int* mine = sm.jid + k0 + gi * per;
#pragma unroll
    for (int jj = 0; jj < JR; ++jj) {
      float un = 0.f, pr = 0.f;
      const int job = jj < njr ? mine[jj] : 0;
      if (jj < njr) {
        const size_t o = (static_cast<size_t>(job) * a.bn_loc + b) * VB + w;
        float v = MIN ? INFINITY : a.base[o];
#pragma unroll 4
        for (int k = it0; k < it1; ++k) {
          const float pk = __ldcg(a.partial +
                                  (static_cast<size_t>(k) * a.j + job) * VB +
                                  w);
          if constexpr (MIN) v = fminf(v, pk);
          else v += pk;
        }
        finalize<MIN>(a, o, v, un, pr);
      }
      row_sums<VB>(un, pr, w, gi * JR + jj, jj < njr, job, b, a.bn_loc,
                   sm.red, a.node_un, a.p_sum);
    }
    rows_finish<VB, JR>(gi, w, njr, mine, b, a.bn_loc, sm.red, a.node_un,
                        a.p_sum);
  }
}

// The dead jobs of run b (jid[n_live, J)) written through from base
// (min-plus: values and base) and flushed, `groups` rows at a time.
template <int VB, bool MIN>
__device__ void dead_through(const Args& a, const Smem& sm, int n_live,
                             int b) {
  const int tid = threadIdx.x;
  const int gi = tid / VB, w = tid % VB;
  const int n_dead = a.j - n_live;
  for (int q0 = 0; q0 < n_dead; q0 += a.groups) {
    const int* jobs = sm.jid + n_live + q0;
    const int nj = gi < a.groups && q0 + gi < n_dead ? 1 : 0;
    const int job = nj ? jobs[gi] : 0;
    float un = 0.f, pr = 0.f;
    if (nj) {
      const size_t o = (static_cast<size_t>(job) * a.bn_loc + b) * VB + w;
      const float x = a.base[o];
      if constexpr (MIN) {
        a.out[o] = a.values[o];
        a.dout[o] = x;
        pr = isfinite(x) ? __fdiv_rn(1.0f, __fadd_rn(1.0f, x)) : 0.f;
      } else {
        a.out[o] = x;
        pr = fabsf(x) >= a.tol ? fabsf(x) : 0.f;
      }
      un = pr > 0.f ? 1.f : 0.f;
    }
    row_sums<VB>(un, pr, w, gi, nj != 0, job, b, a.bn_loc, sm.red,
                 a.node_un, a.p_sum);
    rows_finish<VB, 1>(gi, w, nj, jobs + gi, b, a.bn_loc, sm.red,
                       a.node_un, a.p_sum);
  }
}

// One instance a (Vb, semiring, jobs a thread): JR = 1 and JR = JW
// apart, so the one-job-a-thread layout keeps its own registers (sharing
// them with JW's cost the J = 4 calls 5-10% on the H100).  At most 1024
// threads, and one block an SM is enough: ptxas may then use up to 64
// registers a thread.  Without the second bound it holds the plus-times
// kernel to 32 and spills (3% slower at Vb = 64 on the H100).
template <int VB, bool MIN, int JR>
__global__ void __launch_bounds__(1024, 1) superstep_kernel(const Args a) {
  if (a.gate != nullptr && *a.gate == 0) return;   // gated: no load at all
  constexpr int RS = rows(VB);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pj = JR * a.groups, ns = a.ns;
  Smem sm;
  sm.full = reinterpret_cast<uint64_t*>(smem_raw);
  sm.empty = sm.full + ns;
  sm.tile_s = reinterpret_cast<float*>(sm.empty + ns);
  sm.d_s = sm.tile_s + static_cast<size_t>(ns) * RS * VB;
  sm.red = sm.d_s + static_cast<size_t>(ns) * pj * RS;
  sm.list_p = reinterpret_cast<int*>(sm.red + 2 * pj * row_warps(VB));
  sm.list_s = sm.list_p + WINDOW;
  sm.wcnt = sm.list_s + WINDOW;
  sm.misc = sm.wcnt + 32;
  sm.jid = sm.misc + 4;

  const int tid = threadIdx.x, nwarps = blockDim.x >> 5;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_live = live_jobs(a.job_live, a.j, sm.jid, sm.wcnt);
  if (blockIdx.x == 0 && tid == 0 && a.counts != nullptr && n_live < a.j)
    atomicAdd(&a.counts[1], static_cast<unsigned long long>(a.j - n_live));
  const int c = blockIdx.x / a.split, sub = blockIdx.x % a.split;
  const int r = a.chunk_run[c];
  const int r0 = a.run_start[r], r1 = a.run_start[r + 1];
  const int b = a.dst[r0];
  if (b < 0 || b >= a.bn_loc) return;               // dropped run
  const int p0 = a.chunk_start[c], p1 = a.chunk_start[c + 1];
  const bool single = a.split == 1 && p0 == r0 && p1 == r1;

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], nwarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!single && warp == nwarps - 1) {   // the run's chunks, for the flush
    int lo, hi;
    run_chunks(a.chunk_run, a.n_chunks, c, r, lane, lo, hi);
    if (lane == 0) {
      sm.misc[1] = lo;
      sm.misc[2] = hi;
    }
  }
  __syncthreads();
  if (sub == 0 && p0 == r0) dead_through<VB, MIN>(a, sm, n_live, b);
  if (n_live == 0) return;
  walk<VB, MIN, JR>(a, sm, n_live, c, sub, r, b, p0, p1, single);
}

inline int threads_for(int groups, int vb) {
  return (groups * vb + 31) / 32 * 32;
}

// The blocks of the pack kernel: enough to cover every (source, job, 4
// lanes) once, at most 4 an SM.
inline int pack_grid(int j, int bn_src, int vb) {
  static int cached[64] = {};
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    if (dev < 64 && cached[dev] > 0) {
      sms = cached[dev];
    } else if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev) == cudaSuccess && dev < 64) {
      cached[dev] = sms;
    }
  }
  const long long work = static_cast<long long>(bn_src) * j * (vb / 4);
  const long long blocks = (work + 255) / 256;
  return static_cast<int>(blocks < 4LL * sms ? (blocks > 0 ? blocks : 1)
                                             : 4LL * sms);
}

// Lets the kernel take `smem` bytes of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int VB, bool MIN, int JR>
int launch_as(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes_of(VB, a.j, JR, a.groups, a.ns);
  const int pack_smem = 4 * (32 + a.j);
  cudaError_t e = allow_smem(superstep_kernel<VB, MIN, JR>, smem);
  if (e == cudaSuccess) e = allow_smem(superstep_kernel_pack<VB>, pack_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  superstep_kernel_pack<VB><<<pack_grid(a.j, a.bn_src, VB), 256, pack_smem,
                              stream>>>(a.d, a.d_pack, a.job_live,
                                        a.src_live, a.gate, a.j, a.bn_src);
  const unsigned grid = static_cast<unsigned>(a.n_chunks) * a.split;
  superstep_kernel<VB, MIN, JR><<<grid, threads_for(a.groups, VB), smem,
                                  stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int VB, bool MIN>
int launch(const Args& a, cudaStream_t stream) {
  if (a.jr == 1) return launch_as<VB, MIN, 1>(a, stream);
  if (a.jr == wide_jobs(VB))
    return launch_as<VB, MIN, wide_jobs(VB)>(a, stream);
  return -2;
}

template <int VB, bool MIN, int JR>
int occupancy_as(int j, int groups, int ns) {
  int n = 0;
  const int smem = smem_bytes_of(VB, j, JR, groups, ns);
  allow_smem(superstep_kernel<VB, MIN, JR>, smem);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, superstep_kernel<VB, MIN, JR>, threads_for(groups, VB),
          smem) != cudaSuccess)
    return -1;
  return n;
}

template <int VB, bool MIN>
int occupancy(int j, int jr, int groups, int ns) {
  if (jr == 1) return occupancy_as<VB, MIN, 1>(j, groups, ns);
  if (jr == wide_jobs(VB))
    return occupancy_as<VB, MIN, wide_jobs(VB)>(j, groups, ns);
  return -1;
}

// Every Vb the kernels are instantiated for (kernel.py SUPPORTED_VB).
#define FS_FOR_EACH_VB(X) X(8) X(16) X(32) X(64) X(128) X(256) X(512)

template <bool MIN>
int dispatch(const Args& a, int vb, cudaStream_t s) {
  switch (vb) {
#define FS_CASE(V) \
  case V: return launch<V, MIN>(a, s);
    FS_FOR_EACH_VB(FS_CASE)
#undef FS_CASE
    default: return -1;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each launcher returns the
// cudaError_t of the launch (0 on success); -1 for an unsupported Vb, -2
// for a jobs-a-thread the kernels are not instantiated for.

extern "C" int fs_smem_bytes(int vb, int j, int jr, int groups, int ns) {
  return smem_bytes_of(vb, j, jr, groups, ns);
}

extern "C" int fs_wide_jobs(int vb) { return wide_jobs(vb); }

// Thread blocks of one kernel that fit one SM at a layout; -1 on error.
extern "C" int fs_blocks_per_sm(int vb, int j, int jr, int groups, int ns,
                                int min_plus) {
  switch (vb) {
#define FS_CASE(V)                                        \
  case V:                                                 \
    return min_plus ? occupancy<V, true>(j, jr, groups, ns) \
                    : occupancy<V, false>(j, jr, groups, ns);
    FS_FOR_EACH_VB(FS_CASE)
#undef FS_CASE
    default: return -1;
  }
}

extern "C" const char* fs_error_string(int code) {
  if (code == -1) return "unsupported block size";
  if (code == -2) return "no kernel instance carries that many jobs a thread";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

Args common_args(const int* src, const int* dst, const int* run_start,
                 const int* chunk_start, const int* chunk_run, int n_chunks,
                 const unsigned char* src_live, const unsigned char* job_live,
                 const unsigned char* gate, unsigned long long* counts,
                 int* arrivals, float* partial, const float* d,
                 float* d_pack, const int* layout) {
  Args a{};
  a.src = src;
  a.dst = dst;
  a.run_start = run_start;
  a.chunk_start = chunk_start;
  a.chunk_run = chunk_run;
  a.n_chunks = n_chunks;
  a.src_live = src_live;
  a.job_live = job_live;
  a.gate = gate;
  a.counts = counts;
  a.arrivals = arrivals;
  a.partial = partial;
  a.d = d;
  a.d_pack = d_pack;
  a.j = layout[0];
  a.jr = layout[1];
  a.groups = layout[2];
  a.ns = layout[3];
  a.split = layout[4];
  a.bn_src = layout[5];
  a.bn_loc = layout[6];
  return a;
}

}  // namespace

// layout[7] = (J, jobs a thread, groups, ring stages, split, bn_src,
// bn_loc), kernel.py `layout` and `split`.
extern "C" int fs_plus_times(const int* src, const int* dst,
                             const int* run_start, const int* chunk_start,
                             const int* chunk_run, int n_chunks,
                             const unsigned char* src_live,
                             const unsigned char* job_live,
                             const unsigned char* gate, void* counts,
                             int* arrivals, float* partial, const float* d,
                             float* d_pack, const float* base,
                             const float* tiles, float* out, float* node_un,
                             float* p_sum, const int* layout, int vb,
                             float tol, void* stream) {
  Args a = common_args(src, dst, run_start, chunk_start, chunk_run, n_chunks,
                       src_live, job_live, gate,
                       static_cast<unsigned long long*>(counts), arrivals,
                       partial, d, d_pack, layout);
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
                           const unsigned char* job_live,
                           const unsigned char* gate, void* counts,
                           int* arrivals, float* partial, const float* d,
                           float* d_pack, const float* values,
                           const float* dbase, const float* tiles,
                           float* vout, float* dout, float* node_un,
                           float* p_sum, const int* layout, int vb,
                           void* stream) {
  Args a = common_args(src, dst, run_start, chunk_start, chunk_run, n_chunks,
                       src_live, job_live, gate,
                       static_cast<unsigned long long*>(counts), arrivals,
                       partial, d, d_pack, layout);
  a.values = values;
  a.base = dbase;
  a.tiles = tiles;
  a.out = vout;
  a.dout = dout;
  a.node_un = node_un;
  a.p_sum = p_sum;
  return dispatch<true>(a, vb, static_cast<cudaStream_t>(stream));
}
