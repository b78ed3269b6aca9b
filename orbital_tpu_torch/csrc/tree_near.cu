// Near field of the tree force solver (near="kernel") for Hopper (sm_90a).
//
// Replaces: orbital_tpu/ops/tree_near_wl.py, _wl_kernel (B7) with its pair
// arithmetic _entry_math. The TPU kernel walks a flat worklist of
// (i-chunk, j-block) entries, GROUP entries a grid step, and leaves one output
// row per (entry, i body) for a segment-sum. Here one block walks one i-chunk's
// whole sweep and writes one row per slot: no per-entry output, no
// segment-sum.
//
// For i-chunk c (rows c*C .. c*C+C-1 of the slot-major table rows), over its
// neighbor runs r < n_nb, over the j-blocks start[c, r] .. start[c, r] +
// count[c, r] - 1 (each block blkw = RJ*C consecutive rows, the blocks of a
// run consecutive too), with the arithmetic of _entry_math
// (tree_near_wl.py:134-168):
//
//   r2 = |x_j - x_i|^2 + eps2,   inv = rsqrt(r2)
//   take = |cx_j - cx_i| <= ws && |cy_j - cy_i| <= ws && |cz_j - cz_i| <= ws
//          && idx_j != idx_i
//   out[c*C + i] = (sum take ? m_j inv^3 dx : 0, ... dy, ... dz,
//                   sum take ? m_j inv : 0)
//
// (acc without G; the caller multiplies). A chunk with every count 0 writes
// zeros: the caller zeroes the counts of the chunks the worklist budget
// drops, so this sums exactly the entries of the TPU kernel's worklist.
//
// Rows are 8 floats, two float4: (x, y, z, m) and (idx, cx, cy, cz), idx and
// the cell coordinates exact in f32 below 2^24, as on the TPU. Sentinel rows
// hold position 1e30, mass 0, idx n and cells 1e9. The self pair is masked
// here by idx, and nothing is subtracted afterwards: the opposite of the
// exact sweeps' bookkeeping.
//
// Which pairs it visits. A pair for which take is false adds exactly 0, so
// the kernel may skip it, and skips only such pairs:
//  * i side: only the chunk's live rows (cells below 1e9). A sentinel i row
//    fails the band against every live j row and the idx test against
//    every sentinel one.
//  * j side: only the staged rows inside the chunk's box, [min c - ws,
//    max c + ws] on each axis over the live i rows. A row outside it fails
//    the band against every live i row; sentinel rows (cells 1e9) and the
//    live rows of other cells that rounding the runs to RJ-row blocks pulls
//    in both fall outside. The sweep keeps the per-pair take, since the box
//    is the chunk's and not the row's.
// On the 65,536-body Plummer main path this visits 46.7 M pairs where the
// first version walked 207 M (every row of every entry, sentinel rows on
// either side included, 35% of them, and the live rows outside the band,
// 49%) for 32.0 M that the function needs (chip_smoke.tree_near_work).
//
// What bounds it on this card: instruction issue over the visited pairs,
// ~29 SASS instructions a pair (3 differences, r2 with eps2 folded (3), one
// MUFU.RSQ, m/r, inv^2 and the weight (3), the band and idx tests (7), two
// selects, four adds, the two shared loads and the loop), 0.04 ms at the
// main path's 47.5 M lane slots, and latency: each chunk's rows are staged
// from L2 in dependent rounds (cells first, then the positions of the rows
// in the box), and the chunks with the most pairs are the critical path. The
// bytes that the function must move (the table once, one row a slot) take
// a microsecond. The first version took 0.33 ms there (38.75 instructions a
// walked pair), this one ~0.11 ms of device time (NVIDIA H100 80GB HBM3, 700
// W; chip_smoke.py phase 24 and --parent; PERF.md). CUDA events around a
// call also count the wrapper's host time, which phase 24 prints.
//
// Design (no float atomics; every sum in a fixed order):
//  * One block of kQ warps per 32-row slice of an i-chunk (one slice for
//    C <= 32). Every warp finds the slice's live rows (a ballot on the
//    cells) and their box (warp min/max), and puts its lanes on the live
//    rows only: with L live rows, lane (i, g) holds the i-th live row (in
//    table order) and g is one of G = 32 / S groups over the j rows, S the
//    power of two >= L. A chunk of one body uses all 32 lanes, as one of 32.
//  * The warps split the chunk's j walk: the concatenated runs are cut into
//    rounds of 32 kK rows, and warp w stages rounds w, w + kQ, ... Each
//    lane loads the cells of its kK rows of the round, tests them against
//    the box, and the in-box rows (their positions loaded only then) are
//    compacted into the warp's shared buffer in table order by a ballot
//    and a prefix count. Whenever the buffer holds >= G rows, the warp
//    sweeps the largest multiple of G of them (each group a fixed share,
//    summed into fresh partials before the running sums) and carries the
//    rest (< G) to the front, so every sweep but the chunk's last fills all
//    lanes.
//  * At the end the groups of each row are added by xor shuffles in a fixed
//    order, then the kQ warps' sums in warp order in shared memory; warp 0
//    writes every slot of the slice (0 for a sentinel slot).
//  * One MUFU.RSQ a pair (rsqrt.approx.ftz): only live rows reach the sweep,
//    so r2 is finite, and r2 + eps2 >= eps2 > 0 on the softened path is
//    never denormal. The band and self masks are selects, never a 0/1
//    product, so a coincident pair at eps2 = 0 (inv = inf) adds 0 as well.
//  * The positions of the in-box rows go to shared memory by cp.async, so
//    they hold no registers in flight; the warp waits for them before a
//    sweep.
// kK = 8 and kQ = 4 are the OT_TREE_K and OT_TREE_Q macros below, the
// fastest shape at 65,536 bodies of chip_smoke.py --sweep, which sets them
// with -D (kQ = 2 ran faster at 1,048,576 and slower at 65,536).
//
// B7's slice (the body-sharded tree; the JAX module's q_part slice of the
// worklist, orbital_tpu/ops/tree_near_wl.py:307-313): with `off`, the runs'
// exclusive offsets in the flat chunk-major worklist (which _wl_table keeps
// from _wl_drop), and a span [lo, hi) of it, each block cuts its chunk's
// runs to the span in its prologue, as ops/tree_near_wl.py::clip_runs does
// (a run keeps the entries of [off, off + count) inside the span, its start
// moved past the ones before lo), and walks the cut runs exactly as the
// whole sweep walks its runs: so a rank's slice visits the slice's entries
// in the order that the same kernel visits them over runs clipped on the
// host. A chunk with no entry in the span (or none at all: a dropped or
// empty one) writes its zero rows and returns before it loads a row. The
// whole sweep is the span of the whole worklist, or a null `off`. The
// first slice clipped the runs in about ten eager ops a call and cast them
// again in the wrapper: 0.388 ms by CUDA events for rank 0's quarter of
// bench_tree's worklist against 0.114 for the whole sweep, most of it host
// time. Cut here, that slice takes 0.0725 ms by events against the whole
// sweep's 0.1071 in turns (chip_smoke.py phase 63, an H100 80GB HBM3 at
// 700 W), for 30% of the whole worklist's needed pairs
// (chip_smoke.tree_near_work). Which of its chunks set that time is not
// measured.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

#ifndef OT_TREE_K
#define OT_TREE_K 8
#endif
#ifndef OT_TREE_Q
#define OT_TREE_Q 4
#endif

namespace {

constexpr int kK = OT_TREE_K;           // j rows a lane stages a round
constexpr int kQ = OT_TREE_Q;           // warps a block, one share of the j walk each
constexpr int kThreads = 32 * kQ;
constexpr int kRound = 32 * kK;         // j rows a warp stages at once
constexpr int kBuf = kRound + 31;       // a round's in-box rows and < 32 carried
constexpr float kSentinelCell = 1e9f;   // the cells of a sentinel row
static_assert(kK >= 1 && kQ >= 1, "bad launch shape");
static_assert(2 * kQ * kBuf * sizeof(float4) + kQ * 32 * (sizeof(float4) + sizeof(int)) <=
                  48 * 1024,
              "static shared memory");

// 1/sqrt(x) as one MUFU.RSQ, denormals flushed (see the note above)
__device__ __forceinline__ float rsqrt_ftz(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return 1.0f / sqrtf(x);  // the host pass never calls it
#endif
}

// A 16-byte copy from device to shared memory that does not hold registers
// while it flies (cp.async); copy_wait() waits for this thread's copies.
__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
#else
  *dst = *src;  // the host pass never calls it
#endif
}

__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Adds buffered rows 0 .. nb - 1 (each (x, y, z, m), (idx, cx, cy, cz)) to
// the sums of row (pi, qi): group g of G = 1 << gshift takes rows g, g + G,
// ..., summed into fresh partials first.
__device__ __forceinline__ void sweep_rows(const float4* buf, int nb, int g, int gshift,
                                           float4 pi, float4 qi, float wsf, float eps2,
                                           float4& acc) {
  float tx = 0.0f, ty = 0.0f, tz = 0.0f, tp = 0.0f;
  const int n_it = nb > g ? (nb - g + (1 << gshift) - 1) >> gshift : 0;
  const float4* row = buf + 2 * g;
  const int step = 2 << gshift;
#pragma unroll 2
  for (int t = 0; t < n_it; ++t, row += step) {
    const float4 pj = row[0];
    const float4 qj = row[1];
    const float dx = pj.x - pi.x;
    const float dy = pj.y - pi.y;
    const float dz = pj.z - pi.z;
    const float inv = rsqrt_ftz(fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2))));
    const bool take = fabsf(qj.y - qi.y) <= wsf && fabsf(qj.z - qi.z) <= wsf &&
                      fabsf(qj.w - qi.w) <= wsf && qj.x != qi.x;
    const float mi = pj.w * inv;  // m_j / r
    const float w = take ? mi * (inv * inv) : 0.0f;
    tx = fmaf(w, dx, tx);
    ty = fmaf(w, dy, ty);
    tz = fmaf(w, dz, tz);
    tp += take ? mi : 0.0f;
  }
  acc.x += tx;
  acc.y += ty;
  acc.z += tz;
  acc.w += tp;
}

// Run r of a chunk (count n, first block b), cut to the worklist entries
// [lo, hi) when `off` (the runs' exclusive offsets) is given; 0 past n_nb.
__device__ __forceinline__ void load_run(const int* count_c, const int* start_c,
                                         const int* off_c, int r, int n_nb, int lo, int hi,
                                         int& n, int& b) {
  n = r < n_nb ? count_c[r] : 0;
  b = r < n_nb ? start_c[r] : 0;
  if (off_c != nullptr && n > 0) {
    const int o = off_c[r];
    const int before = max(lo - o, 0);
    const int kept = max(n - before - max(o + n - hi, 0), 0);
    b = kept > 0 ? b + before : 0;
    n = kept;
  }
}

// The second bound (one block an SM) lets ptxas use the registers the
// staging needs (~105 at kK = 8). Without it ptxas aimed at more blocks an
// SM, held the kernel at 72 registers and spilled (chip_smoke.py phase 2).
__global__ void __launch_bounds__(kThreads, 1)
tree_near_kernel(const float4* __restrict__ rows, const int* __restrict__ start,
                 const int* __restrict__ count, const int* __restrict__ off, int lo, int hi,
                 int n_nb, int chunk, int slices, int blkw, float wsf, float eps2,
                 float4* __restrict__ out) {
  __shared__ float4 bufs[kQ][kBuf][2];  // in-box j rows: (x, y, z, m), (idx, cx, cy, cz)
  __shared__ float4 red[kQ][32];        // each warp's sums of the live i rows
  __shared__ int order[kQ][32];         // the slice's live rows, in table order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int c = blockIdx.x / slices;
  const int row0 = blockIdx.x % slices * 32;
  const int nrows = min(32, chunk - row0);
  const size_t slot = static_cast<size_t>(c) * chunk + row0 + lane;
  // lane r holds run r of each 32 (start, count), cut to the span, loaded
  // before anything waits; a chunk without an entry in it writes zeros
  const int* const count_c = count + static_cast<size_t>(c) * n_nb;
  const int* const start_c = start + static_cast<size_t>(c) * n_nb;
  const int* const off_c = off == nullptr ? nullptr : off + static_cast<size_t>(c) * n_nb;
  int run_n, run_b;
  load_run(count_c, start_c, off_c, lane, n_nb, lo, hi, run_n, run_b);
  bool any = __ballot_sync(0xffffffffu, run_n > 0) != 0u;
  for (int r0 = 32; !any && r0 < n_nb; r0 += 32) {
    int n_r, b_r;
    load_run(count_c, start_c, off_c, r0 + lane, n_nb, lo, hi, n_r, b_r);
    any = __ballot_sync(0xffffffffu, n_r > 0) != 0u;
  }
  if (!any) {
    if (warp == 0 && lane < nrows) out[slot] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }

  // the slice's live rows and their box
  const float4 mine = lane < nrows ? rows[2 * slot + 1]
                                   : make_float4(0.0f, kSentinelCell, kSentinelCell,
                                                 kSentinelCell);
  const float4 mine_p = lane < nrows ? rows[2 * slot] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const bool live = mine.y < kSentinelCell;
  const unsigned lmask = __ballot_sync(0xffffffffu, live);
  const int L = __popc(lmask);
  if (L == 0) {
    if (warp == 0 && lane < nrows) out[slot] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const float lo_x = warp_min(live ? mine.y : kSentinelCell) - wsf;
  const float lo_y = warp_min(live ? mine.z : kSentinelCell) - wsf;
  const float lo_z = warp_min(live ? mine.w : kSentinelCell) - wsf;
  const float hi_x = warp_max(live ? mine.y : -kSentinelCell) + wsf;
  const float hi_y = warp_max(live ? mine.z : -kSentinelCell) + wsf;
  const float hi_z = warp_max(live ? mine.w : -kSentinelCell) + wsf;
  if (live) order[warp][__popc(lmask & below)] = lane;
  __syncwarp();

  // lane (i, g): the i-th live row, group g of G = 32 / S over the j rows
  int sshift = 0;
  while ((1 << sshift) < L) ++sshift;
  const int gshift = 5 - sshift;
  const int G = 1 << gshift;
  const int i = lane & ((1 << sshift) - 1);
  const int g = lane >> sshift;
  const int src_i = order[warp][i < L ? i : 0];
  const float4 pi = make_float4(__shfl_sync(0xffffffffu, mine_p.x, src_i),
                                __shfl_sync(0xffffffffu, mine_p.y, src_i),
                                __shfl_sync(0xffffffffu, mine_p.z, src_i),
                                __shfl_sync(0xffffffffu, mine_p.w, src_i));
  const float4 qi = make_float4(__shfl_sync(0xffffffffu, mine.x, src_i),
                                __shfl_sync(0xffffffffu, mine.y, src_i),
                                __shfl_sync(0xffffffffu, mine.z, src_i),
                                __shfl_sync(0xffffffffu, mine.w, src_i));
  float4* const buf = &bufs[warp][0][0];

  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // the row's running sums
  int fill = 0;    // rows in the warp's buffer
  int before = 0;  // rounds of the runs walked so far
  for (int r0 = 0; r0 < n_nb; r0 += 32) {
    if (r0 > 0) load_run(count_c, start_c, off_c, r0 + lane, n_nb, lo, hi, run_n, run_b);
    for (unsigned runs = __ballot_sync(0xffffffffu, run_n > 0); runs; runs &= runs - 1) {
      const int src = __ffs(runs) - 1;
      const int a = __shfl_sync(0xffffffffu, run_b, src) * blkw;
      const int e = a + __shfl_sync(0xffffffffu, run_n, src) * blkw;
      const int rounds = (e - a + kRound - 1) / kRound;
      for (int t = ((warp - before) % kQ + kQ) % kQ; t < rounds; t += kQ) {
        const int j0 = a + t * kRound + lane;
        float4 qj[kK];
        bool in[kK];
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          qj[k] = j0 + 32 * k < e ? rows[2 * static_cast<size_t>(j0 + 32 * k) + 1]
                                  : make_float4(0.0f, kSentinelCell, kSentinelCell,
                                                kSentinelCell);
        }
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          in[k] = qj[k].y >= lo_x && qj[k].y <= hi_x && qj[k].z >= lo_y &&
                  qj[k].z <= hi_y && qj[k].w >= lo_z && qj[k].w <= hi_z;
        }
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          const unsigned m = __ballot_sync(0xffffffffu, in[k]);
          if (in[k]) {
            const int at = fill + __popc(m & below);
            copy16(&buf[2 * at], &rows[2 * static_cast<size_t>(j0 + 32 * k)]);
            buf[2 * at + 1] = qj[k];
          }
          fill += __popc(m);
        }
        if (fill >= G) {
          copy_wait();
          __syncwarp();
          const int nb = fill & ~(G - 1);
          sweep_rows(buf, nb, g, gshift, pi, qi, wsf, eps2, s);
          // carry the rows past nb (fewer than G <= 32) to the front
          const int rest = fill - nb;
          float4 cp, cq;
          if (lane < rest) {
            cp = buf[2 * (nb + lane)];
            cq = buf[2 * (nb + lane) + 1];
          }
          __syncwarp();
          if (lane < rest) {
            buf[2 * lane] = cp;
            buf[2 * lane + 1] = cq;
          }
          __syncwarp();
          fill = rest;
        }
      }
      before += rounds;
    }
  }
  copy_wait();
  __syncwarp();
  if (fill > 0) sweep_rows(buf, fill, g, gshift, pi, qi, wsf, eps2, s);

  // the G groups of each row, then the kQ warps, each in a fixed order
  for (int off = 1 << sshift; off < 32; off <<= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
    s.z += __shfl_xor_sync(0xffffffffu, s.z, off);
    s.w += __shfl_xor_sync(0xffffffffu, s.w, off);
  }
  if (g == 0 && i < L) red[warp][i] = s;
  __syncthreads();
  if (warp == 0 && lane < nrows) {
    float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (live) {
      const int rank = __popc(lmask & below);
      t = red[0][rank];
      for (int w = 1; w < kQ; ++w) {
        const float4 v = red[w][rank];
        t.x += v.x;
        t.y += v.y;
        t.z += v.z;
        t.w += v.w;
      }
    }
    out[slot] = t;
  }
}

}  // namespace

extern "C" {

// rows: [n_rows * 2] float4, the slot-major table (x, y, z, m), (idx, cx, cy,
// cz) per row; start, count: [k_ch * n_nb] int32 block runs of each chunk
// (count 0 for a dropped chunk); off: [k_ch * n_nb] int32, the runs'
// exclusive offsets in the flat worklist, with [lo, hi) the entries to sweep,
// or null for all of them; out: [k_ch * chunk] float4 (ax, ay, az, pe).
int tree_near_span(const void* rows, const void* start, const void* count, const void* off,
                   int lo, int hi, int k_ch, int n_nb, int chunk, int blkw, float ws,
                   float eps2, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k_ch <= 0) return cudaSuccess;
  if (chunk <= 0 || blkw <= 0) return cudaErrorInvalidValue;
  const int slices = (chunk + 31) / 32;
  tree_near_kernel<<<k_ch * slices, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), static_cast<const int*>(start),
      static_cast<const int*>(count), static_cast<const int*>(off), lo, hi, n_nb, chunk,
      slices, blkw, ws, eps2, static_cast<float4*>(out));
  return cudaGetLastError();
}

// The launch shape for n 32-row chunk slices (k_ch of them at chunk <= 32):
// shape[0..4] = j rows a lane stages a round, warps a block, j rows a warp
// stages a round, threads a block, blocks.
void tree_near_shape(int n, int* shape) {
  shape[0] = kK;
  shape[1] = kQ;
  shape[2] = kRound;
  shape[3] = kThreads;
  shape[4] = n;
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
