// P3M's short-range pair sum over a cell table, for Hopper (sm_90a).
//
// Replaces: no TPU kernel. It stands in for the plain XLA lax.map over cell
// blocks in orbital_tpu/ops/p3m.py:181-231 (p3m_acc_potential), which builds
// [cell_block, M, 27 M] masked pair tiles and segment-sums them back to the
// bodies. It computes what that block computes, over the table that
// ops/p3m.py::p3m_cell_table builds (each cell's kept bodies are a prefix of
// its row, count[c] of them):
//
//   for each kept body i of cell c and each kept body j of the 27 cells
//   around c with j != i and r^2 = |r_j - r_i|^2 < rcut^2:
//     acc_i += G m_j g(r^2) (r_j - r_i),   pe_i += m_j K_short(r^2)
//   g = 1/s^3 - a^3 Gl(x^2),  K_short = 1/s - a Fl(x^2),
//   s^2 = r^2 + eps^2,  a = 1 / (2 sigma),  x = a r,
//   Fl(x^2) = erf(x) / x,  Gl(x^2) = (erf(x) - (2/sqrt(pi)) x exp(-x^2)) / x^3
//
// which is _short_factors' g and K (a Fl = erf(a r)/r, a^3 Gl = the long-range
// part of g), both finite at r = 0 (Fl(0) = 2/sqrt(pi), Gl(0) = 4/(3 sqrt(pi)):
// K(0) = 1/eps - 2a/sqrt(pi) as _short_factors' branch gives it; the force
// of a pair at r = 0 is 0 whatever g is).
//
// The same kernel takes the body-sharded ring's round (p3m_short_pair): the
// kept bodies i of this rank's view against the kept bodies j of a visiting
// rank's view, binned on the same global grid, for
// orbital_tpu/ops/p3m.py:347-418 (p3m_ring_force), whose pairs are kept when
// gid_i != gid_j: two ranks' tables share no body, and in the diagonal
// round (one table) the kernel skips each row's own slot, as here.
//
// Each kept body sits in exactly one table slot, so the kernel adds to its
// body's row directly: no segment sum. Overflowed and dead bodies have no
// slot; the wrapper zeroes the outputs, so their rows read 0.
//
// What bounds it on this card: the needed pairs' operations. At the P3M bench
// row (65,536 uniform bodies, grid 64, 9^3 cells of 1.33 for rcut 1.27) the
// function needs the 59.4 M ordered pairs inside rcut, ~50 f32 operations
// and 3 MUFU operations each: ~0.045 ms, against ~2.6 MB of table and output
// (0.001 ms). The first version walked every live pair of the 27 cells
// (344.3 M) with the pair math under a branch some lane almost always took:
// 1.169 ms, issue-bound on the walked pairs. This one cuts both:
//
// - Which pairs it visits. p3m_view_kernel (below; its plain version is
//   ops/cuda_p3m.py::p3m_short_view) reorders each cell's kept prefix by
//   the Morton code of an 8^3 split of the prefix's bounding box, so a
//   32-row slice spans a small box, and cuts the prefix into the 8 runs of
//   its top-level octants, each with its bounding box. A slice visits a
//   staged row only if its squared distance to the slice's box (the rows'
//   min and max on each axis), each operation rounded down, is below
//   rcut^2 (1 + 2^-20) rounded up. That is a lower bound of the row's
//   squared distance to every row of the slice, and an f32 r^2 is at least
//   the exact r^2 (1 - 2^-24)^5, so a row that fails adds nothing. A run
//   whose box fails the same test against the slice's box is not staged.
//   At the bench row the slices visit 166.6 M pairs, 2.81x the needed.
// - What a visited pair costs. Fl and Gl are polynomials in u = x^2 (2 /
//   kSMax) - 1 on [0, kSMax] (degrees 10 and 11, relative error 1.6 and 3.3
//   ulps in f32 Horner against mpmath), so a pair takes one MUFU (the rsqrt
//   of s^2) and no erf, exp or second rsqrt, and needs no branch at r = 0.
//   The pair math is branch-free: a pair beyond rcut or the slice's own
//   slot gets weight 0. x^2 is clamped to kSMax, so every term is finite.
//   When a^2 rcut^2 exceeds kSMax (cut_sigma > 4.58) the kernel takes the
//   first version's erff/expf arithmetic instead (kPoly = false; chip_smoke.py
//   phase 31 holds it at a cut of 5 sigmas).
// - The self pair is told by its slot (an int32), not by the body's int64
//   index; the runs' offsets give each staged row's slot.
// The single-table sum takes ~0.42 ms alone at the bench row, 55 SASS
// instructions a visited pair (chip_smoke.py phase 33; PERF.md).
//
// At the ring's round (16,384 bodies a shard at 4 ranks) the function
// needs 3.7 M pairs, 0.0028 ms of operations. The table form (a grid of
// cells x ceil(capacity / 32), runs staged one a round, the visitor binned
// and reordered by every rank in every round) took 0.0714 ms a round alone
// and this one 0.0567 (chip_smoke.py --parent, in turns; NVIDIA H100 80GB
// HBM3, 700 W): latency sets it, each block summing ~1.3 slices of ~22 rows,
// a chain of run tests, staging rounds, sweeps and the reduction each.
//
// The view (p3m_view_kernel) moves ~48 B a kept row: 0.001 ms at the
// bench row, under one launch's own device time in a graph (0.001 ms).
// Its first form, a block of 256 threads a cell, took 0.019 ms of device
// time there: each thread ranked its row against every row of its cell
// (O(count^2), 356 rows in the fullest cell), and every block summed the
// counts of all cells before it. A warp a cell now places its rows by
// comparing keys across the warp (up to 32 rows) or by counting (the 512
// keys' histogram and its prefix, O(count + 512)), takes its first 32 rows
// from global memory once, and the block sums the counts before its first
// cell once: 0.012 ms at the bench row; at a ring shard's ~22 rows a cell
// 0.008 ms against the first form's 0.006, a warp's chain of steps being
// longer there. A call is host-bound either way: its wrapper makes one
// buffer for the whole view, whose entries are tensors only when read
// (0.02-0.04 ms of host time a call, 0.05-0.12 before, as the host's load
// goes). NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phases 33 and 61 and
// --parent; PERF.md.
//
// Design, on the template of B7 and the near sweep (tree_near.cu,
// neighbor.cu); no float atomics, every sum in a fixed order:
// - The sum reads a view of the table (p3m_view_kernel, below): each
//   cell's kept rows reordered and held as one segment of a compact array
//   (run_off[c][0] to run_off[c][8], absolute slots), the body index and
//   global id of each slot, the octant runs' boxes, and the list of the
//   (cell, 32-row slice) pairs that hold rows. The body-sharded ring builds
//   each shard's view once an evaluation, on its owner, and passes the
//   view round the ring: the rows of a visitor, not its bodies, so no rank
//   bins or reorders a visitor again.
// - A persistent grid of the co-resident blocks walks the slice list (an
//   integer atomic hands out the entries), so no block is launched for a
//   slice past a cell's prefix: a ring round at 4 ranks holds ~729 slices
//   of ~22 rows, where a grid of cells x ceil(capacity / 32) launched
//   12,393 blocks, ~11,700 of which exited at once.
// - Lanes as (row, group over j): a slice of R rows takes S lanes a row (S
//   the power of two >= R) and G = 32 / S groups a warp, so a cell of one
//   body still fills its warps.
// - The block's threads test the 27 x 8 neighbour runs against the slice's
//   box once and take a prefix sum of the lengths of those within reach;
//   warp w then stages flat rows 32 w, 32 (w + kQ), ... of that sequence,
//   32 a round drawn across as many runs as they span (each lane finds its
//   run by a binary search), and compacts the rows within reach (x, y, z,
//   m and the slot) into its shared buffer by a ballot and a prefix count.
//   Staging one run a round left the rounds nearly empty where a shard's
//   cell holds ~3 rows a run. Once the buffer holds kSweep rows, the warp
//   sweeps the largest multiple of G of them (each group a fixed share,
//   into fresh partials before the running sums) and carries the rest
//   (< G) to the front.
// - The groups of a warp are added by a fixed xor-shuffle tree and the warps
//   in warp order in shared memory: the same result from run to run. Each
//   body's sum is added to its output row (a product and a sum, each
//   rounded), so the ring's rounds accumulate in place in round order.
// - 8 warps a block (OT_P3M_Q), registers capped at 64 so that four blocks
//   fit an SM. With 4 warps (eight blocks an SM) the ring's round at 4
//   ranks, whose slices are ~1/4 as full, ran slower: each slice's chain of
//   staging and sweeping is then twice as long (chip_smoke.py
//   --ring-variants; PERF.md).
//
// Plain C interface for ctypes: pointers and the stream are void*, and each
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

#ifndef OT_P3M_Q
#define OT_P3M_Q 8
#endif

namespace {

constexpr int kQ = OT_P3M_Q;            // warps a block
constexpr int kThreads = 32 * kQ;
constexpr int kMinBlocks = 32 / kQ;     // blocks an SM at 64 registers
constexpr int kViewWarps = 4;         // the view kernel's cells a block, a warp each
constexpr int kKeys = 512;           // the view's Morton keys: an 8^3 split of a cell
constexpr int kHist = kKeys + kKeys / 16;  // the keys' histogram, a pad int every 16
constexpr int kOct = 8;               // runs a cell: its top-level octants
constexpr int kRuns = 27 * kOct;      // runs a slice may stage
constexpr int kSweep = 64;            // buffered rows that start a sweep
constexpr int kBuf = kSweep + 31;     // < kSweep rows and one round of 32
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;
constexpr float kSMax = 5.25f;        // the polynomials' range of x^2
constexpr float kU = 2.0f / kSMax;

// Fl(x^2) = erf(x) / x and Gl(x^2) = (erf(x) - (2/sqrt(pi)) x e^-x^2) / x^3
// as polynomials in u = x^2 kU - 1, lowest degree first (relative minimax
// fits against mpmath on a 4,001-point grid of [0, kSMax])
__constant__ float kF[11] = {
    6.036675572e-01f, -2.609640658e-01f, 1.420814097e-01f, -7.146384567e-02f,
    3.173005953e-02f, -1.239151228e-02f, 4.278487992e-03f, -1.306767110e-03f,
    3.660675138e-04f, -1.059848728e-04f, 2.338889681e-05f};
__constant__ float kG[12] = {
    1.988297254e-01f, -2.165050954e-01f, 1.633482873e-01f, -9.670009464e-02f,
    4.718324170e-02f, -1.956082135e-02f, 7.043011952e-03f, -2.235665685e-03f,
    6.305756397e-04f, -1.645274606e-04f, 4.331309174e-05f, -8.414358490e-06f};

struct Consts {
  float rcut2;
  float alpha;   // a = 1 / (2 sigma)
  float a2;      // a^2
  float a3;      // a^3
  float cg;      // 2 a / sqrt(pi)
  float k0;      // eps2^-1/2 - cg, K at r = 0 (the erff path)
  float eps2;
};

// 1/sqrt(x) as one MUFU.RSQ, denormals flushed (x >= eps2 > 0 here)
__device__ __forceinline__ float rsqrt_ftz(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return 1.0f / sqrtf(x);  // the host pass never calls it
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

// How far x lies outside [lo, hi], rounded down (0 inside).
__device__ __forceinline__ float gap_rd(float lo, float hi, float x) {
  return fmaxf(fmaxf(__fsub_rd(lo, x), __fsub_rd(x, hi)), 0.0f);
}

// g_x^2 + g_y^2 + g_z^2 with every operation rounded down: a lower bound of
// the exact squared distance whose axis gaps are at least g_x, g_y, g_z.
__device__ __forceinline__ float dist2_rd(float gx, float gy, float gz) {
  return __fadd_rd(__fadd_rd(__fmul_rd(gx, gx), __fmul_rd(gy, gy)), __fmul_rd(gz, gz));
}

// float -> int in the same order (for integer atomicMin / atomicMax), and back
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// g and K of one pair at r^2 (eps2 > 0, so r2 + eps2 > 0)
template <bool kPoly>
__device__ __forceinline__ void factors(float r2, const Consts& c, float& gf, float& kf) {
  if (kPoly) {
    const float u = fmaf(fminf(c.a2 * r2, kSMax), kU, -1.0f);
    float F = kF[10];
#pragma unroll
    for (int k = 9; k >= 0; --k) F = fmaf(F, u, kF[k]);
    float Gl = kG[11];
#pragma unroll
    for (int k = 10; k >= 0; --k) Gl = fmaf(Gl, u, kG[k]);
    const float inv_s = rsqrt_ftz(r2 + c.eps2);
    gf = fmaf(-c.a3, Gl, inv_s * inv_s * inv_s);
    kf = fmaf(-c.alpha, F, inv_s);
  } else if (r2 > 0.0f) {
    const float inv_r = rsqrtf(r2);
    const float rr = r2 * inv_r;
    const float ar = c.alpha * rr;
    const float erf_t = erff(ar);
    const float gauss = c.cg * expf(-(ar * ar));
    const float inv_s = rsqrtf(r2 + c.eps2);
    gf = inv_s * inv_s * inv_s - (erf_t - gauss * rr) * (inv_r * inv_r * inv_r);
    kf = inv_s - erf_t * inv_r;
  } else {
    gf = 0.0f;
    kf = c.k0;
  }
}

// Adds buffered rows 0 .. nb - 1 to the sums of row pi (slot `self`): group
// g of G = 1 << gshift takes rows g, g + G, ..., summed into fresh partials
// first. Rows beyond rcut and the row's own slot get weight 0.
template <bool kPoly>
__device__ __forceinline__ void sweep_rows(const float4* buf, const int* slots, int nb, int g,
                                           int gshift, float4 pi, int self, const Consts& c,
                                           float4& acc) {
  float tx = 0.0f, ty = 0.0f, tz = 0.0f, tp = 0.0f;
  const int step = 1 << gshift;
  for (int t = g; t < nb; t += step) {
    const float4 q = buf[t];
    const float dx = q.x - pi.x;
    const float dy = q.y - pi.y;
    const float dz = q.z - pi.z;
    const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
    float gf, kf;
    factors<kPoly>(r2, c, gf, kf);
    const float w = (r2 < c.rcut2 && slots[t] != self) ? q.w : 0.0f;
    const float wg = w * gf;
    tx = fmaf(wg, dx, tx);
    ty = fmaf(wg, dy, ty);
    tz = fmaf(wg, dz, tz);
    tp = fmaf(w, kf, tp);
  }
  acc.x += tx;
  acc.y += ty;
  acc.z += tz;
  acc.w += tp;
}

struct SliceShared {
  float4 bufs[kQ][kBuf];  // the rows that pass the slice's test (x, y, z, m)
  int slot_bufs[kQ][kBuf];
  int run_start[kRuns];   // the first slot of each neighbour run
  int run_len[kRuns];     // its rows, 0 where its box is out of reach
  int run_end[kRuns];     // the inclusive prefix sum of run_len
  float4 red[kQ][32];
  int unit;               // the list entry the block sums next
};

// One slice of the i view (list entry `entry`: cell entry >> 9, rows
// 32 (entry & 511) onward of the cell's kept rows) against the rows of the
// j view in the 27 cells around it. Both views hold each cell's kept rows
// in one segment, run_off[c][0] to run_off[c][8], as absolute slots; `diag`
// says they are one view, whose own slot each row skips (two views hold no
// body in common). Adds G acc and pe of each row to its body's outputs.
template <bool kPoly>
__device__ __forceinline__ void slice_sum(SliceShared& sh, int entry,
                                          const float4* __restrict__ rows4,
                                          const long long* __restrict__ body,
                                          const int* __restrict__ run_off,
                                          const float4* __restrict__ rows4_j,
                                          const int* __restrict__ run_off_j,
                                          const float* __restrict__ run_box_j, bool diag,
                                          int gc, const Consts& c, float G,
                                          float* __restrict__ acc, float* __restrict__ pe) {
  const int cell = entry >> 9;
  const int first = run_off[cell * (kOct + 1)];
  const int cnt = run_off[cell * (kOct + 1) + kOct] - first;
  const int s0 = (entry & 511) * 32;
  const int rows = min(32, cnt - s0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int base = first + s0;

  // the slice's rows, their box and the reach test's bound
  float4 mine = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (lane < rows) mine = rows4[base + lane];
  const float inf = __int_as_float(0x7f800000);
  const bool own = lane < rows;
  const float lo_x = warp_min(own ? mine.x : inf);
  const float lo_y = warp_min(own ? mine.y : inf);
  const float lo_z = warp_min(own ? mine.z : inf);
  const float hi_x = warp_max(own ? mine.x : -inf);
  const float hi_y = warp_max(own ? mine.y : -inf);
  const float hi_z = warp_max(own ? mine.z : -inf);
  const float reach2 = __fmul_ru(c.rcut2, 1.0f + 0x1p-20f);

  // the neighbour runs whose box comes within reach of the slice's
  // (_OFFSETS order, z fastest)
  int* const run_start = sh.run_start;
  int* const run_len = sh.run_len;
  int* const run_end = sh.run_end;
  for (int t = threadIdx.x; t < kRuns; t += kThreads) {
    const int nbr = t / kOct, oct = t % kOct;
    const int cz = cell % gc, cy = (cell / gc) % gc, cx = cell / (gc * gc);
    const int nx = cx + nbr / 9 - 1, ny = cy + (nbr / 3) % 3 - 1, nz = cz + nbr % 3 - 1;
    int start = 0, len = 0;
    if (0 <= nx && nx < gc && 0 <= ny && ny < gc && 0 <= nz && nz < gc) {
      const int id = (nx * gc + ny) * gc + nz;
      const int o0 = run_off_j[id * (kOct + 1) + oct];
      const int o1 = run_off_j[id * (kOct + 1) + oct + 1];
      const float* b = run_box_j + static_cast<size_t>(id * kOct + oct) * 6;
      const float gx = fmaxf(fmaxf(__fsub_rd(b[0], hi_x), __fsub_rd(lo_x, b[3])), 0.0f);
      const float gy = fmaxf(fmaxf(__fsub_rd(b[1], hi_y), __fsub_rd(lo_y, b[4])), 0.0f);
      const float gz = fmaxf(fmaxf(__fsub_rd(b[2], hi_z), __fsub_rd(lo_z, b[5])), 0.0f);
      const bool reach = o1 > o0 && dist2_rd(gx, gy, gz) < reach2;
      start = o0;
      len = reach ? o1 - o0 : 0;
    }
    run_start[t] = start;
    run_len[t] = len;
  }
  __syncthreads();
  // the runs' rows in reach as one flat sequence: a prefix sum of the
  // lengths, in run order
  if (warp == 0) {
    int carry = 0;
    for (int p = 0; p < kRuns; p += 32) {
      const int t = p + lane;
      int v = t < kRuns ? run_len[t] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += y;
      }
      if (t < kRuns) run_end[t] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const int total = run_end[kRuns - 1];

  // lane (i, g): row i of the slice, group g of G = 32 / S over the j rows
  int sshift = 0;
  while ((1 << sshift) < rows) ++sshift;
  const int gshift = 5 - sshift;
  const int G_ = 1 << gshift;
  const int i = lane & ((1 << sshift) - 1);
  const int g = lane >> sshift;
  const int src_i = i < rows ? i : 0;
  const float4 pi = make_float4(__shfl_sync(0xffffffffu, mine.x, src_i),
                                __shfl_sync(0xffffffffu, mine.y, src_i),
                                __shfl_sync(0xffffffffu, mine.z, src_i), 0.0f);
  const int self = diag ? base + src_i : -1;  // no slot of the j view is -1
  float4* const buf = sh.bufs[warp];
  int* const sbuf = sh.slot_bufs[warp];

  // warp w stages flat rows 32 w, 32 (w + kQ), ... onward, 32 a round, each
  // lane finding its row's run by a binary search of run_end
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // the row's running sums
  int fill = 0;                                    // rows in the warp's buffer
  for (int f0 = 32 * warp; f0 < total; f0 += kThreads) {
    const int f = f0 + lane;
    float4 q = make_float4(inf, inf, inf, 0.0f);
    int slot = 0;
    if (f < total) {
      int lo = 0, hi = kRuns - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (run_end[mid] > f) hi = mid;
        else lo = mid + 1;
      }
      slot = run_start[lo] + f - (run_end[lo] - run_len[lo]);
      q = rows4_j[slot];
    }
    const bool in = f < total && dist2_rd(gap_rd(lo_x, hi_x, q.x), gap_rd(lo_y, hi_y, q.y),
                                          gap_rd(lo_z, hi_z, q.z)) < reach2;
    const unsigned m = __ballot_sync(0xffffffffu, in);
    if (in) {
      buf[fill + __popc(m & below)] = q;
      sbuf[fill + __popc(m & below)] = slot;
    }
    fill += __popc(m);
    if (fill >= kSweep) {
      __syncwarp();
      const int nb = fill & ~(G_ - 1);
      sweep_rows<kPoly>(buf, sbuf, nb, g, gshift, pi, self, c, s);
      // carry the rows past nb (fewer than G <= 32) to the front
      const int rest = fill - nb;
      float4 cq;
      int cs = 0;
      if (lane < rest) {
        cq = buf[nb + lane];
        cs = sbuf[nb + lane];
      }
      __syncwarp();
      if (lane < rest) {
        buf[lane] = cq;
        sbuf[lane] = cs;
      }
      __syncwarp();
      fill = rest;
    }
  }
  __syncwarp();
  if (fill > 0) sweep_rows<kPoly>(buf, sbuf, fill, g, gshift, pi, self, c, s);

  // the G groups of each row, then the kQ warps, each in a fixed order
  for (int o = 1 << sshift; o < 32; o <<= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
    s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
    s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
  }
  if (g == 0 && i < rows) sh.red[warp][i] = s;
  __syncthreads();
  if (warp == 0 && lane < rows) {
    float4 t = sh.red[0][lane];
    for (int w = 1; w < kQ; ++w) {
      const float4 u = sh.red[w][lane];
      t.x += u.x;
      t.y += u.y;
      t.z += u.z;
      t.w += u.w;
    }
    // out += this sum, rounded as a separate product and sum
    const long long b = body[base + lane];
    acc[3 * b] = __fadd_rn(acc[3 * b], __fmul_rn(G, t.x));
    acc[3 * b + 1] = __fadd_rn(acc[3 * b + 1], __fmul_rn(G, t.y));
    acc[3 * b + 2] = __fadd_rn(acc[3 * b + 2], __fmul_rn(G, t.z));
    pe[b] = __fadd_rn(pe[b], t.w);
  }
}

// A persistent grid of co-resident blocks: each block takes the next entry
// of the i view's slice list (one integer atomic on nslices[1]) until the
// list's nslices[0] entries are taken; the last block out (nslices[2]
// counts them) sets both counters back to 0 for the next launch. Registers
// are capped at 64, so that 2,048 threads fit an SM.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
p3m_short_kernel(const float4* __restrict__ rows4, const long long* __restrict__ body,
                 const int* __restrict__ run_off, const int* __restrict__ slices,
                 int* __restrict__ nslices, const float4* __restrict__ rows4_j,
                 const int* __restrict__ run_off_j, const float* __restrict__ run_box_j,
                 bool diag, int gc, const float* __restrict__ params, float G, float eps2,
                 float* __restrict__ acc, float* __restrict__ pe) {
  Consts c;
  c.rcut2 = params[0];
  c.alpha = params[1];
  c.a2 = c.alpha * c.alpha;
  c.a3 = c.a2 * c.alpha;
  c.cg = kTwoOverSqrtPi * c.alpha;
  c.k0 = 1.0f / sqrtf(eps2) - c.cg;
  c.eps2 = eps2;
  __shared__ SliceShared sh;
  const int total = nslices[0];
  // uniform: one split for the whole view
  const bool poly = c.a2 * c.rcut2 <= kSMax;
  for (;;) {
    if (threadIdx.x == 0) sh.unit = atomicAdd(nslices + 1, 1);
    __syncthreads();
    const int u = sh.unit;
    if (u >= total) break;
    if (poly) {
      slice_sum<true>(sh, slices[u], rows4, body, run_off, rows4_j, run_off_j, run_box_j,
                          diag, gc, c, G, acc, pe);
    } else {
      slice_sum<false>(sh, slices[u], rows4, body, run_off, rows4_j, run_off_j,
                           run_box_j, diag, gc, c, G, acc, pe);
    }
    __syncthreads();
  }
  // every block has taken its last entry once all have counted themselves
  // out, so the last one can reset the list's counters
  if (threadIdx.x == 0 && atomicAdd(nslices + 2, 1) == static_cast<int>(gridDim.x) - 1) {
    nslices[1] = 0;
    nslices[2] = 0;
  }
}

// Where key k's count lies in a warp's histogram: one pad int after every
// 16 keys, so that lane l reading key 16 l + j (j fixed) hits bank
// (17 l + j) mod 32, a different bank for each lane.
__device__ __forceinline__ int hist_at(int k) { return k + (k >> 4); }

// A kept row's Morton key in its cell's 8^3 split (lo = v[0..2], scale =
// 8 / extent: the float operations of the torch version), its top-level
// octant's box widened to the row by integer atomics on `obox` [8][6].
__device__ __forceinline__ int morton(float4 x, const float* v, const float* scale,
                                      int* obox) {
  const float xs[3] = {x.x, x.y, x.z};
  int key = 0, oct = 0;
  for (int a = 0; a < 3; ++a) {
    const int q =
        static_cast<int>(fminf(fmaxf(floorf((xs[a] - v[a]) * scale[a]), 0.0f), 7.0f));
    key |= ((q & 1) | ((q & 2) << 2) | ((q & 4) << 4)) << (2 - a);
    oct = (oct << 1) | (q >> 2);
  }
  for (int a = 0; a < 3; ++a) {
    const int xi = ordered(xs[a]);
    atomicMin(&obox[oct * 6 + a], xi);
    atomicMax(&obox[oct * 6 + 3 + a], xi);
  }
  return key;
}

// The sum of v over a warp (every lane gets it).
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The view of ops/cuda_p3m.py::p3m_short_view: a warp a cell, kViewWarps
// cells a block. Each warp's part of the dynamic shared memory holds
// `cap` ints (each kept row's Morton key and its rank among the earlier
// rows of that key), kHist ints (the keys' histogram, then its exclusive
// prefix: the first new place of each key) and the octant runs' boxes.
//
// - The rows and slices before the cell: the block's threads sum
//   count[0 .. first cell of the block) once (each at most gc^3 / threads
//   loads), and each warp adds the counts of the block's cells before its
//   own.
// - The cell's box: one pass over its kept rows (x, y, z of a row are 12
//   contiguous bytes, 32 rows a pass), reduced by shuffles.
// - Keys and the stable order: each row's key (the same float operations
//   as the torch version) and its new place, the count of smaller keys
//   plus the count of equal keys in earlier rows: the place of a stable
//   sort by (key, old place). A cell of up to 32 rows (a ring shard's
//   ~22) compares the keys across the warp by shuffles. A larger one
//   takes its rows 32 at a time in row order, each row's rank among the
//   rows of its key so far from __match_any_sync within the 32 and a
//   histogram for the earlier ones, and the smaller keys from the
//   histogram's prefix (each lane scanning 16 of the 512 keys, held 17
//   ints apart so that the scan has no bank conflict): O(count + 512).
// - The runs: octant o's rows are keys 64 o .. 64 o + 63, so its first
//   row is the count of keys below 64 o; its box is a min and max over
//   the integer images of the coordinates (order-preserving ints) by
//   shared atomics: exact, whatever the order.
// - The third pass writes each row (x, y, z, m), its body index and, with
//   `gid`, its global id to its new place; the cell's slices go to the
//   slice list after the earlier cells' slices, and the last cell's warp
//   writes the list's length.
__global__ void __launch_bounds__(kViewWarps * 32)
p3m_view_kernel(const float* __restrict__ cell_pos, const float* __restrict__ cell_m,
                const long long* __restrict__ table, const int* __restrict__ count,
                const long long* __restrict__ gid, int cap, int cells,
                float4* __restrict__ rows4, long long* __restrict__ body,
                long long* __restrict__ gid_s, int* __restrict__ run_off,
                float* __restrict__ run_box, int* __restrict__ slices,
                int* __restrict__ nslices) {
  extern __shared__ int smem[];
  __shared__ int part[2][kViewWarps];
  __shared__ int own_n[kViewWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int first = blockIdx.x * warps;
  const int cell = first + warp;
  const float inf = __int_as_float(0x7f800000);
  const size_t base = static_cast<size_t>(cell) * cap;
  const float* const pos = cell_pos + 3 * base;

  // the warp's first 32 rows (each lane's row `lane`: x, y, z, m, body
  // index and global id), loaded once, while the block sums the counts
  // before it: a cell of up to 32 rows reads global memory here only
  const int cnt = cell < cells ? count[cell] : 0;
  const bool row0 = lane < cnt;
  float4 r0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  long long b0 = 0;
  if (row0) {
    r0 = make_float4(pos[3 * lane], pos[3 * lane + 1], pos[3 * lane + 2], cell_m[base + lane]);
    b0 = table[base + lane];
  }
  int rows_before = 0, slices_before = 0;
#pragma unroll 4
  for (int k = threadIdx.x; k < first; k += blockDim.x) {
    const int n_k = count[k];
    rows_before += n_k;
    slices_before += (n_k + 31) >> 5;
  }
  const long long g0 = gid != nullptr && row0 ? gid[b0] : 0;
  rows_before = warp_sum(rows_before);
  slices_before = warp_sum(slices_before);
  if (lane == 0) {
    part[0][warp] = rows_before;
    part[1][warp] = slices_before;
    own_n[warp] = cnt;
  }
  __syncthreads();
  if (cell >= cells) return;
  int start = 0, sl0 = 0;
  for (int w = 0; w < warps; ++w) {
    start += part[0][w] + (w < warp ? own_n[w] : 0);
    sl0 += part[1][w] + (w < warp ? (own_n[w] + 31) >> 5 : 0);
  }
  int* const key_rank = smem + warp * (cap + kHist + kOct * 6);
  int* const first_of = key_rank + cap;  // the histogram, then its prefix
  int* const obox = first_of + kHist;    // [kOct][6]

  // the cell's box
  float v[6] = {inf, inf, inf, -inf, -inf, -inf};
  if (row0) {
    v[0] = v[3] = r0.x;
    v[1] = v[4] = r0.y;
    v[2] = v[5] = r0.z;
  }
#pragma unroll 4
  for (int k = lane + 32; k < cnt; k += 32) {
    for (int a = 0; a < 3; ++a) {
      const float x = pos[3 * k + a];
      v[a] = fminf(v[a], x);
      v[3 + a] = fmaxf(v[3 + a], x);
    }
  }
  for (int a = 0; a < 3; ++a) {
    v[a] = warp_min(v[a]);
    v[3 + a] = warp_max(v[3 + a]);
  }
  float scale[3];
  for (int a = 0; a < 3; ++a) scale[a] = 8.0f / fmaxf(v[3 + a] - v[a], 1e-30f);
  for (int k = lane; k < kOct * 6; k += 32) obox[k] = ordered(k % 6 < 3 ? inf : -inf);
  const bool one = cnt <= 32;  // the cell's rows are the lanes' first rows
  if (!one) {
    for (int k = lane; k < kHist; k += 32) first_of[k] = 0;
  }
  __syncwarp();

  if (one) {
    // each row's place is its count of smaller keys and of equal keys
    // before it, compared across the warp; the runs' first rows by ballots
    const int key = row0 ? morton(r0, v, scale, obox) : kKeys + lane;
    int rank = 0;
    for (int j = 0; j < 32; ++j) {
      const int kj = __shfl_sync(0xffffffffu, key, j);
      rank += kj < key || (kj == key && j < lane);
    }
    int first_row = 0;
    for (int o = 1; o <= kOct; ++o) {
      const int below_o = __popc(__ballot_sync(0xffffffffu, key < o * (kKeys / kOct)));
      if (lane == o) first_row = below_o;
    }
    if (row0) {
      const size_t dst = static_cast<size_t>(start) + rank;
      rows4[dst] = r0;
      body[dst] = b0;
      if (gid != nullptr) gid_s[dst] = g0;
    }
    if (lane <= kOct) run_off[cell * (kOct + 1) + lane] = start + first_row;
  } else {
    // keys, their histogram, each row's rank within its key (32 rows at a
    // time, in row order), the run boxes
    for (int k0 = 0; k0 < cnt; k0 += 32) {
      const int k = k0 + lane;
      const bool row = k < cnt;
      int key = kKeys + lane;  // unique past the keys: no peers
      if (row) {
        const float4 x = k0 == 0 ? r0 : make_float4(pos[3 * k], pos[3 * k + 1],
                                                     pos[3 * k + 2], 0.0f);
        key = morton(x, v, scale, obox);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      const int earlier = row ? first_of[hist_at(key)] : 0;
      __syncwarp();
      if (row) {
        const int within = __popc(peers & below);
        key_rank[k] = (key << 16) | (earlier + within);
        if (within == 0) first_of[hist_at(key)] = earlier + __popc(peers);
      }
      __syncwarp();
    }

    // the histogram's exclusive prefix: lane l scans keys 16 l .. 16 l + 15
    // (held 17 ints apart, so that the 32 lanes hit 32 banks)
    int h[kKeys / 32];
    int tot = 0;
#pragma unroll
    for (int j = 0; j < kKeys / 32; ++j) {
      h[j] = first_of[hist_at(lane * (kKeys / 32) + j)];
      tot += h[j];
    }
    int ex = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, ex, off);
      if (lane >= off) ex += t;
    }
    ex -= tot;
#pragma unroll
    for (int j = 0; j < kKeys / 32; ++j) {
      first_of[hist_at(lane * (kKeys / 32) + j)] = ex;
      ex += h[j];
    }
    __syncwarp();

    // each row to its new place (unrolled: the loads of several rows, and
    // their global ids after them, in flight at once)
#pragma unroll 4
    for (int k = lane; k < cnt; k += 32) {
      const int kr = key_rank[k];
      const size_t dst =
          static_cast<size_t>(start) + first_of[hist_at(kr >> 16)] + (kr & 0xffff);
      if (k < 32) {
        rows4[dst] = r0;
        body[dst] = b0;
        if (gid != nullptr) gid_s[dst] = g0;
      } else {
        rows4[dst] = make_float4(pos[3 * k], pos[3 * k + 1], pos[3 * k + 2], cell_m[base + k]);
        const long long b = table[base + k];
        body[dst] = b;
        if (gid != nullptr) gid_s[dst] = gid[b];
      }
    }
    if (lane <= kOct) {
      run_off[cell * (kOct + 1) + lane] =
          start + (lane < kOct ? first_of[hist_at(lane * (kKeys / kOct))] : cnt);
    }
  }
  const int own = (cnt + 31) >> 5;
  for (int k = lane; k < own; k += 32) slices[sl0 + k] = (cell << 9) | k;
  __syncwarp();  // every lane's atomics on obox before any lane reads it
  for (int k = lane; k < kOct * 6; k += 32)
    run_box[static_cast<size_t>(cell) * kOct * 6 + k] = unordered(obox[k]);
  if (cell == cells - 1 && lane == 0) {
    nslices[0] = sl0 + own;
    nslices[1] = 0;
    nslices[2] = 0;
  }
}

// The co-resident blocks of p3m_short_kernel on the current device, asked
// once a device.
int resident_blocks(int device) {
  static int cache[64] = {0};
  const int d = device >= 0 && device < 64 ? device : 0;
  if (cache[d] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p3m_short_kernel, kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cache[d] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  return cache[d];
}

int launch_sum(const void* rows4, const void* body, const void* run_off, const void* slices,
               void* nslices, int max_slices, const void* rows4_j, const void* run_off_j,
               const void* run_box_j, int diag, int gc, const void* params, float G,
               float eps2, void* acc, void* pe, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (gc <= 0 || max_slices <= 0) return cudaSuccess;
  if (!(eps2 > 0.0f)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int grid = min(resident_blocks(device), max_slices);
  p3m_short_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float4*>(rows4), static_cast<const long long*>(body),
      static_cast<const int*>(run_off), static_cast<const int*>(slices),
      static_cast<int*>(nslices), static_cast<const float4*>(rows4_j),
      static_cast<const int*>(run_off_j), static_cast<const float*>(run_box_j), diag != 0, gc,
      static_cast<const float*>(params), G, eps2, static_cast<float*>(acc),
      static_cast<float*>(pe));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The view of a cell table (p3m_short_view's outputs, its plain version
// ops/cuda_p3m.py::p3m_short_view): cell_pos: [gc^3 * cap, 3] and cell_m:
// [gc^3 * cap] float, table: [gc^3 * cap] int64 (p3m_cell_table's, the pad
// row dropped), count: [gc^3] int32, gid: [n] int64 global ids or null.
// Writes the kept rows of rows4 [n] float4, body [n] int64 and (with gid)
// gid_s [n] int64 (slots past the kept rows are left as they were), run_off
// [gc^3, 9] int32 (absolute slots), run_box [gc^3, 8, 6] float, slices
// [at most gc^3 ceil(cap / 32)] int32 and nslices [3] int32 (the list's
// length, and the sum's two counters, 0).
int p3m_short_view(const void* cell_pos, const void* cell_m, const void* table,
                   const void* count, const void* gid, int gc, int cap, void* rows4,
                   void* body, void* gid_s, void* run_off, void* run_box, void* slices,
                   void* nslices, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (gc <= 0 || cap <= 0) return cudaSuccess;
  if (cap > 16384) return cudaErrorInvalidValue;  // the ranks' 16 bits, 9-bit slices
  // a warp's shared memory: a key and rank a row, the keys' histogram, the
  // run boxes; as many warps a block as fit the default 48 KiB (one at
  // the largest capacities, past it by the opt-in)
  const int cells = gc * gc * gc;
  const size_t per_warp = (static_cast<size_t>(cap) + kHist + kOct * 6) * sizeof(int);
  const int warps = static_cast<int>(max(1, min(kViewWarps, static_cast<int>(
      (48 * 1024) / per_warp))));
  const size_t shared = per_warp * warps;
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(p3m_view_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  p3m_view_kernel<<<(cells + warps - 1) / warps, warps * 32, shared,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cell_pos), static_cast<const float*>(cell_m),
      static_cast<const long long*>(table), static_cast<const int*>(count),
      static_cast<const long long*>(gid), cap, cells, static_cast<float4*>(rows4),
      static_cast<long long*>(body), static_cast<long long*>(gid_s),
      static_cast<int*>(run_off), static_cast<float*>(run_box), static_cast<int*>(slices),
      static_cast<int*>(nslices));
  return cudaGetLastError();
}

// The two-table form (the body-sharded ring's round, ops/p3m.py
// p3m_ring_force): the rows of view i (rows4, body, run_off, its slice
// list slices / nslices, max_slices the list's room) summed against the
// rows of view j (rows4_j, run_off_j, run_box_j) in the 27 cells around
// each, both binned on one grid. With diag = 1 the two are one view (the
// ring's own shard) and each row skips its own slot; with diag = 0 no pair
// is skipped (the views hold different bodies). params: [2] float on the
// device (rcut^2, alpha = 1 / (2 sigma)); acc: [n, 3] and pe: [n] float,
// to which the sums of the bodies of view i are added (rows of bodies
// without a slot are left as they were).
int p3m_short_pair(const void* rows4, const void* body, const void* run_off,
                   const void* slices, void* nslices, int max_slices, const void* rows4_j,
                   const void* run_off_j, const void* run_box_j, int diag, int gc,
                   const void* params, float G, float eps2, void* acc, void* pe, void* stream,
                   int device) {
  return launch_sum(rows4, body, run_off, slices, nslices, max_slices, rows4_j,
                            run_off_j, run_box_j, diag, gc, params, G, eps2, acc, pe, stream,
                            device);
}

// The single-table sum: view i against itself (diag).
int p3m_short_sorted(const void* rows4, const void* body, const void* run_off,
                     const void* run_box, const void* slices, void* nslices, int max_slices,
                     int gc, const void* params, float G, float eps2, void* acc, void* pe,
                     void* stream, int device) {
  return launch_sum(rows4, body, run_off, slices, nslices, max_slices, rows4,
                              run_off, run_box, 1, gc, params, G, eps2, acc, pe, stream,
                              device);
}

// The launch shape: shape[0..4] = rows a slice, warps a block, buffered rows
// that start a sweep, threads a block, and the co-resident blocks (the
// persistent grid, at most).
void p3m_short_shape(int device, int* shape) {
  cudaSetDevice(device);
  shape[0] = 32;
  shape[1] = kQ;
  shape[2] = kSweep;
  shape[3] = kThreads;
  shape[4] = resident_blocks(device);
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
