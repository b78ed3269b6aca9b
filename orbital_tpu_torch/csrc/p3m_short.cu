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
// kept bodies i of this rank's table against the kept bodies j of a visiting
// rank's table, binned on the same global grid, for
// orbital_tpu/ops/p3m.py:347-418 (p3m_ring_force), whose pairs are kept when
// gid_i != gid_j: two ranks' tables share no body, and in the diagonal
// round (one table) the kernel skips each row's own slot, as here.
//
// Each kept body sits in exactly one table slot, so the kernel writes its
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
// - Which pairs it visits. p3m_order_kernel (below; its plain version is
//   ops/cuda_p3m.py::p3m_short_order) reorders each cell's kept prefix by
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
//   index, and the runs give each staged row's slot without a search.
// It takes 0.452 ms a call by events at the bench row (0.493 with its
// reorder), 56 SASS instructions a visited pair, 1.6x its issue floor
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 33; PERF.md).
//
// Design, on the template of B7 and the near sweep (tree_near.cu,
// neighbor.cu); no float atomics, every sum in a fixed order:
// - One block of kQ warps per 32-row slice of a cell's reordered prefix
//   (grid: cells x ceil(capacity / 32); blocks past the prefix exit).
// - Lanes as (row, group over j): a slice of R rows takes S lanes a row (S
//   the power of two >= R) and G = 32 / S groups a warp, so a cell of one
//   body still fills its warps.
// - The block's threads test the 27 x 8 neighbour runs against the slice's
//   box once; warp w stages runs w, w + kQ, ... in order, 32 rows a round,
//   and compacts the rows within reach (x, y, z, m and the slot) into its shared
//   buffer by a ballot and a prefix count. Once the buffer holds kSweep
//   rows, the warp sweeps the largest multiple of G of them (each group a
//   fixed share, into fresh partials before the running sums) and carries
//   the rest (< G) to the front.
// - The groups of a warp are added by a fixed xor-shuffle tree and the warps
//   in warp order in shared memory: the same result from run to run.
//
// Plain C interface for ctypes: pointers and the stream are void*, and each
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 8;                 // warps a block, one share of the runs each
constexpr int kOrderThreads = 256;    // the reorder's threads a cell
constexpr int kThreads = 32 * kQ;
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
  float4 red[kQ][32];
};

// The i side (the slice's rows, `table` and `run_off`) and the j side (the
// neighbour runs: `rows4_j`, `run_off_j`, `run_box_j`) may be two tables of
// one cell grid; `diag` says they are one table, whose own slot each row
// skips (two tables hold no body in common).
template <bool kPoly>
__device__ __forceinline__ void slice_sum(SliceShared& sh, const float4* __restrict__ rows4,
                                          const long long* __restrict__ table,
                                          const int* __restrict__ run_off,
                                          const float4* __restrict__ rows4_j,
                                          const int* __restrict__ run_off_j,
                                          const float* __restrict__ run_box_j, bool diag,
                                          int gc, int cap, const Consts& c, float G,
                                          float* __restrict__ acc, float* __restrict__ pe) {
  const int cell = blockIdx.x;
  const int s0 = blockIdx.y * 32;
  const int cnt = run_off[cell * (kOct + 1) + kOct];
  if (s0 >= cnt) return;
  const int rows = min(32, cnt - s0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int base = cell * cap + s0;

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
      start = id * cap + o0;
      len = reach ? o1 - o0 : 0;
    }
    run_start[t] = start;
    run_len[t] = len;
  }
  __syncthreads();

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
  const int self = diag ? base + src_i : -1;  // no slot of the j table is -1
  float4* const buf = sh.bufs[warp];
  int* const sbuf = sh.slot_bufs[warp];

  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // the row's running sums
  int fill = 0;                                    // rows in the warp's buffer
  for (int r = warp; r < kRuns; r += kQ) {
    const int len = run_len[r];
    const int start = run_start[r];
    for (int f0 = 0; f0 < len; f0 += 32) {
      const int f = f0 + lane;
      float4 q = make_float4(inf, inf, inf, 0.0f);
      if (f < len) q = rows4_j[start + f];
      const bool in = f < len && dist2_rd(gap_rd(lo_x, hi_x, q.x), gap_rd(lo_y, hi_y, q.y),
                                          gap_rd(lo_z, hi_z, q.z)) < reach2;
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (in) {
        buf[fill + __popc(m & below)] = q;
        sbuf[fill + __popc(m & below)] = start + f;
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
    const long long b = table[base + lane];
    acc[3 * b] = G * t.x;
    acc[3 * b + 1] = G * t.y;
    acc[3 * b + 2] = G * t.z;
    pe[b] = t.w;
  }
}

__global__ void __launch_bounds__(kThreads)
p3m_short_kernel(const float4* __restrict__ rows4, const long long* __restrict__ table,
                 const int* __restrict__ run_off, const float4* __restrict__ rows4_j,
                 const int* __restrict__ run_off_j, const float* __restrict__ run_box_j,
                 bool diag, int gc, int cap, const float* __restrict__ params, float G,
                 float eps2, float* __restrict__ acc, float* __restrict__ pe) {
  Consts c;
  c.rcut2 = params[0];
  c.alpha = params[1];
  c.a2 = c.alpha * c.alpha;
  c.a3 = c.a2 * c.alpha;
  c.cg = kTwoOverSqrtPi * c.alpha;
  c.k0 = 1.0f / sqrtf(eps2) - c.cg;
  c.eps2 = eps2;
  __shared__ SliceShared sh;
  // uniform: one split for the whole table
  if (c.a2 * c.rcut2 <= kSMax) {
    slice_sum<true>(sh, rows4, table, run_off, rows4_j, run_off_j, run_box_j, diag, gc, cap,
                    c, G, acc, pe);
  } else {
    slice_sum<false>(sh, rows4, table, run_off, rows4_j, run_off_j, run_box_j, diag, gc, cap,
                     c, G, acc, pe);
  }
}

// One block a cell: the reorder of ops/cuda_p3m.py::p3m_short_order, equal
// to it integer for integer and bit for bit on each cell's kept prefix. The
// prefix (count rows) gets its bounding box, each row the Morton code of its
// place in an 8^3 split of that box (the same float operations as the torch
// version), and its new place is its rank by (key, old place): a stable sort
// without atomics. Only the prefix is written: the sum reads no slot past
// it. The octant runs' row counts and boxes are integer atomics (counts, and
// min / max of the coordinates as order-preserving ints): exact, whatever
// the order.
__global__ void __launch_bounds__(kOrderThreads)
p3m_order_kernel(const float* __restrict__ cell_pos, const float* __restrict__ cell_m,
                 const long long* __restrict__ table, const int* __restrict__ count, int cap,
                 float4* __restrict__ rows4, long long* __restrict__ table_s,
                 int* __restrict__ run_off, float* __restrict__ run_box) {
  extern __shared__ unsigned short keys[];  // [cap]
  __shared__ float part[6][kOrderThreads / 32];
  __shared__ float box[6];
  __shared__ int oct_n[kOct];
  __shared__ int oct_box[kOct][6];
  const int cell = blockIdx.x;
  const int cnt = count[cell];
  const size_t base = static_cast<size_t>(cell) * cap;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inf = __int_as_float(0x7f800000);
  float v[6] = {inf, inf, inf, -inf, -inf, -inf};
  for (int k = threadIdx.x; k < cnt; k += kOrderThreads) {
    for (int a = 0; a < 3; ++a) {
      const float x = cell_pos[3 * (base + k) + a];
      v[a] = fminf(v[a], x);
      v[3 + a] = fmaxf(v[3 + a], x);
    }
  }
  for (int a = 0; a < 6; ++a) {
    v[a] = a < 3 ? warp_min(v[a]) : warp_max(v[a]);
    if (lane == 0) part[a][warp] = v[a];
  }
  if (threadIdx.x < kOct) {
    oct_n[threadIdx.x] = 0;
    for (int a = 0; a < 6; ++a) oct_box[threadIdx.x][a] = ordered(a < 3 ? inf : -inf);
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int a = threadIdx.x;
    float x = part[a][0];
    for (int w = 1; w < kOrderThreads / 32; ++w)
      x = a < 3 ? fminf(x, part[a][w]) : fmaxf(x, part[a][w]);
    box[a] = x;
  }
  __syncthreads();
  float lo[3], scale[3];
  for (int a = 0; a < 3; ++a) {
    lo[a] = box[a];
    scale[a] = 8.0f / fmaxf(box[3 + a] - box[a], 1e-30f);
  }
  for (int k = threadIdx.x; k < cnt; k += kOrderThreads) {
    int key = 0, oct = 0;
    for (int a = 0; a < 3; ++a) {
      const float x = cell_pos[3 * (base + k) + a];
      const int q = static_cast<int>(fminf(fmaxf(floorf((x - lo[a]) * scale[a]), 0.0f), 7.0f));
      key |= ((q & 1) | ((q & 2) << 2) | ((q & 4) << 4)) << (2 - a);
      oct = (oct << 1) | (q >> 2);
    }
    keys[k] = static_cast<unsigned short>(key);
    atomicAdd(&oct_n[oct], 1);
    for (int a = 0; a < 3; ++a) {
      const int x = ordered(cell_pos[3 * (base + k) + a]);
      atomicMin(&oct_box[oct][a], x);
      atomicMax(&oct_box[oct][3 + a], x);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cnt; k += kOrderThreads) {
    const unsigned short key = keys[k];
    int rank = 0;
    for (int t = 0; t < cnt; ++t) {
      const unsigned short kt = keys[t];
      rank += kt < key || (kt == key && t < k);
    }
    const size_t src = base + k, dst = base + rank;
    rows4[dst] = make_float4(cell_pos[3 * src], cell_pos[3 * src + 1], cell_pos[3 * src + 2],
                             cell_m[src]);
    table_s[dst] = table[src];
  }
  if (threadIdx.x == 0) {
    int off = 0;
    for (int o = 0; o < kOct; ++o) {
      run_off[cell * (kOct + 1) + o] = off;
      off += oct_n[o];
    }
    run_off[cell * (kOct + 1) + kOct] = off;
  }
  if (threadIdx.x < kOct * 6) {
    const int o = threadIdx.x / 6, a = threadIdx.x % 6;
    run_box[(static_cast<size_t>(cell) * kOct + o) * 6 + a] = unordered(oct_box[o][a]);
  }
}

}  // namespace

extern "C" {

// The two-table form (the body-sharded ring's round, ops/p3m.py
// p3m_ring_force): the rows of table i (rows4, table, run_off, as for
// p3m_short_sorted) summed against the rows of table j (rows4_j, run_off_j,
// run_box_j) in the 27 cells around each, both tables binned on one grid
// with one capacity. With diag = 1 the two are one table (the ring's own
// shard) and each row skips its own slot; with diag = 0 no pair is skipped
// (the tables hold different bodies). acc and pe as for p3m_short_sorted,
// for the bodies of table i.
int p3m_short_pair(const void* rows4, const void* table, const void* run_off,
                   const void* rows4_j, const void* run_off_j, const void* run_box_j, int diag,
                   int gc, int cap, const void* params, float G, float eps2, void* acc,
                   void* pe, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (gc <= 0 || cap <= 0) return cudaSuccess;
  if (!(eps2 > 0.0f)) return cudaErrorInvalidValue;
  const dim3 grid(gc * gc * gc, (cap + 31) / 32);
  p3m_short_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows4), static_cast<const long long*>(table),
      static_cast<const int*>(run_off), static_cast<const float4*>(rows4_j),
      static_cast<const int*>(run_off_j), static_cast<const float*>(run_box_j), diag != 0, gc,
      cap, static_cast<const float*>(params), G, eps2, static_cast<float*>(acc),
      static_cast<float*>(pe));
  return cudaGetLastError();
}

// rows4: [gc^3 * cap] float4 (x, y, z, m) of each cell's kept bodies, a
// prefix of its row, in the order of ops/cuda_p3m.py::p3m_short_order;
// table: [gc^3 * cap] int64 body indices in the same order; run_off:
// [gc^3, 9] int32 first row of each octant run in its cell, run_off[c][8]
// the cell's count; run_box: [gc^3, 8, 6] float (min x, y, z, max x, y, z)
// of each run, +inf / -inf when empty; params: [2] float on the device
// (rcut^2, alpha = 1 / (2 sigma)); acc: [n, 3] and pe: [n] float, zeroed by
// the caller (rows of bodies without a slot stay 0).
int p3m_short_sorted(const void* rows4, const void* table, const void* run_off,
                     const void* run_box, int gc, int cap, const void* params, float G,
                     float eps2, void* acc, void* pe, void* stream, int device) {
  return p3m_short_pair(rows4, table, run_off, rows4, run_off, run_box, 1, gc, cap, params, G,
                        eps2, acc, pe, stream, device);
}

// cell_pos: [gc^3 * cap, 3] and cell_m: [gc^3 * cap] float, table:
// [gc^3 * cap] int64 (p3m_cell_table's, the pad row dropped); count: [gc^3]
// int32. Writes each cell's kept prefix of rows4 [gc^3 * cap] float4 and
// table_s [gc^3 * cap] int64 (slots past it are left as they were), run_off
// [gc^3, 9] int32 and run_box [gc^3, 8, 6] float, as p3m_short_order
// returns them.
int p3m_short_order(const void* cell_pos, const void* cell_m, const void* table,
                    const void* count, int gc, int cap, void* rows4, void* table_s,
                    void* run_off, void* run_box, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (gc <= 0 || cap <= 0) return cudaSuccess;
  if (cap > 16384) return cudaErrorInvalidValue;  // the keys' shared memory
  p3m_order_kernel<<<gc * gc * gc, kOrderThreads, cap * sizeof(unsigned short),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cell_pos), static_cast<const float*>(cell_m),
      static_cast<const long long*>(table), static_cast<const int*>(count), cap,
      static_cast<float4*>(rows4), static_cast<long long*>(table_s),
      static_cast<int*>(run_off), static_cast<float*>(run_box));
  return cudaGetLastError();
}

// The launch shape: shape[0..4] = rows a block slice, warps, buffered rows
// that start a sweep, threads a block, blocks (cells x slices) at gc cells a
// side and capacity cap.
void p3m_short_shape(int gc, int cap, int* shape) {
  shape[0] = 32;
  shape[1] = kQ;
  shape[2] = kSweep;
  shape[3] = kThreads;
  shape[4] = gc * gc * gc * ((cap + 31) / 32);
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
