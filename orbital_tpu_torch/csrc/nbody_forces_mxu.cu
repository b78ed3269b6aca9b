// Gram-identity softened O(N^2) gravity for Hopper (sm_90a), with both
// products on the tensor cores.
//
// Replaces: orbital_tpu/ops/pallas_forces_mxu.py::_mxu_kernel (B13, the TPU
// sweep behind pairwise_acc_pallas_mxu), which puts the pair distances and
// the accumulation on the TPU's matrix unit at Precision.HIGHEST. The
// function is kept, Gram identity and its cancellation included:
//
//   r2_ij = A_i . B_j (8 deep),  A_i = (-2x, -2y, -2z, |r_i|^2, 1, 0, 0, 0),
//                                B_j = (x, y, z, 1, |r_j|^2, m, 0, 0)
//   w_ij  = m_j rsqrt(max(r2_ij, 0) + eps2)^3,   w_ii = 0 (masked)
//   S_i  += sum_j w_ij (x_j, y_j, z_j, 1)
//   pe_i += sum_j m_j rsqrt(max(r2_ij, 0) + eps2)      (kPE, i == j masked)
//
// and the wrapper forms acc = G (S[:, 0:3] - pos * S[:, 3]). The self
// diagonal is masked by global index and nothing is subtracted (its weight
// m_i eps^-3 would swamp the f32 sums), only on the tiles that hold it.
//
// What bounds it on this card: the one MUFU.RSQ a pair (16 a clock per SM:
// 1.03 ms at 65,536 bodies), then instruction issue and the latency of the
// dependent chain a pair runs through (three products, the weight, two
// products). What stays on the CUDA cores is the weight of each pair: the
// clamp, + eps2, one rsqrt, inv^3 (m_j is in the S product's B operand),
// its split into two TF32 pieces and (kPE) m inv and its sum, ~8 warp
// instructions a pair. The dot and the sums, 24 + 16 multiply-adds a pair,
// run on the tensor cores as mma.sync m16n8k8 TF32 products (5 a 16 x 8
// block of pairs).
//
// Precision: TF32 keeps 11 significant bits, and the identity cancels
// |r_i|^2 + |r_j|^2 against 2 r_i.r_j, so a plain TF32 product would lose
// the bits that set a close pair's r2 (as bf16 did on the TPU,
// pallas_forces_mxu.py:56-59). Each entry a of A and B is split exactly into
// three TF32 pieces, hi = rna(a), mid = rna(a - hi), lo = a - hi - mid (24
// significant bits in 33), so every piece product is exact in the f32
// accumulator. Of the nine piece products of each coordinate the six of
// magnitude >= 2^-22 are kept (hh, hm, mh, hl, mm, lh), and the three pieces
// of |r_i|^2 (times B's 1) and of |r_j|^2 (times A's 1): 24 K slots, three
// k8 products, largest first so that the terms of size |r|^2 cancel before
// the small ones join (the counterpart of the TPU's six-pass HIGHEST
// product). Two pieces (hh, hm and mh with the 3-piece norms, two
// products) missed the Gram gates on the card (PERF.md). The sums
// S = W [X_hi | X_lo] take w = inv^3 = w_hi + w_lo and the j side's
// m (x, y, z, 1) = X_hi + X_lo, each lo rounded to TF32 too (~2^-22 of
// the value). So r2 no longer has the plain version's one fixed order:
// on close pairs one ulp of r2 moves a weight by ~|r|^2 2^-24 / eps2, and
// the kernel and its plain version part by ~1e-3 of max |acc| there, as the
// TPU kernel's r2 does (S, which those rows dominate, by ~1e-3 in RMS: the
// plain version's own S is as far from the exact one).
//
// Design:
// - Fragment reuse (FlashAttention-2's, for TF32): in the m16n8k8 layouts a
//   thread's C fragment holds columns (2t, 2t+1) of rows g and g + 8 and its
//   A fragment columns (t, t + 4) of the same rows (g = lane / 4, t = lane %
//   4). The r2 product's B columns hold the chunk's 8 j bodies in the order
//   pi(2t) = t, pi(2t + 1) = t + 4, so the weights computed element by
//   element from the r2 fragment are the S product's A fragment, whose K
//   index is the j body in natural order: no shuffle.
//   tests/test_torch_forces_variants.py::
//   test_r2_columns_match_the_ptx_fragment_layouts reads pi from stage()
//   and the element order from sweep_tile() below and holds them against
//   the PTX layouts.
// - S = W_hi [X_hi | X_lo] + W_lo [X_hi | X_lo] in two products an 8-j
//   chunk, into two accumulators (two short dependent chains): B's columns
//   0-3 hold m (x, y, z, 1)'s hi pieces and 4-7 their lo pieces, and S_c =
//   D_c + D_(c+4) at the end.
// - Each warp holds kK m16 tiles of i rows (A split once into registers),
//   and each staged B fragment serves the kK tiles. The kQ warps of a block
//   share its 16 kK rows and split the j range: warp w sweeps j tiles w,
//   w + kQ, ... of 32 bodies, each lane staging one body (split into its
//   pieces and stored as the fragments the lanes read: two LDS.128 a chunk,
//   and one LDS.64 for pe) into the warp's own shared tile under
//   __syncwarp; each lane loads its body of the warp's next tile before it
//   sweeps this one.
// - The two-level sum: each j tile sums into a fresh accumulator that joins
//   the running sums in registers (a single tensor-core chain over 65,536 j
//   would add rounding that grows with N). At the end each warp folds its
//   lanes (fixed shuffles) and the kQ slices are added in shared memory in
//   warp order: no atomics, the same bits from run to run.
// - The tile that holds a row's own body runs a masked sweep after the
//   unmasked loop, so the inner loop has one form.
// - kK = 4, kQ = 4: 64 i rows and 128 threads a block, 1,024 blocks at
//   65,536 bodies, 168 registers (3 blocks an SM), no spills. The sweep
//   (chip_smoke.py --sweep; PERF.md) ran k = 4 at 3.0 ms (q = 2 8% slower),
//   k = 2 at 4.3 and k = 1 at 7.5: the loop is bound by the latency of the
//   chain each pair runs through (three dependent products, the weight, two
//   products) at ~50% of the issue rate, so more independent tiles a warp
//   win. Splitting the r2 chain into independent accumulators ran slower.
//   kK and kQ are the OT_MXU_K and OT_MXU_Q macros, which the sweep sets
//   with -D; phase 2
//   prints the shape, registers, SASS instructions a pair and the TF32 HMMA
//   count of the inner loop.
//
// N is a multiple of 128 (the wrapper's tile rule), so the j tiles (32) and
// the block's rows (16 kK, kK <= 8) divide it.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cstdint>

#include <cuda_runtime.h>

#ifndef OT_MXU_K
#define OT_MXU_K 4
#endif
#ifndef OT_MXU_Q
#define OT_MXU_Q 4
#endif

namespace {

constexpr int kK = OT_MXU_K;              // m16 tiles of i rows a warp
constexpr int kQ = OT_MXU_Q;              // warps a block, one j slice each
constexpr int kMma = 3;                   // r2 products a chunk
constexpr int kTile = 32;                 // j bodies a warp's tile, one a lane
constexpr int kChunks = kTile / 8;
constexpr int kRows = 16 * kK;            // i rows a block
constexpr int kThreads = 32 * kQ;
static_assert(kK >= 1 && 128 % kRows == 0 && kQ >= 1, "bad launch shape");

// A finite float rounded to TF32 (11 significant bits), to nearest with
// ties away from zero: the bits of cvt.rna.tf32.f32, which sm_90 lowers to
// ~5 instructions, in two (half an ulp of TF32 added to the magnitude bits,
// the low 13 cleared; a carry into the exponent is the right rounding).
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

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

// d += A B for one m16n8k8 TF32 product (fragments in the PTX ISA layout)
__device__ __forceinline__ void mma(float (&d)[4], const float (&a)[4], float b0, float b1) {
#ifdef __CUDA_ARCH__
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
#endif  // the host pass never calls it
}

struct Pieces {
  float h, m, l;
};

// the exact split a = h + m + l into TF32 pieces
__device__ __forceinline__ Pieces split(float a) {
  const float h = tf32(a);
  const float r = a - h;
  const float m = tf32(r);
  return {h, m, r - m};
}

// The K slots of the r2 products, largest first. i side (A): the pieces of
// (-2x, -2y, -2z) and of |r_i|^2; j side (B): those of (x, y, z), |r_j|^2.
//   A0 = (xh yh zh nh 1 xh yh zh)  B0 = (xh yh zh 1 nh xm ym zm)
//   A1 = (xm ym zm nm 1 xh yh zh)  B1 = (xh yh zh 1 nm xl yl zl)
//   A2 = (xm ym zm xl yl zl nl 1)  B2 = (xm ym zm xh yh zh 1 nl)
__device__ __forceinline__ void a_rows(const Pieces& x, const Pieces& y, const Pieces& z,
                                       const Pieces& n, float (&a)[kMma][8]) {
  const float r0[8] = {x.h, y.h, z.h, n.h, 1.0f, x.h, y.h, z.h};
  const float r1[8] = {x.m, y.m, z.m, n.m, 1.0f, x.h, y.h, z.h};
  const float r2[8] = {x.m, y.m, z.m, x.l, y.l, z.l, n.l, 1.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[0][k] = r0[k];
    a[1][k] = r1[k];
    a[2][k] = r2[k];
  }
}

__device__ __forceinline__ void b_rows(const Pieces& x, const Pieces& y, const Pieces& z,
                                       const Pieces& n, float (&b)[kMma][8]) {
  const float r0[8] = {x.h, y.h, z.h, 1.0f, n.h, x.m, y.m, z.m};
  const float r1[8] = {x.h, y.h, z.h, 1.0f, n.m, x.l, y.l, z.l};
  const float r2[8] = {x.m, y.m, z.m, x.h, y.h, z.h, 1.0f, n.l};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    b[0][k] = r0[k];
    b[1][k] = r1[k];
    b[2][k] = r2[k];
  }
}

// v[k] for a k known only at run time, without a local-memory array
__device__ __forceinline__ float pick(const float (&v)[8], int k) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) r = k == i ? v[i] : r;
  return r;
}

// A warp's shared tile: for chunk c and lane (g, t), bf = the r2 products'
// B fragments (B0[t], B0[t+4], B1[t], B1[t+4]) of body pi(g), cf = B2's
// (B2[t], B2[t+4]) and the S product's (X[t][g], X[t+4][g]) with X_j = the
// pieces (hi 0-3, lo 4-7) of m_j (x_j, y_j, z_j, 1), mp[c][t] = (m_t,
// m_(t+4)) for the pe sum.
struct WarpTile {
  float4 bf[kChunks][32];
  float4 cf[kChunks][32];
  float2 mp[kChunks][4];
};
static_assert(kQ * sizeof(WarpTile) <= 48 * 1024 && 5 * kRows * 4 <= sizeof(WarpTile),
              "the warps' tiles must fit in static shared memory and hold the row sums");

// Lane L stages its body (p = (x, y, z, 1), q = (|r_j|^2, m, 0, 0)) as slot
// s = L % 8 of chunk L / 8, in the B column n with pi(n) = s.
__device__ __forceinline__ void stage(WarpTile& w, float4 p, float4 q, int lane) {
  const int c = lane >> 3, s = lane & 7;
  const int n = s < 4 ? 2 * s : 2 * s - 7;
  const Pieces px = split(p.x), py = split(p.y), pz = split(p.z), pn = split(q.x);
  float b[kMma][8];
  b_rows(px, py, pz, pn, b);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    w.bf[c][4 * n + t] = make_float4(b[0][t], b[0][t + 4], b[1][t], b[1][t + 4]);
    *reinterpret_cast<float2*>(&w.cf[c][4 * n + t].x) = make_float2(b[2][t], b[2][t + 4]);
  }
  // m (x, y, z, 1) in two pieces: the weights w = inv^3 leave m_j to B
  const float mx = q.y * p.x, my = q.y * p.y, mz = q.y * p.z;
  const float hx = tf32(mx), hy = tf32(my), hz = tf32(mz), hm = tf32(q.y);
  const float x[8] = {hx, hy, hz, hm, tf32(mx - hx), tf32(my - hy), tf32(mz - hz),
                      tf32(q.y - hm)};
  float* col = reinterpret_cast<float*>(&w.cf[c][0]) + 4 * (s & 3) + 2 + (s >> 2);
#pragma unroll
  for (int g = 0; g < 8; ++g) col[16 * g] = x[g];
  reinterpret_cast<float*>(&w.mp[c][s & 3])[s >> 2] = q.y;
}

// One j tile into fresh partials: th[kk], tl[kk] the S fragments of W_hi
// and W_lo (columns 2t, 2t+1 of rows g, g + 8; two chains, not one), tp[kk]
// the pe of rows g and g + 8. With kMask, pairs whose global indices i
// (row0 + 16 kk + g, + 8) and j (j0 + 8 c + t, + 4) are equal get 0.
template <bool kPE, bool kMask>
__device__ __forceinline__ void sweep_tile(const WarpTile& w, const float (&af)[kK][kMma][4],
                                           float eps2, int lane, int row0, int j0,
                                           float (&th)[kK][4], float (&tl)[kK][4],
                                           float (&tp)[kK][2]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) th[kk][e] = tl[kk][e] = 0.0f;
    tp[kk][0] = tp[kk][1] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 f1 = w.bf[c][lane];
    const float4 f2 = w.cf[c][lane];
    float2 m = make_float2(0.0f, 0.0f);
    if (kPE) m = w.mp[c][t];
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma(d, af[kk][0], f1.x, f1.y);
      mma(d, af[kk][1], f1.z, f1.w);
      mma(d, af[kk][2], f2.x, f2.y);
      // d: (g, j t), (g, j t+4), (g+8, j t), (g+8, j t+4)
      float wt[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float inv = rsqrt_ftz(fmaxf(d[e], 0.0f) + eps2);
        wt[e] = inv * (inv * inv);
        float mi = kPE ? (e & 1 ? m.y : m.x) * inv : 0.0f;
        if (kMask) {
          const int i = row0 + 16 * kk + g + 8 * (e >> 1);
          const int j = j0 + 8 * c + t + 4 * (e & 1);
          if (i == j) wt[e] = mi = 0.0f;
        }
        if (kPE) tp[kk][e >> 1] += mi;
      }
      // the S product's A fragment: (g, t), (g+8, t), (g, t+4), (g+8, t+4)
      float hi[4], lo[4];
      const int order[4] = {0, 2, 1, 3};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = tf32(wt[order[e]]);
        lo[e] = wt[order[e]] - hi[e];
      }
      mma(th[kk], hi, f2.z, f2.w);
      mma(tl[kk], lo, f2.z, f2.w);
    }
  }
}

// the tile's partials into the running sums
template <bool kPE>
__device__ __forceinline__ void add_tile(float (&rs)[kK][4], float (&rp)[kK][2],
                                         const float (&th)[kK][4], const float (&tl)[kK][4],
                                         const float (&tp)[kK][2]) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) rs[kk][e] += th[kk][e] + tl[kk][e];
    if (kPE) {
      rp[kk][0] += tp[kk][0];
      rp[kk][1] += tp[kk][1];
    }
  }
}

template <bool kPE>
__global__ void __launch_bounds__(kThreads, 1)
gram_kernel(const float4* __restrict__ iA, const float4* __restrict__ jB, int n, float eps2,
            float4* __restrict__ sums, float* __restrict__ pe_row) {
  __shared__ WarpTile tiles[kQ];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int base = blockIdx.x * kRows;

  // the i side's A fragments, split once
  float af[kK][kMma][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float4 a = iA[2 * (base + 16 * kk + g + 8 * half)];  // (-2x, -2y, -2z, |r|^2)
      float rows[kMma][8];
      a_rows(split(a.x), split(a.y), split(a.z), split(a.w), rows);
#pragma unroll
      for (int mm = 0; mm < kMma; ++mm) {
        af[kk][mm][half] = pick(rows[mm], t);
        af[kk][mm][2 + half] = pick(rows[mm], t + 4);
      }
    }
  }

  float rs[kK][4], rp[kK][2];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    rs[kk][0] = rs[kk][1] = rs[kk][2] = rs[kk][3] = 0.0f;
    rp[kk][0] = rp[kk][1] = 0.0f;
  }
  WarpTile& tile = tiles[warp];
  float th[kK][4], tl[kK][4], tp[kK][2];
  // the tiles that hold a row's own body: [first, last)
  const int tiles_n = n / kTile;
  const int first = base / kTile, last = (base + kRows + kTile - 1) / kTile;
  // this lane's body of the next tile, loaded a tile ahead (an L2 read's
  // latency hidden behind a tile's sweep)
  float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f), q = p;
  if (warp < tiles_n) {
    p = jB[2 * (warp * kTile + lane)];
    q = jB[2 * (warp * kTile + lane) + 1];
  }
  for (int jt = warp; jt < tiles_n; jt += kQ) {
    const float4 pj = p, qj = q;
    if (jt + kQ < tiles_n) {
      p = jB[2 * ((jt + kQ) * kTile + lane)];
      q = jB[2 * ((jt + kQ) * kTile + lane) + 1];
    }
    if (jt >= first && jt < last) continue;
    stage(tile, pj, qj, lane);
    __syncwarp();
    sweep_tile<kPE, false>(tile, af, eps2, lane, base, jt * kTile, th, tl, tp);
    add_tile<kPE>(rs, rp, th, tl, tp);
    __syncwarp();
  }
  for (int jt = first; jt < last; ++jt) {
    if (jt % kQ != warp) continue;
    stage(tile, jB[2 * (jt * kTile + lane)], jB[2 * (jt * kTile + lane) + 1], lane);
    __syncwarp();
    sweep_tile<kPE, true>(tile, af, eps2, lane, base, jt * kTile, th, tl, tp);
    add_tile<kPE>(rs, rp, th, tl, tp);
    __syncwarp();
  }

  // fold the warp's lanes: S_c = D_c + D_(c+4) (lanes t and t + 2 of a quad)
  // and pe over the quad; then rows x (Sx, Sy, Sz, S1, pe) in the warp's tile
  float* out = reinterpret_cast<float*>(&tile);
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float s0 = rs[kk][2 * half] + __shfl_down_sync(0xffffffffu, rs[kk][2 * half], 2);
      const float s1 =
          rs[kk][2 * half + 1] + __shfl_down_sync(0xffffffffu, rs[kk][2 * half + 1], 2);
      float pe = rp[kk][half];
      if (kPE) {
        pe += __shfl_xor_sync(0xffffffffu, pe, 1);
        pe += __shfl_xor_sync(0xffffffffu, pe, 2);
      }
      const int r = 16 * kk + g + 8 * half;
      if (t < 2) {
        out[5 * r + 2 * t] = s0;
        out[5 * r + 2 * t + 1] = s1;
      }
      if (t == 0) out[5 * r + 4] = pe;
    }
  }
  __syncthreads();
  // the kQ slices of each row, added in warp order
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const float* w0 = reinterpret_cast<const float*>(&tiles[0]) + 5 * r;
    float a[5] = {w0[0], w0[1], w0[2], w0[3], w0[4]};
    for (int qq = 1; qq < kQ; ++qq) {
      const float* wq = reinterpret_cast<const float*>(&tiles[qq]) + 5 * r;
#pragma unroll
      for (int e = 0; e < 5; ++e) a[e] += wq[e];
    }
    sums[base + r] = make_float4(a[0], a[1], a[2], a[3]);
    if (kPE) pe_row[base + r] = a[4];
  }
}

}  // namespace

extern "C" {

// iA: [n, 8] f32 rows (-2x, -2y, -2z, |r|^2, 1, 0, 0, 0); jB: [n, 8] f32
// rows (x, y, z, 1, |r|^2, m, 0, 0); n a multiple of 128; sums: [n] float4
// (S_x, S_y, S_z, S_1); pe_row: [n] float (written when with_pe); eps2 > 0.
int nbody_forces_mxu(const void* iA, const void* jB, int n, float eps2, int with_pe,
                     void* sums, void* pe_row, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!(eps2 > 0.0f) || n <= 0 || n % 128 != 0) return cudaErrorInvalidValue;
  const auto* a = static_cast<const float4*>(iA);
  const auto* b = static_cast<const float4*>(jB);
  auto* s = static_cast<float4*>(sums);
  auto* pe = static_cast<float*>(pe_row);
  auto st = static_cast<cudaStream_t>(stream);
  if (with_pe) gram_kernel<true><<<n / kRows, kThreads, 0, st>>>(a, b, n, eps2, s, pe);
  else gram_kernel<false><<<n / kRows, kThreads, 0, st>>>(a, b, n, eps2, s, pe);
  return cudaGetLastError();
}

// The launch shape at n rows: shape[0..4] = m16 tiles of i rows a warp,
// warps (j slices) a block, j bodies a tile, threads a block, blocks.
void nbody_forces_mxu_shape(int n, int* shape) {
  shape[0] = kK;
  shape[1] = kQ;
  shape[2] = kTile;
  shape[3] = kThreads;
  shape[4] = n / kRows;
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
