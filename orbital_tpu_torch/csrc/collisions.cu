// Restitution bounce sweep for Hopper (sm_90a).
//
// Replaces: orbital_tpu/ops/pallas_collisions.py::_collision_kernel (the TPU
// sweep behind bounce_deltas_pallas). For every approaching overlapping pair
// (i, j), with dd = r_j - r_i, dv = v_j - v_i, s = dd . dv:
//
//   touching = r2 <= (R_i + R_j)^2  and  r2 > 0  and  s < 0  and  m_i, m_j > 0
//   base     = m_i^-1 / (m_i^-1 + m_j^-1)
//   dvel_i  += (1 + e) s / r2 * base * dd
//   dpos_i  -= ((R_i + R_j) / |dd| - 1) * base * dd
//
// which is the reference's impulse plus mass-weighted de-overlap
// (core/physics.py:391-422) summed per body. Distances are unsoftened.
//
// What bounds it on this card: instruction issue, and almost all of it is
// the rejection of pairs that do not touch. Only touching pairs pay the
// velocity dot product, one rsqrtf and two reciprocals. Device memory
// traffic is O(N) a block (32 bytes a j body) and stays in L2.
//
// Design (the register-tiled template of csrc/nbody_forces.cu):
// - Each thread holds kK i bodies in registers (rows base + lane + 32 k of
//   its block: position and radius, velocity and mass, 1/m), so each j
//   entry read from shared memory serves kK pairs.
// - Each block covers 32 kK i bodies with kQ warps. Warp w sweeps its own
//   slice of the j range, tiles w, w + kQ, ... of kTile bodies, staged by
//   the warp into its own shared tiles of two float4: (x, y, z, R), which is
//   all the rejection reads, and (vx, vy, vz, m * alive), read only for
//   pairs that pass it. A warp barrier guards them, so warps run alone.
// - The prefilter (B2's): the sweep keeps each row's nearest r2 in the tile,
//   one FMNMX a pair after the three differences and the r2 chain. Once a
//   tile, a row runs the exact pass over that tile only if its nearest r2 is
//   within ((R_i + max R_j) * 1.0001)^2, the largest radius staged in the
//   tile: a superset of the exact test, since rounding is monotone and both
//   read one r2 (dist2). Contacts are rare, so nearly every tile costs ~7
//   instructions a pair. The exact pass (bounce_pair) keeps its arithmetic
//   and its j order within the tile.
// - Each warp's deltas of its rows are added to the other slices' in shared
//   memory in the fixed order w = 0, 1, ...: no atomics. A body with one
//   touching partner gets its one contribution plus zeros.
// - The ragged last tile is cut by its own trip count; rows past n are
//   swept as dead bodies and not written.
// - kK = 4, kQ = 8: 128 i bodies and 256 threads a block, 512 blocks at
//   65,536 bodies, 104 registers, no spills, 7.5 SASS instructions a pair.
//   The sweep (chip_smoke.py --sweep; PERF.md) ran k = 4 at q = 4 and 8
//   alike, k = 2 11-22% and k = 1 45% slower. kK and kQ are the
//   OT_BOUNCE_K and OT_BOUNCE_Q macros, which the sweep sets with -D.
// The kernel reads the state's own arrays (pos, vel [N, 3], mass,
// radius [N] f32, alive [N] bool) and builds the tiles itself: the wrapper
// packs nothing, so a gated step queues this launch and nothing else. Dead
// and padding bodies get m = 0 and never touch, so their rows come out
// exactly 0. The test runs on r2 before any product of the difference could
// overflow: live-to-parked r2 is ~3e34, finite in f32, and is never squared
// again.
//
// The gate: the optional `contacts` pointer is the int32 count that the
// force sweep with detection (B2) left on the device. When it is <= 0 every
// block writes zeros and returns at entry, so a contact-free step costs one
// launch instead of an O(N^2) sweep, the on-card form of the TPU stepper's
// lax.cond skip. With a null pointer the sweep always runs.
//
// The block bounce (bounce_block_kernel; no TPU kernel: it stands in for the
// XLA code of orbital_tpu/parallel/sharded.py:72-117, _block_bounce, the
// multi-device ring's impulses of a visiting shard j on the local shard i):
// the i side reads (pos_i, vel_i, mass_i, radius_i, alive_i), the j side
// (pos_j, vel_j, mass_j, radius_j, alive_j), in place. A self pair of the
// ring's diagonal round has r2 = 0 and fails the touching test, so no pair
// is excluded by index. Its sweep is B6's (sweep_rows: the same tiles, the
// prefilter, bounce_pair and the j order within a tile), on a launch of its
// own for the ring's shapes:
// - What bounded the first version (B6's kernel and launch over separate
//   tables) at the ring's 16,384^2 (4 ranks) and 8,192^2 (8): its
//   launch, n_i / 128 blocks of 8 warps under one block an SM, so 128 and
//   64 blocks on 132 SMs with a quarter or an eighth of the j work each, at
//   ~52% of the issue rate (0.116 ms with 2 contacts, 34% of its bound); and
//   at a count of 0, the step's usual case on the ring, the wrapper's host
//   time (0.072 ms by CUDA events for a launch that writes zeros).
// - The j range is split across blocks as well as across warps
//   (ops/cuda_collisions.py::bounce_plan, B3's cuda_forces.block_plan at
//   this kernel's shape, by the least critical path): block u takes i tile
//   u % tiles (kBRows rows) against j split u / tiles, 2 splits at 16,384^2
//   and 4 at 8,192^2, 256 blocks in one wave over the 132 SMs (4 and 8
//   splits, two blocks on every SM in two waves, ran 3% and 10% slower:
//   chip_smoke.py --ring-variants, an H100 at 700 W). The kBQ warps'
//   deltas of a row are added in warp order in shared memory; with one
//   split that is the round's sum, else the split's partial, and the last
//   block of the i tile to finish (an integer counter a tile behind a
//   __threadfence, which it resets) adds the tile's partials in split
//   order: no float atomics, so reruns are bit-equal. With one split and
//   kBQ = kQ a row's sum is B6's, bit for bit, on coinciding tables.
// - Accumulate mode (the ring's rounds after the first): the round's sum is
//   added to dpos and dvel in place, out = out + sum, the single rounding of
//   the caller's dpos + dp, so the ring needs no eager add a round.
// - The gate at a count of 0: in write mode the blocks of split 0 write
//   their tile's zeros and every other block returns at entry; in
//   accumulate mode every block returns at entry. No block touches the
//   partials or the counters then, so they stay reset.
// - kBK = 4, kBQ = 8 and two blocks an SM (__launch_bounds__(256, 2): 128
//   registers at most; it takes 106, no spills) are the OT_BBOUNCE_K, _Q
//   and _MIN macros, which chip_smoke.py --ring-variants sets with -D: 4 x 4
//   with four blocks an SM ran within 1% (but parts from B6's order), 3 and
//   2 i bodies a thread with three blocks an SM 15% and 12% slower.
// - What bounds it now: instruction issue at ~64% of the issue rate (0.093
//   ms at 16,384^2 with 2 contacts, 7.5 SASS instructions a pair, an issue
//   floor of 0.060 ms; 0.034 ms at 8,192^2), each warp sweeping 8 and 2
//   tiles between its staging and the splits' sum; and at a count of 0 the
//   wrapper's host time (0.016 ms a round added in place by CUDA events, in
//   turns against 0.049 for the first version's round and eager add;
//   chip_smoke.py phase 60, --parent and --ring-variants, an H100 80GB HBM3
//   at 700 W).
//
// The block bounce's f64 instance (bounce_block_f64_kernel, for f64 state
// under a mesh: JAX's _block_bounce runs in the state's dtype): the port's
// plain block bounce (ops/cuda_collisions.py::bounce_block_plain) in
// double, on the f32 instance's launch plan, with its gate, its split sums
// in split order and its accumulate mode, all in double. Each pair's tests
// are the plain version's correctly rounded double operations (dd = r_j -
// r_i, r2 = (ddx ddx + ddy ddy) + ddz ddz <= (R_i + R_j)^2, r2 > 0, m_j > 0, s
// < 0; no FMA), and a touching pair's impulse and de-overlap take one
// reciprocal square root, as the plain version's. The rejection is B6's
// prefilter on the f32 cast of the tables (a row's nearest f32 r2 in the
// tile) against a bound rounded outward (reach2, the argument of
// nbody_forces.cu's B3 detect f64 instance with c0 = 1: the cast's error
// at the row's and the tile's largest |coordinate| of a live body, and the
// tile's largest radius of a live body); only a flagged row of a flagged
// tile runs the double pass, reading its own and the tile's f64 rows in
// place. Each warp's deltas of its rows meet in shared memory in warp
// order.
//
// Its redesign: the first version ran at 0.1246 ms with 2
// contacts at 16,384^2, 1.32x its f32 sibling's 0.0942 (an H100 80GB HBM3
// at 700 W), on the same sweep. The difference was the staging (each j row
// cast from its f64 values, its liveness read from alive and the f64 mass,
// a second butterfly a tile for the tile's largest |coordinate|, in every
// block that staged it), which depends on the j shard alone, and its
// deltas: 24 doubles a thread in local memory, behind a serial double pass
// a flagged row. Now:
// - The cast view of a shard, one float buffer of n rows: (x, y, z, R)
//   [n] float4 as in_f32 casts them, R NaN unless alive and mass > 0 (in
//   double: a positive mass below 2^-150 is 0 in f32 and still live),
//   then for each 128-row tile the largest R and |coordinate| of its live
//   rows (0 where none). The ring's diagonal round writes the rank's view
//   as it stages (the blocks of i tile 0; no launch is added, and at a
//   count of 0 nothing is written or read), and the view travels round the
//   ring with the f64 tables; the later rounds stage one float4 a row from
//   the visitor's view, their i rows from the rank's own, and take each
//   tile's maxima from it. reach2's argument holds: the tile's maxima bound
//   every live row's.
// - The double pass of a flagged row is the warp's: lane L takes columns
//   L, L + 32, L + 64 and L + 96 of the tile, and the touching columns'
//   terms join the row's deltas one at a time in column order (a ballot,
//   lowest lane first), each rounded once, so a row's sum is the serial
//   pass's, term for term. The deltas sit in shared memory (6 doubles a
//   row a warp beside the warp's tile: 64 KB a block, dynamic), not in
//   local memory or registers.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 69 and --parent
// against the first version's build): 0.0895 ms with 2 contacts at
// 16,384^2 reading the views, in turns with the f32 instance's 0.0943;
// rank 0's four rounds 0.455 ms against the first version's 0.564; 7.56
// SASS instructions a pair, 88 registers, no spills; the same bits.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

#ifndef OT_BOUNCE_K
#define OT_BOUNCE_K 4
#endif
#ifndef OT_BOUNCE_Q
#define OT_BOUNCE_Q 8
#endif
#ifndef OT_BBOUNCE_K
#define OT_BBOUNCE_K 4
#endif
#ifndef OT_BBOUNCE_Q
#define OT_BBOUNCE_Q 8
#endif
#ifndef OT_BBOUNCE_MIN
#define OT_BBOUNCE_MIN 2
#endif

namespace {

constexpr int kK = OT_BOUNCE_K;  // i bodies a thread
constexpr int kQ = OT_BOUNCE_Q;  // warps a block, one j slice each
constexpr int kTile = 128;       // j bodies a warp's tile
constexpr int kThreads = 32 * kQ;
constexpr int kRows = 32 * kK;   // i bodies a block
// the block bounce: i bodies a thread, warps a block and the blocks an SM
// its registers are capped for
constexpr int kBK = OT_BBOUNCE_K;
constexpr int kBQ = OT_BBOUNCE_Q;
constexpr int kBMin = OT_BBOUNCE_MIN;
constexpr int kBThreads = 32 * kBQ;
constexpr int kBRows = 32 * kBK;
static_assert(kK >= 1 && kQ >= 1 && kTile % 32 == 0, "bad launch shape");
static_assert(kBK >= 1 && kBQ >= 1 && kBMin >= 1, "bad block launch shape");
static_assert(kQ * kTile * 32 <= 48 * 1024 && 6 * kRows <= 8 * kTile &&
                  kBQ * kTile * 32 <= 48 * 1024 && 6 * kBRows <= 8 * kTile,
              "the warps' tiles must fit in static shared memory and hold the deltas");
static_assert(kBRows <= kBThreads, "the f64 instance sums a row a thread");
// the f64 instance's dynamic shared memory: each warp's (x, y, z, R) tile,
// then each warp's deltas of the block's rows, [warp][6][kBRows] doubles
constexpr int kF64Smem = kBQ * kTile * 16 + kBQ * 6 * kBRows * 8;

struct Deltas {
  float vx = 0.0f, vy = 0.0f, vz = 0.0f, px = 0.0f, py = 0.0f, pz = 0.0f;
};

// |r_j - r_i|^2 in one rounding order, shared by the prefilter and the
// exact test
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
}

// The largest |coordinate| of a cast row (x, y, z).
__device__ __forceinline__ float coord_scale(float4 p) {
  return fmaxf(fabsf(p.x), fmaxf(fabsf(p.y), fabsf(p.z)));
}

// The f32 prefilter's bound on the f32 r2 (dist2 of the cast rows) of any
// pair that an exact f64 test r2 <= (s c0)^2 keeps (nbody_forces.cu, B3
// detect's f64 instance, states the argument): rsum >= R^_i + R^_j of the
// cast radii, scale >= a_i + a_j, c >= c0 (1 + 2^-50) / (1 - 2^-24); rounded
// upward, +inf where it overflows, NaN where a radius is.
__device__ __forceinline__ float reach2(float rsum, float scale, float c) {
  const float e = __fmaf_ru(scale, 0x1.000002p-24f, 0x1p-149f);
  const float lin = __fmaf_ru(e, 1.7320510f, __fmul_ru(__fadd_ru(rsum, 0x1p-149f), c));
  return __fadd_ru(__fmul_ru(__fmul_ru(lin, lin), 1.0f + 0x1p-20f), 0x1p-146f);
}

// One pair, i's view: add the impulse and de-overlap of an approaching
// overlapping pair to d.
__device__ __forceinline__ void bounce_pair(float4 gi, float4 ki, float inv_mi, float e,
                                            float4 gj, const float4* kj_ptr, Deltas& d) {
  const float ddx = gj.x - gi.x;
  const float ddy = gj.y - gi.y;
  const float ddz = gj.z - gi.z;
  const float r2 = dist2(ddx, ddy, ddz);
  const float rsum = gi.w + gj.w;
  if (r2 > rsum * rsum || !(r2 > 0.0f)) return;
  const float4 kj = *kj_ptr;
  const float s = ddx * (kj.x - ki.x) + ddy * (kj.y - ki.y) + ddz * (kj.z - ki.z);
  if (!(s < 0.0f) || !(kj.w > 0.0f)) return;
  const float inv_d = rsqrtf(r2);
  const float base = __frcp_rn(inv_mi + __frcp_rn(kj.w)) * inv_mi;
  const float fv = (1.0f + e) * s * (inv_d * inv_d) * base;
  const float h = (rsum * inv_d - 1.0f) * base;
  d.vx += fv * ddx;
  d.vy += fv * ddy;
  d.vz += fv * ddz;
  d.px -= h * ddx;
  d.py -= h * ddy;
  d.pz -= h * ddz;
}

// each row's nearest r2 over the tile's first `count` bodies
template <int K>
__device__ __forceinline__ void nearest_tile(const float4* gtile, int count,
                                             const float4 (&gi)[K], float (&nearest)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) nearest[k] = __int_as_float(0x7f800000);  // +inf
#pragma unroll 4
  for (int jj = 0; jj < count; ++jj) {
    const float4 gj = gtile[jj];
#pragma unroll
    for (int k = 0; k < K; ++k)
      nearest[k] = fminf(nearest[k], dist2(gj.x - gi[k].x, gj.y - gi[k].y, gj.z - gi[k].z));
  }
}

__device__ __forceinline__ float4 geo_of(const float* pos, const float* radius, int j) {
  return make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], radius[j]);
}

__device__ __forceinline__ float4 kin_of(const float* vel, const float* mass,
                                         const bool* alive, int j) {
  return make_float4(vel[3 * j], vel[3 * j + 1], vel[3 * j + 2],
                     (alive == nullptr || alive[j]) ? mass[j] : 0.0f);
}

// One side's arrays: positions and velocities [n, 3], mass and radius [n]
// f32, alive [n] bool or null.
struct Side {
  const float* __restrict__ pos;
  const float* __restrict__ vel;
  const float* __restrict__ mass;
  const float* __restrict__ radius;
  const bool* __restrict__ alive;
  int n;
};

// The deltas of rows base + lane + 32 k (k < K) of si from the j bodies
// [j_lo, j_hi) of sj: warp w of the Q sweeps tiles j_lo + w kTile, + Q kTile,
// ..., each staged by the warp into its own (x, y, z, R) and (v, m) tiles,
// prefiltered on the tile's nearest r2, then the exact pass in j order. Each
// warp's own deltas of its rows come out in d.
template <int K, int Q>
__device__ __forceinline__ void sweep_rows(const Side& si, const Side& sj, int base, int j_lo,
                                           int j_hi, float e, float4 (*tiles)[2][kTile],
                                           Deltas (&d)[K]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = si.n;
  float4 gi[K], ki[K];
  float inv_mi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = base + lane + 32 * k;
    gi[k] = i < n ? geo_of(si.pos, si.radius, i) : make_float4(0.f, 0.f, 0.f, 0.f);
    ki[k] = i < n ? kin_of(si.vel, si.mass, si.alive, i) : make_float4(0.f, 0.f, 0.f, 0.f);
    inv_mi[k] = ki[k].w > 0.0f ? __frcp_rn(ki[k].w) : 0.0f;
  }
  float4* gtile = tiles[warp][0];
  float4* ktile = tiles[warp][1];
  for (int j0 = j_lo + warp * kTile; j0 < j_hi; j0 += Q * kTile) {
    float rmax = 0.0f;  // the largest radius this lane staged
#pragma unroll
    for (int r = lane; r < kTile; r += 32) {
      if (j0 + r < j_hi) {
        gtile[r] = geo_of(sj.pos, sj.radius, j0 + r);
        ktile[r] = kin_of(sj.vel, sj.mass, sj.alive, j0 + r);
        rmax = fmaxf(rmax, gtile[r].w);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
    __syncwarp();
    const int count = min(kTile, j_hi - j0);
    float nearest[K];
    if (count == kTile) nearest_tile<K>(gtile, kTile, gi, nearest);
    else nearest_tile<K>(gtile, count, gi, nearest);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float rsum = (gi[k].w + rmax) * 1.0001f;
      if (ki[k].w > 0.0f && nearest[k] <= rsum * rsum) {
        for (int jj = 0; jj < count; ++jj)
          bounce_pair(gi[k], ki[k], inv_mi[k], e, gtile[jj], &ktile[jj], d[k]);
      }
    }
    __syncwarp();
  }
}

// Each warp's deltas of its rows into its own tiles (after the sweep's
// last warp barrier), 6 floats a row: v, then p.
template <int K>
__device__ __forceinline__ void stash_deltas(float4 (*tiles)[2][kTile], const Deltas (&d)[K]) {
  const int lane = threadIdx.x & 31;
  float* mine = reinterpret_cast<float*>(tiles[threadIdx.x >> 5][0]);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float* row = mine + 6 * (lane + 32 * k);
    row[0] = d[k].vx;
    row[1] = d[k].vy;
    row[2] = d[k].vz;
    row[3] = d[k].px;
    row[4] = d[k].py;
    row[5] = d[k].pz;
  }
}

// The Q warps' stashed deltas of block row r, added in warp order.
template <int Q>
__device__ __forceinline__ void warp_sum(float4 (*tiles)[2][kTile], int r, float (&a)[6]) {
  const float* w0 = reinterpret_cast<const float*>(tiles[0]) + 6 * r;
#pragma unroll
  for (int c = 0; c < 6; ++c) a[c] = w0[c];
  for (int q = 1; q < Q; ++q) {
    const float* wq = reinterpret_cast<const float*>(tiles[q]) + 6 * r;
#pragma unroll
    for (int c = 0; c < 6; ++c) a[c] += wq[c];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
bounce_kernel(Side si, Side sj, float e, const int* __restrict__ contacts,
              float* __restrict__ dpos, float* __restrict__ dvel) {
  const int base = blockIdx.x * kRows;
  const int n = si.n;
  if (contacts != nullptr && *contacts <= 0) {  // uniform: one count for all
    for (int r = threadIdx.x; r < kRows && base + r < n; r += kThreads) {
      const int i = base + r;
      dvel[3 * i + 0] = dvel[3 * i + 1] = dvel[3 * i + 2] = 0.0f;
      dpos[3 * i + 0] = dpos[3 * i + 1] = dpos[3 * i + 2] = 0.0f;
    }
    return;
  }
  __shared__ float4 tiles[kQ][2][kTile];  // a warp's (x, y, z, R) and (v, m) tiles
  Deltas d[kK];
  sweep_rows<kK, kQ>(si, sj, base, 0, sj.n, e, tiles, d);
  stash_deltas<kK>(tiles, d);
  __syncthreads();
  for (int r = threadIdx.x; r < kRows && base + r < n; r += kThreads) {
    float a[6];
    warp_sum<kQ>(tiles, r, a);
    const int i = base + r;
    dvel[3 * i + 0] = a[0];
    dvel[3 * i + 1] = a[1];
    dvel[3 * i + 2] = a[2];
    dpos[3 * i + 0] = a[3];
    dpos[3 * i + 1] = a[4];
    dpos[3 * i + 2] = a[5];
  }
}

// Row i's round sum a into dvel and dpos: written, or added to them.
template <typename T>
__device__ __forceinline__ void emit(const T (&a)[6], int i, bool accumulate,
                                     T* __restrict__ dpos, T* __restrict__ dvel) {
  if (accumulate) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dvel[3 * i + c] = dvel[3 * i + c] + a[c];
      dpos[3 * i + c] = dpos[3 * i + c] + a[3 + c];
    }
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dvel[3 * i + c] = a[c];
      dpos[3 * i + c] = a[3 + c];
    }
  }
}

// The block bounce on its launch plan: block u sweeps i tile u % tiles
// against j split u / tiles (split_len bodies, whole tiles). part: [splits *
// n_i * 6] float scratch (unused with one split), done: [tiles] counters, 0
// on entry and left 0.
__global__ void __launch_bounds__(kBThreads, kBMin)
bounce_block_kernel(Side si, Side sj, float e, const int* __restrict__ contacts, int tiles,
                    int splits, int split_len, int accumulate, float* __restrict__ part,
                    unsigned int* __restrict__ done, float* __restrict__ dpos,
                    float* __restrict__ dvel) {
  const int tile_i = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int base = tile_i * kBRows;
  const int n = si.n;
  if (contacts != nullptr && *contacts <= 0) {  // uniform: one count for all
    if (accumulate || split > 0) return;
    for (int r = threadIdx.x; r < kBRows && base + r < n; r += kBThreads) {
      const int i = base + r;
      dvel[3 * i + 0] = dvel[3 * i + 1] = dvel[3 * i + 2] = 0.0f;
      dpos[3 * i + 0] = dpos[3 * i + 1] = dpos[3 * i + 2] = 0.0f;
    }
    return;
  }
  __shared__ float4 tiles_s[kBQ][2][kTile];
  __shared__ bool last;
  Deltas d[kBK];
  const int j_lo = split * split_len;
  sweep_rows<kBK, kBQ>(si, sj, base, j_lo, min(j_lo + split_len, sj.n), e, tiles_s, d);
  stash_deltas<kBK>(tiles_s, d);
  __syncthreads();
  for (int r = threadIdx.x; r < kBRows && base + r < n; r += kBThreads) {
    float a[6];
    warp_sum<kBQ>(tiles_s, r, a);
    if (splits == 1) {
      emit(a, base + r, accumulate, dpos, dvel);
    } else {
      float* p = part + (static_cast<size_t>(split) * n + base + r) * 6;
#pragma unroll
      for (int c = 0; c < 6; ++c) p[c] = a[c];
    }
  }
  if (splits == 1) return;
  // the last split of this i tile to finish adds the splits in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&done[tile_i], 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r = threadIdx.x; r < kBRows && base + r < n; r += kBThreads) {
    float a[6];
    const float* p0 = part + (static_cast<size_t>(base) + r) * 6;
#pragma unroll
    for (int c = 0; c < 6; ++c) a[c] = __ldcg(p0 + c);
    for (int q = 1; q < splits; ++q) {
      const float* pq = part + (static_cast<size_t>(q) * n + base + r) * 6;
#pragma unroll
      for (int c = 0; c < 6; ++c) a[c] += __ldcg(pq + c);
    }
    emit(a, base + r, accumulate, dpos, dvel);
  }
  if (threadIdx.x == 0) done[tile_i] = 0u;
}

// ---- the block bounce's f64 instance ----

// One side's f64 arrays: positions and velocities [n, 3], mass and radius
// [n] double, alive [n] bool or null.
struct Side64 {
  const double* __restrict__ pos;
  const double* __restrict__ vel;
  const double* __restrict__ mass;
  const double* __restrict__ radius;
  const bool* __restrict__ alive;
  int n;
};

__device__ __forceinline__ bool live64(const Side64& s, int i) {
  return (s.alive == nullptr || s.alive[i]) && s.mass[i] > 0.0;
}

// The cast (x, y, z, R) of body j, R NaN where it cannot touch: as
// utils.kernels.in_f32 casts a value (clamped to +-2^100, then rounded).
__device__ __forceinline__ float cast32(double x) {
  const double big = 0x1p100;
  return __double2float_rn(x < -big ? -big : (x > big ? big : x));
}

__device__ __forceinline__ float4 geo_of64(const Side64& s, int j) {
  return make_float4(cast32(s.pos[3 * j]), cast32(s.pos[3 * j + 1]), cast32(s.pos[3 * j + 2]),
                     live64(s, j) ? cast32(s.radius[j]) : __int_as_float(0x7fc00000));
}

// Row i of si (live) against the bodies j0, ..., j0 + count - 1 of sj, the
// warp's: the plain version's pair in double, its tests correctly rounded;
// lane L takes columns L + 32 c, and the touching columns' terms join the
// row's deltas d[c kBRows] (c = 0..5: v, then p; shared memory) one at a
// time in column order, each rounded once before it joins the sum, as the
// plain version's products are (no FMA): a row's sum of two terms is then
// the same in any order, on any plan.
__device__ __forceinline__ void bounce_row_f64(const Side64& si, const Side64& sj, int i,
                                               int j0, int count, double e,
                                               double* __restrict__ d) {
  const int lane = threadIdx.x & 31;
  const double xi = si.pos[3 * i], yi = si.pos[3 * i + 1], zi = si.pos[3 * i + 2];
  const double ux = si.vel[3 * i], uy = si.vel[3 * i + 1], uz = si.vel[3 * i + 2];
  const double ri = si.radius[i];
  const double inv_mi = __drcp_rn(si.mass[i]);
#pragma unroll 1
  for (int c0 = 0; c0 < kTile; c0 += 32) {
    const int j = j0 + c0 + lane;
    double t[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    bool hit = false;
    if (c0 + lane < count) {
      const double ddx = __dsub_rn(sj.pos[3 * j], xi);
      const double ddy = __dsub_rn(sj.pos[3 * j + 1], yi);
      const double ddz = __dsub_rn(sj.pos[3 * j + 2], zi);
      const double r2 = __dadd_rn(__dadd_rn(__dmul_rn(ddx, ddx), __dmul_rn(ddy, ddy)),
                                  __dmul_rn(ddz, ddz));
      const double rsum = __dadd_rn(ri, sj.radius[j]);
      if (r2 <= __dmul_rn(rsum, rsum) && r2 > 0.0 && live64(sj, j)) {
        const double s = __dadd_rn(
            __dadd_rn(__dmul_rn(ddx, __dsub_rn(sj.vel[3 * j], ux)),
                      __dmul_rn(ddy, __dsub_rn(sj.vel[3 * j + 1], uy))),
            __dmul_rn(ddz, __dsub_rn(sj.vel[3 * j + 2], uz)));
        if (s < 0.0) {
          const double inv_d = rsqrt(r2);
          const double base =
              __dmul_rn(__drcp_rn(__dadd_rn(inv_mi, __drcp_rn(sj.mass[j]))), inv_mi);
          const double fv =
              __dmul_rn(__dmul_rn(__dmul_rn(1.0 + e, s), __dmul_rn(inv_d, inv_d)), base);
          const double h = __dmul_rn(__dsub_rn(__dmul_rn(rsum, inv_d), 1.0), base);
          t[0] = __dmul_rn(fv, ddx);
          t[1] = __dmul_rn(fv, ddy);
          t[2] = __dmul_rn(fv, ddz);
          t[3] = __dmul_rn(h, ddx);
          t[4] = __dmul_rn(h, ddy);
          t[5] = __dmul_rn(h, ddz);
          hit = true;
        }
      }
    }
    // the touching columns in column order: lowest lane first
    for (unsigned hits = __ballot_sync(0xffffffffu, hit); hits; hits &= hits - 1) {
      if (lane == __ffs(hits) - 1) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          d[c * kBRows] = __dadd_rn(d[c * kBRows], t[c]);
          d[(3 + c) * kBRows] = __dsub_rn(d[(3 + c) * kBRows], t[3 + c]);
        }
      }
      __syncwarp();
    }
  }
}

// A bounce view of n rows: (x, y, z, R) [n] float4, then (rmax, amax) a
// 128-row tile.
__device__ __forceinline__ const float2* bounce_view_tiles(const float* v, int n) {
  return reinterpret_cast<const float2*>(v + 4 * static_cast<size_t>(n));
}

// The deltas of rows base + lane + 32 k (k < K) of si from the j bodies
// [j_lo, j_hi) of sj, in double: warp w of the Q sweeps tiles j_lo + w kTile,
// + Q kTile, ..., each staged by the warp as its cast (x, y, z, R) into its
// own tile (from the f64 tables, and by a writer block into view_out too;
// with kRead from the views view_i and view_j, with the tile's maxima),
// prefiltered on each row's nearest f32 r2 (B6's loop), then the warp's
// double pass of each flagged row. Each warp's own deltas of its rows come
// out in dw ([6][kBRows] doubles of shared memory, zeroed here).
template <int K, int Q, bool kRead>
__device__ __forceinline__ void sweep_rows_f64(const Side64& si, const Side64& sj, int base,
                                               int j_lo, int j_hi, double e,
                                               float4* __restrict__ gtile,
                                               double* __restrict__ dw,
                                               float* __restrict__ view_out,
                                               const float* __restrict__ view_i,
                                               const float* __restrict__ view_j) {
  const int lane = threadIdx.x & 31;
  const float nan = __int_as_float(0x7fc00000);
  float4 gi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = base + lane + 32 * k;
    if constexpr (kRead) {
      gi[k] = i < si.n ? reinterpret_cast<const float4*>(view_i)[i]
                       : make_float4(0.f, 0.f, 0.f, nan);
    } else {
      gi[k] = i < si.n ? geo_of64(si, i) : make_float4(0.f, 0.f, 0.f, nan);
    }
  }
  for (int c = lane; c < 6 * kBRows; c += 32) dw[c] = 0.0;
  __syncwarp();
  for (int j0 = j_lo + (threadIdx.x >> 5) * kTile; j0 < j_hi; j0 += Q * kTile) {
    float rmax = 0.0f, amax = 0.0f;  // over the live bodies this lane staged
#pragma unroll
    for (int r = lane; r < kTile; r += 32) {
      if (j0 + r < j_hi) {
        if constexpr (kRead) {
          gtile[r] = reinterpret_cast<const float4*>(view_j)[j0 + r];
        } else {
          const float4 g = geo_of64(sj, j0 + r);
          gtile[r] = g;
          if (view_out != nullptr) reinterpret_cast<float4*>(view_out)[j0 + r] = g;
          if (g.w == g.w) {  // live
            rmax = fmaxf(rmax, g.w);
            amax = fmaxf(amax, coord_scale(g));
          }
        }
      }
    }
    if constexpr (kRead) {
      const float2 m = bounce_view_tiles(view_j, sj.n)[j0 / kTile];
      rmax = m.x;
      amax = m.y;
    } else {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      }
      if (view_out != nullptr && lane == 0)
        reinterpret_cast<float2*>(view_out + 4 * static_cast<size_t>(sj.n))[j0 / kTile] =
            make_float2(rmax, amax);
    }
    __syncwarp();
    const int count = min(kTile, j_hi - j0);
    float nearest[K];
    if (count == kTile) nearest_tile<K>(gtile, kTile, gi, nearest);
    else nearest_tile<K>(gtile, count, gi, nearest);
    unsigned flagged = 0u;  // bit k: row k of this lane passes the prefilter
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (nearest[k] <= reach2(__fadd_ru(gi[k].w, rmax), __fadd_ru(coord_scale(gi[k]), amax),
                               1.000001f))
        flagged |= 1u << k;
    }
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      for (unsigned rows = __ballot_sync(0xffffffffu, (flagged >> k) & 1u); rows;
           rows &= rows - 1) {
        const int r = __ffs(rows) - 1 + 32 * k;
        bounce_row_f64(si, sj, base + r, j0, count, e, dw + r);
      }
    }
    __syncwarp();
  }
}

// The f64 instance of bounce_block_kernel: the same plan, gate and split
// sums; part: [splits * n_i * 6] double scratch (unused with one split).
// kF64Smem bytes of dynamic shared memory. Without kRead the blocks of i
// tile 0 write sj's view to view_out (where given); with kRead the rows are
// staged from view_i and view_j.
template <bool kRead>
__global__ void __launch_bounds__(kBThreads, kBMin)
bounce_block_f64_kernel(Side64 si, Side64 sj, double e, const int* __restrict__ contacts,
                        int tiles, int splits, int split_len, int accumulate,
                        double* __restrict__ part, unsigned int* __restrict__ done,
                        double* __restrict__ dpos, double* __restrict__ dvel,
                        float* __restrict__ view_out, const float* __restrict__ view_i,
                        const float* __restrict__ view_j) {
  const int tile_i = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int base = tile_i * kBRows;
  const int n = si.n;
  if (contacts != nullptr && *contacts <= 0) {  // uniform: one count for all
    if (accumulate || split > 0) return;
    for (int r = threadIdx.x; r < kBRows && base + r < n; r += kBThreads) {
      const int i = base + r;
      dvel[3 * i + 0] = dvel[3 * i + 1] = dvel[3 * i + 2] = 0.0;
      dpos[3 * i + 0] = dpos[3 * i + 1] = dpos[3 * i + 2] = 0.0;
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char f64_smem[];
  float4* gtiles = reinterpret_cast<float4*>(f64_smem);
  double* deltas = reinterpret_cast<double*>(f64_smem + kBQ * kTile * 16);
  __shared__ bool last;
  const int warp = threadIdx.x >> 5;
  const int j_lo = split * split_len;
  sweep_rows_f64<kBK, kBQ, kRead>(si, sj, base, j_lo, min(j_lo + split_len, sj.n), e,
                                  gtiles + warp * kTile, deltas + warp * 6 * kBRows,
                                  tile_i == 0 ? view_out : nullptr, view_i, view_j);
  // the kBQ warps' deltas of each row, added in warp order
  __syncthreads();
  const int r = threadIdx.x;
  double a[6];
  if (r < kBRows) {
#pragma unroll
    for (int c = 0; c < 6; ++c) a[c] = deltas[c * kBRows + r];
    for (int q = 1; q < kBQ; ++q) {
#pragma unroll
      for (int c = 0; c < 6; ++c) a[c] += deltas[(q * 6 + c) * kBRows + r];
    }
  }
  const bool owns = r < kBRows && base + r < n;
  if (owns) {
    if (splits == 1) {
      emit(a, base + r, accumulate, dpos, dvel);
    } else {
      double* p = part + (static_cast<size_t>(split) * n + base + r) * 6;
#pragma unroll
      for (int c = 0; c < 6; ++c) p[c] = a[c];
    }
  }
  if (splits == 1) return;
  // the last split of this i tile to finish adds the splits in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&done[tile_i], 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (owns) {
    const double* p0 = part + (static_cast<size_t>(base) + r) * 6;
#pragma unroll
    for (int c = 0; c < 6; ++c) a[c] = __ldcg(p0 + c);
    for (int q = 1; q < splits; ++q) {
      const double* pq = part + (static_cast<size_t>(q) * n + base + r) * 6;
#pragma unroll
      for (int c = 0; c < 6; ++c) a[c] += __ldcg(pq + c);
    }
    emit(a, base + r, accumulate, dpos, dvel);
  }
  if (threadIdx.x == 0) done[tile_i] = 0u;
}

// bounce_block_round_f64 with or without views (see its note).
int launch_bounce_f64(const void* pos_i, const void* vel_i, const void* mass_i,
                      const void* radius_i, const void* alive_i, int n_i, const void* pos_j,
                      const void* vel_j, const void* mass_j, const void* radius_j,
                      const void* alive_j, int n_j, double restitution, const void* contacts,
                      int splits, int split_len, int accumulate, void* part, void* done,
                      void* dpos, void* dvel, void* stream, int device, void* view_out,
                      const void* view_i, const void* view_j) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool read = view_i != nullptr || view_j != nullptr;
  if (read && (view_i == nullptr || view_j == nullptr || view_out != nullptr))
    return cudaErrorInvalidValue;
  if (n_i <= 0) return cudaSuccess;
  if (splits < 1 || split_len < 1 || split_len % kTile != 0 ||
      static_cast<long long>(splits) * split_len < n_j ||
      (n_j > 0 && static_cast<long long>(splits - 1) * split_len >= n_j))
    return cudaErrorInvalidValue;
  // the kernel's 64 KB of dynamic shared memory, allowed once a device
  static bool allowed[64] = {false};
  const int d = device >= 0 && device < 64 ? device : 0;
  if (!allowed[d]) {
    err = cudaFuncSetAttribute(bounce_block_f64_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kF64Smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bounce_block_f64_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kF64Smem);
    if (err != cudaSuccess) return err;
    allowed[d] = true;
  }
  const Side64 si{static_cast<const double*>(pos_i), static_cast<const double*>(vel_i),
                  static_cast<const double*>(mass_i), static_cast<const double*>(radius_i),
                  static_cast<const bool*>(alive_i), n_i};
  const Side64 sj{static_cast<const double*>(pos_j), static_cast<const double*>(vel_j),
                  static_cast<const double*>(mass_j), static_cast<const double*>(radius_j),
                  static_cast<const bool*>(alive_j), n_j};
  const int tiles = (n_i + kBRows - 1) / kBRows;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int*>(contacts);
  auto* pa = static_cast<double*>(part);
  auto* dn = static_cast<unsigned int*>(done);
  auto* dp = static_cast<double*>(dpos);
  auto* dv = static_cast<double*>(dvel);
  if (read) {
    bounce_block_f64_kernel<true><<<tiles * splits, kBThreads, kF64Smem, s>>>(
        si, sj, restitution, c, tiles, splits, split_len, accumulate, pa, dn, dp, dv, nullptr,
        static_cast<const float*>(view_i), static_cast<const float*>(view_j));
  } else {
    bounce_block_f64_kernel<false><<<tiles * splits, kBThreads, kF64Smem, s>>>(
        si, sj, restitution, c, tiles, splits, split_len, accumulate, pa, dn, dp, dv,
        static_cast<float*>(view_out), nullptr, nullptr);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pos, vel: [n, 3] float; mass, radius: [n] float; alive: [n] bool or null;
// contacts: one int32 on the device or null; dpos, dvel: [n, 3] float.
int bounce_deltas(const void* pos, const void* vel, const void* mass, const void* radius,
                  const void* alive, int n, float restitution, const void* contacts,
                  void* dpos, void* dvel, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  const Side side{static_cast<const float*>(pos), static_cast<const float*>(vel),
                  static_cast<const float*>(mass), static_cast<const float*>(radius),
                  static_cast<const bool*>(alive), n};
  const int grid = (n + kRows - 1) / kRows;
  bounce_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      side, side, restitution, static_cast<const int*>(contacts),
      static_cast<float*>(dpos), static_cast<float*>(dvel));
  return cudaGetLastError();
}

// The block bounce: the i side (pos_i, vel_i: [n_i, 3]; mass_i, radius_i:
// [n_i]; alive_i: [n_i] bool) and the j side (the same over n_j), read in
// place; dpos, dvel: [n_i, 3] float, the impulses and de-overlap of j on i,
// written (accumulate 0) or added to them (accumulate 1), gated on contacts
// as bounce_deltas is. The launch plan (splits, split_len: ops/
// cuda_collisions.py::bounce_plan) cuts [0, n_j) into splits of whole
// tiles; part: [splits * n_i * 6] float scratch (unused with one split) and
// done: [ceil(n_i / rows)] unsigned int counters, 0 on entry and left 0.
int bounce_block_round(const void* pos_i, const void* vel_i, const void* mass_i,
                       const void* radius_i, const void* alive_i, int n_i,
                       const void* pos_j, const void* vel_j, const void* mass_j,
                       const void* radius_j, const void* alive_j, int n_j,
                       float restitution, const void* contacts, int splits, int split_len,
                       int accumulate, void* part, void* done, void* dpos, void* dvel,
                       void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_i <= 0) return cudaSuccess;
  if (splits < 1 || split_len < 1 || split_len % kTile != 0 ||
      static_cast<long long>(splits) * split_len < n_j ||
      (n_j > 0 && static_cast<long long>(splits - 1) * split_len >= n_j))
    return cudaErrorInvalidValue;
  const Side si{static_cast<const float*>(pos_i), static_cast<const float*>(vel_i),
                static_cast<const float*>(mass_i), static_cast<const float*>(radius_i),
                static_cast<const bool*>(alive_i), n_i};
  const Side sj{static_cast<const float*>(pos_j), static_cast<const float*>(vel_j),
                static_cast<const float*>(mass_j), static_cast<const float*>(radius_j),
                static_cast<const bool*>(alive_j), n_j};
  const int tiles = (n_i + kBRows - 1) / kBRows;
  bounce_block_kernel<<<tiles * splits, kBThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      si, sj, restitution, static_cast<const int*>(contacts), tiles, splits, split_len,
      accumulate, static_cast<float*>(part), static_cast<unsigned int*>(done),
      static_cast<float*>(dpos), static_cast<float*>(dvel));
  return cudaGetLastError();
}

// The block bounce's f64 instance: bounce_block_round's arguments with the
// sides' pos, vel, mass and radius double, restitution double, and part
// [splits * n_i * 6], dpos, dvel [n_i, 3] double; the f32 instance's plan.
int bounce_block_round_f64(const void* pos_i, const void* vel_i, const void* mass_i,
                           const void* radius_i, const void* alive_i, int n_i,
                           const void* pos_j, const void* vel_j, const void* mass_j,
                           const void* radius_j, const void* alive_j, int n_j,
                           double restitution, const void* contacts, int splits,
                           int split_len, int accumulate, void* part, void* done, void* dpos,
                           void* dvel, void* stream, int device) {
  return launch_bounce_f64(pos_i, vel_i, mass_i, radius_i, alive_i, n_i, pos_j, vel_j,
                           mass_j, radius_j, alive_j, n_j, restitution, contacts, splits,
                           split_len, accumulate, part, done, dpos, dvel, stream, device,
                           nullptr, nullptr, nullptr);
}

// bounce_block_round_f64 with the shards' cast views (float buffers of 4 n
// + 2 ceil(n / 128) floats, the header's layout): view_out non-null (the
// diagonal round; view_i and view_j null) writes the j side's view as the
// launch stages it, when the count lets the sweep run; view_i and view_j
// non-null (the later rounds; view_out null) stage the i and j rows from
// them. The deltas are bounce_block_round_f64's, bit for bit.
int bounce_block_round_f64_view(const void* pos_i, const void* vel_i, const void* mass_i,
                                const void* radius_i, const void* alive_i, int n_i,
                                const void* pos_j, const void* vel_j, const void* mass_j,
                                const void* radius_j, const void* alive_j, int n_j,
                                double restitution, const void* contacts, int splits,
                                int split_len, int accumulate, void* part, void* done,
                                void* dpos, void* dvel, void* stream, int device,
                                void* view_out, const void* view_i, const void* view_j) {
  if (view_out == nullptr && (view_i == nullptr || view_j == nullptr))
    return cudaErrorInvalidValue;
  return launch_bounce_f64(pos_i, vel_i, mass_i, radius_i, alive_i, n_i, pos_j, vel_j,
                           mass_j, radius_j, alive_j, n_j, restitution, contacts, splits,
                           split_len, accumulate, part, done, dpos, dvel, stream, device,
                           view_out, view_i, view_j);
}

// The launch shape at n bodies: shape[0..4] = i bodies a thread, warps (j
// slices) a block, j bodies a tile, threads a block, blocks.
void bounce_deltas_shape(int n, int* shape) {
  shape[0] = kK;
  shape[1] = kQ;
  shape[2] = kTile;
  shape[3] = kThreads;
  shape[4] = (n + kRows - 1) / kRows;
}

// The block bounce's shape on a device: shape[0..5] = i bodies a thread,
// warps a block, j bodies a tile, threads a block, co-resident blocks (the
// occupancy times the SMs) and SMs, asked once a device.
void bounce_block_shape(int device, int* shape) {
  static int cache[64][2] = {{0, 0}};
  const int d = device >= 0 && device < 64 ? device : 0;
  if (cache[d][0] == 0) {
    int per_sm = 0, count = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bounce_block_kernel, kBThreads, 0);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    cache[d][1] = count > 0 ? count : 1;
    cache[d][0] = per_sm * count > 0 ? per_sm * count : 1;
  }
  shape[0] = kBK;
  shape[1] = kBQ;
  shape[2] = kTile;
  shape[3] = kBThreads;
  shape[4] = cache[d][0];
  shape[5] = cache[d][1];
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
