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
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

#ifndef OT_BOUNCE_K
#define OT_BOUNCE_K 4
#endif
#ifndef OT_BOUNCE_Q
#define OT_BOUNCE_Q 8
#endif

namespace {

constexpr int kK = OT_BOUNCE_K;  // i bodies a thread
constexpr int kQ = OT_BOUNCE_Q;  // warps a block, one j slice each
constexpr int kTile = 128;       // j bodies a warp's tile
constexpr int kThreads = 32 * kQ;
constexpr int kRows = 32 * kK;   // i bodies a block
static_assert(kK >= 1 && kQ >= 1 && kTile % 32 == 0, "bad launch shape");
static_assert(kQ * kTile * 32 <= 48 * 1024 && 6 * kRows <= 8 * kTile,
              "the warps' tiles must fit in static shared memory and hold the deltas");

struct Deltas {
  float vx = 0.0f, vy = 0.0f, vz = 0.0f, px = 0.0f, py = 0.0f, pz = 0.0f;
};

// |r_j - r_i|^2 in one rounding order, shared by the prefilter and the
// exact test
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
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
__device__ __forceinline__ void nearest_tile(const float4* gtile, int count,
                                             const float4 (&gi)[kK], float (&nearest)[kK]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) nearest[k] = __int_as_float(0x7f800000);  // +inf
#pragma unroll 4
  for (int jj = 0; jj < count; ++jj) {
    const float4 gj = gtile[jj];
#pragma unroll
    for (int k = 0; k < kK; ++k)
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

__global__ void __launch_bounds__(kThreads, 1)
bounce_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
              const float* __restrict__ mass, const float* __restrict__ radius,
              const bool* __restrict__ alive, int n, float e,
              const int* __restrict__ contacts, float* __restrict__ dpos,
              float* __restrict__ dvel) {
  const int base = blockIdx.x * kRows;
  if (contacts != nullptr && *contacts <= 0) {  // uniform: one count for all
    for (int r = threadIdx.x; r < kRows && base + r < n; r += kThreads) {
      const int i = base + r;
      dvel[3 * i + 0] = dvel[3 * i + 1] = dvel[3 * i + 2] = 0.0f;
      dpos[3 * i + 0] = dpos[3 * i + 1] = dpos[3 * i + 2] = 0.0f;
    }
    return;
  }
  __shared__ float4 tiles[kQ][2][kTile];  // a warp's (x, y, z, R) and (v, m) tiles
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4 gi[kK], ki[kK];
  float inv_mi[kK];
  Deltas d[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int i = base + lane + 32 * k;
    gi[k] = i < n ? geo_of(pos, radius, i) : make_float4(0.f, 0.f, 0.f, 0.f);
    ki[k] = i < n ? kin_of(vel, mass, alive, i) : make_float4(0.f, 0.f, 0.f, 0.f);
    inv_mi[k] = ki[k].w > 0.0f ? __frcp_rn(ki[k].w) : 0.0f;
  }
  float4* gtile = tiles[warp][0];
  float4* ktile = tiles[warp][1];
  for (int j0 = warp * kTile; j0 < n; j0 += kQ * kTile) {
    float rmax = 0.0f;  // the largest radius this lane staged
#pragma unroll
    for (int r = lane; r < kTile; r += 32) {
      if (j0 + r < n) {
        gtile[r] = geo_of(pos, radius, j0 + r);
        ktile[r] = kin_of(vel, mass, alive, j0 + r);
        rmax = fmaxf(rmax, gtile[r].w);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
    __syncwarp();
    const int count = min(kTile, n - j0);
    float nearest[kK];
    if (count == kTile) nearest_tile(gtile, kTile, gi, nearest);
    else nearest_tile(gtile, count, gi, nearest);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float rsum = (gi[k].w + rmax) * 1.0001f;
      if (ki[k].w > 0.0f && nearest[k] <= rsum * rsum) {
        for (int jj = 0; jj < count; ++jj)
          bounce_pair(gi[k], ki[k], inv_mi[k], e, gtile[jj], &ktile[jj], d[k]);
      }
    }
    __syncwarp();
  }
  // the kQ slices' deltas of each row, added in warp order
  float* mine = reinterpret_cast<float*>(gtile);
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    float* row = mine + 6 * (lane + 32 * k);
    row[0] = d[k].vx;
    row[1] = d[k].vy;
    row[2] = d[k].vz;
    row[3] = d[k].px;
    row[4] = d[k].py;
    row[5] = d[k].pz;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kRows && base + r < n; r += kThreads) {
    const float* w0 = reinterpret_cast<const float*>(tiles[0]) + 6 * r;
    float a[6] = {w0[0], w0[1], w0[2], w0[3], w0[4], w0[5]};
    for (int q = 1; q < kQ; ++q) {
      const float* wq = reinterpret_cast<const float*>(tiles[q]) + 6 * r;
#pragma unroll
      for (int c = 0; c < 6; ++c) a[c] += wq[c];
    }
    const int i = base + r;
    dvel[3 * i + 0] = a[0];
    dvel[3 * i + 1] = a[1];
    dvel[3 * i + 2] = a[2];
    dpos[3 * i + 0] = a[3];
    dpos[3 * i + 1] = a[4];
    dpos[3 * i + 2] = a[5];
  }
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
  const int grid = (n + kRows - 1) / kRows;
  bounce_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(vel),
      static_cast<const float*>(mass), static_cast<const float*>(radius),
      static_cast<const bool*>(alive), n, restitution, static_cast<const int*>(contacts),
      static_cast<float*>(dpos), static_cast<float*>(dvel));
  return cudaGetLastError();
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

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
