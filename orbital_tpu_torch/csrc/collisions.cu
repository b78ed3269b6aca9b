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
// What bounds it on this card: arithmetic, and almost all of it is the
// rejection test. A pair costs ~10 flops (3 differences, r2, (R_i+R_j)^2)
// before the r2 test rejects it; only touching pairs pay the velocity dot
// product, one rsqrtf and two reciprocals. Device memory traffic is O(N) per
// block (32 bytes per j body, once per block) and stays in L2.
//
// Design: one thread per i body, j bodies streamed through shared memory in
// tiles of two float4: (x, y, z, R), which is all the rejection test reads,
// and (vx, vy, vz, m * alive), read only for pairs that pass it. Each tile
// is swept twice. The first pass is branch-free: it only asks whether any
// pair of the tile is a candidate (r2 within a slightly inflated (R_i+R_j)^2),
// over a constant trip count unrolled by 8 on full tiles, so the loads and
// dependent r2 chains of several pairs overlap. Only a thread that found a
// candidate runs the exact pass over that tile, which nearly never happens.
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

namespace {

constexpr int kBlock = 128;

struct Deltas {
  float vx = 0.0f, vy = 0.0f, vz = 0.0f, px = 0.0f, py = 0.0f, pz = 0.0f;
};

// One pair, i's view: add the impulse and de-overlap of an approaching
// overlapping pair to d. Almost every pair leaves at the first test.
__device__ __forceinline__ void bounce_pair(float4 gi, float4 ki, float inv_mi, float e,
                                            float4 gj, const float4* kj_ptr, Deltas& d) {
  const float ddx = gj.x - gi.x;
  const float ddy = gj.y - gi.y;
  const float ddz = gj.z - gi.z;
  const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
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

// A superset of the exact pass's first test: the 1e-4 inflation keeps a pair
// that the exact test accepts a candidate whatever the rounding of r2.
__device__ __forceinline__ bool candidate(float4 gi, float4 gj) {
  const float ddx = gj.x - gi.x;
  const float ddy = gj.y - gi.y;
  const float ddz = gj.z - gi.z;
  const float rsum = (gi.w + gj.w) * 1.0001f;
  return ddx * ddx + ddy * ddy + ddz * ddz <= rsum * rsum;
}

__device__ __forceinline__ float4 geo_of(const float* pos, const float* radius, int j) {
  return make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], radius[j]);
}

__device__ __forceinline__ float4 kin_of(const float* vel, const float* mass,
                                         const bool* alive, int j) {
  return make_float4(vel[3 * j], vel[3 * j + 1], vel[3 * j + 2],
                     (alive == nullptr || alive[j]) ? mass[j] : 0.0f);
}

__global__ void __launch_bounds__(kBlock)
bounce_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
              const float* __restrict__ mass, const float* __restrict__ radius,
              const bool* __restrict__ alive, int n, float e,
              const int* __restrict__ contacts, float* __restrict__ dpos,
              float* __restrict__ dvel) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  Deltas d;
  if (contacts == nullptr || *contacts > 0) {  // uniform: one count for all
    __shared__ float4 gtile[kBlock];
    __shared__ float4 ktile[kBlock];
    const float4 gi = i < n ? geo_of(pos, radius, i) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 ki = i < n ? kin_of(vel, mass, alive, i) : make_float4(0.f, 0.f, 0.f, 0.f);
    const bool live = ki.w > 0.0f;
    const float inv_mi = live ? __frcp_rn(ki.w) : 0.0f;
    for (int j0 = 0; j0 < n; j0 += kBlock) {
      const int j = j0 + threadIdx.x;
      if (j < n) {
        gtile[threadIdx.x] = geo_of(pos, radius, j);
        ktile[threadIdx.x] = kin_of(vel, mass, alive, j);
      }
      __syncthreads();
      const int count = min(kBlock, n - j0);
      bool any = false;
      if (count == kBlock) {
#pragma unroll 8
        for (int k = 0; k < kBlock; ++k) any |= candidate(gi, gtile[k]);
      } else {
        for (int k = 0; k < count; ++k) any |= candidate(gi, gtile[k]);
      }
      if (live && any) {
        for (int k = 0; k < count; ++k)
          bounce_pair(gi, ki, inv_mi, e, gtile[k], &ktile[k], d);
      }
      __syncthreads();
    }
  }
  if (i < n) {
    dvel[3 * i + 0] = d.vx;
    dvel[3 * i + 1] = d.vy;
    dvel[3 * i + 2] = d.vz;
    dpos[3 * i + 0] = d.px;
    dpos[3 * i + 1] = d.py;
    dpos[3 * i + 2] = d.pz;
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
  const int grid = (n + kBlock - 1) / kBlock;
  bounce_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(vel),
      static_cast<const float*>(mass), static_cast<const float*>(radius),
      static_cast<const bool*>(alive), n, restitution, static_cast<const int*>(contacts),
      static_cast<float*>(dpos), static_cast<float*>(dvel));
  return cudaGetLastError();
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
