// K leapfrog (kick-drift-kick) steps in one cooperative launch, for Hopper
// (sm_90a).
//
// Replaces: orbital_tpu/ops/fused_rollout.py::_fused_kernel, which keeps the
// whole state resident in TPU VMEM and runs the KDK loop inside one program.
//
// What bounds it on this card: at the N it serves (N <= 32768) each step is
// one O(N^2) force sweep (~20 flops and one rsqrtf per pair) plus O(N)
// kick/drift work, so the sweep dominates above a few thousand bodies; below
// that, the two grid-wide barriers per step and too few blocks to fill 132
// SMs do. The state (SoA hi/lo positions and velocities, accelerations:
// ~60 bytes a body) does not fit one SM's shared memory, so it lives in
// device memory and is read through L2, where it stays resident.
//
// Design: one cooperative grid, capped at the number of co-resident blocks,
// loops over the steps itself (the step count is a runtime argument):
//
//   seed a(t) from the positions;  grid.sync
//   repeat steps times:
//     kick(dt/2) + drift   (own bodies)     grid.sync
//     force sweep          (reads every hi position, writes own a)
//                                           grid.sync
//     kick(dt/2)           (own bodies)
//
// A thread owns the same bodies in every phase, so the closing kick reads
// the accelerations it wrote itself. The force sweep is the one of
// nbody_forces.cu (j tiles of float4 in shared memory, eps2 > 0, no mask),
// reading hi positions only, as the TPU kernel does, with the same
// two-level (per-tile, then running) f32 sums. Accelerations of dead
// bodies are zeroed (keep = 0), as the stepper's alive mask does.
//
// ds32 exactness: the double-single updates use explicitly rounded
// intrinsics (__fadd_rn, __fsub_rn, __fmul_rn), which nvcc never contracts
// into fused multiply-adds, so dt*v is rounded before the two-sum and the
// error-free transformations stay exact at any -fmad setting. With ds == 0
// the state is plain f32 and each update is one rounded multiply and add,
// the same arithmetic as the eager PyTorch stepper.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 128;

struct State {
  float* pos_hi;  // [3, n]
  float* pos_lo;  // [3, n] (zeros when ds == 0)
  float* vel_hi;  // [3, n]
  float* vel_lo;  // [3, n]
  float* acc;     // [3, n] scratch
  const float* mass;  // [n] mass * alive
  const float* keep;  // [n] alive as 0 / 1
  int n;
};

// (hi, lo) += x, renormalized: Knuth two-sum then Dekker fast-two-sum.
__device__ __forceinline__ void ds_add(float& hi, float& lo, float x) {
  const float s = __fadd_rn(hi, x);
  const float bb = __fsub_rn(s, hi);
  const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(x, bb));
  const float e = __fadd_rn(err, lo);
  hi = __fadd_rn(s, e);
  lo = __fsub_rn(e, __fsub_rn(hi, s));
}

__device__ __forceinline__ void kick(const State& st, int i, float half_dt, bool ds) {
  for (int c = 0; c < 3; ++c) {
    const int k = c * st.n + i;
    const float inc = __fmul_rn(half_dt, st.acc[k]);
    if (ds) {
      float hi = st.vel_hi[k], lo = st.vel_lo[k];
      ds_add(hi, lo, inc);
      st.vel_hi[k] = hi;
      st.vel_lo[k] = lo;
    } else {
      st.vel_hi[k] = __fadd_rn(st.vel_hi[k], inc);
    }
  }
}

__device__ __forceinline__ void drift(const State& st, int i, float dt, bool ds) {
  for (int c = 0; c < 3; ++c) {
    const int k = c * st.n + i;
    if (ds) {
      float hi = st.pos_hi[k], lo = st.pos_lo[k];
      ds_add(hi, lo, __fmul_rn(dt, st.vel_hi[k]));
      ds_add(hi, lo, __fmul_rn(dt, st.vel_lo[k]));
      st.pos_hi[k] = hi;
      st.pos_lo[k] = lo;
    } else {
      st.pos_hi[k] = __fadd_rn(st.pos_hi[k], __fmul_rn(dt, st.vel_hi[k]));
    }
  }
}

// Sums one tile of j bodies into fresh per-tile partials. Called with the
// constant kBlock for full tiles, so that loop has a fixed trip count.
__device__ __forceinline__ void tile_sum(const float4* tile, int count, float xi,
                                         float yi, float zi, float eps2, float& tx,
                                         float& ty, float& tz) {
  tx = ty = tz = 0.0f;
#pragma unroll 8
  for (int k = 0; k < count; ++k) {
    const float4 pj = tile[k];
    const float dx = pj.x - xi;
    const float dy = pj.y - yi;
    const float dz = pj.z - zi;
    const float inv_r = rsqrtf(dx * dx + dy * dy + dz * dz + eps2);
    const float w = pj.w * (inv_r * inv_r * inv_r);
    tx += w * dx;
    ty += w * dy;
    tz += w * dz;
  }
}

// One full sweep: acc[:, i] = keep_i * G sum_j m_j (r_j - r_i) / s^3 for the
// bodies this block owns. Every thread of the block runs the same number of
// tile iterations, so the __syncthreads() are uniform.
__device__ void forces(const State& st, float4* tile, float G, float eps2) {
  const int n = st.n;
  for (int base = blockIdx.x * kBlock; base < n; base += gridDim.x * kBlock) {
    const int i = base + threadIdx.x;
    float xi = 0.0f, yi = 0.0f, zi = 0.0f;
    if (i < n) {
      xi = st.pos_hi[i];
      yi = st.pos_hi[n + i];
      zi = st.pos_hi[2 * n + i];
    }
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    for (int j0 = 0; j0 < n; j0 += kBlock) {
      const int j = j0 + threadIdx.x;
      if (j < n) {
        tile[threadIdx.x] = make_float4(st.pos_hi[j], st.pos_hi[n + j],
                                        st.pos_hi[2 * n + j], st.mass[j]);
      }
      __syncthreads();
      float tx, ty, tz;
      if (n - j0 >= kBlock) {
        tile_sum(tile, kBlock, xi, yi, zi, eps2, tx, ty, tz);
      } else {
        tile_sum(tile, n - j0, xi, yi, zi, eps2, tx, ty, tz);
      }
      ax += tx;
      ay += ty;
      az += tz;
      __syncthreads();
    }
    if (i < n) {
      const float g = G * st.keep[i];
      st.acc[i] = g * ax;
      st.acc[n + i] = g * ay;
      st.acc[2 * n + i] = g * az;
    }
  }
}

__global__ void __launch_bounds__(kBlock)
fused_kdk_kernel(State st, int steps, float dt, float half_dt, float G, float eps2,
                 int ds) {
  __shared__ float4 tile[kBlock];
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kBlock;
  const int first = blockIdx.x * kBlock + threadIdx.x;

  forces(st, tile, G, eps2);  // seed a(t) from the positions
  grid.sync();
  for (int s = 0; s < steps; ++s) {
    for (int i = first; i < st.n; i += stride) {
      kick(st, i, half_dt, ds);
      drift(st, i, dt, ds);
    }
    grid.sync();
    forces(st, tile, G, eps2);
    grid.sync();
    for (int i = first; i < st.n; i += stride) kick(st, i, half_dt, ds);
  }
}

}  // namespace

extern "C" {

// Advances the state in place by `steps` KDK steps. All arrays are float32
// device arrays laid out as documented in State; eps2 must be > 0.
int fused_kdk(void* pos_hi, void* pos_lo, void* vel_hi, void* vel_lo, void* acc,
              const void* mass, const void* keep, int n, int steps, float dt,
              float half_dt, float G, float eps2, int ds, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kdk_kernel,
                                                      kBlock, 0);
  if (err != cudaSuccess) return err;
  const int wanted = (n + kBlock - 1) / kBlock;
  const int grid = wanted < per_sm * sms ? wanted : per_sm * sms;
  if (grid < 1) return cudaErrorInvalidConfiguration;

  State st{static_cast<float*>(pos_hi), static_cast<float*>(pos_lo),
           static_cast<float*>(vel_hi), static_cast<float*>(vel_lo),
           static_cast<float*>(acc),    static_cast<const float*>(mass),
           static_cast<const float*>(keep), n};
  void* args[] = {&st, &steps, &dt, &half_dt, &G, &eps2, &ds};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_kdk_kernel),
                                    dim3(grid), dim3(kBlock), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
