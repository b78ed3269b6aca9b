// K leapfrog (kick-drift-kick) steps in one cooperative launch, for Hopper
// (sm_90a).
//
// Replaces: orbital_tpu/ops/fused_rollout.py::_fused_kernel, which keeps the
// whole state resident in TPU VMEM and runs the KDK loop inside one program.
//
// What bounds it on this card: at the N it serves (N <= 32768) each step is
// one O(N^2) force sweep (18 flops and one rsqrt a pair, issued as 13.5
// warp instructions on the register-tiled template of nbody_forces.cu)
// plus O(N) kick/drift work and two grid-wide barriers. At 4,096 bodies
// the sweep's issue floor is ~7 us a step, so the barriers and the
// kick/drift passes weigh as much (a step took ~15 us); at 32,768 the sweep
// does (0.58 ms a step, 78% of its issue floor). The first version (one i
// body a thread, 32 blocks at 4,096) took 0.143 and 1.257 ms a step. The
// state (SoA hi/lo positions and velocities, accelerations, the split
// partials: ~60 bytes a body and 12 S) lives in device memory and stays
// resident in L2.
//
// Design: one cooperative grid, of at most the co-resident blocks, loops
// over the steps itself (the step count is a runtime argument):
//
//   sweep;  grid.sync;  a(t) = the sum of the partials  (own bodies)
//   repeat steps times:
//     kick(dt/2) + drift   (own bodies)     grid.sync
//     sweep                (every unit)     grid.sync
//     a = the sum of the partials, kick(dt/2)  (own bodies)
//
// The sweep is cut into units: i tile t (kRows = 32 kK bodies) against j
// split s (split_len bodies), tiles x splits units in all, and block b
// takes units b, b + grid, ... The plan (splits, split_len, warp_len, grid)
// is chosen on the host (ops/fused_rollout.py::launch_plan) so that the
// units fill the co-resident blocks in balanced rounds: at 4,096 bodies 32
// tiles alone would leave 100 of 132 SMs idle. Within a unit, as in
// nbody_forces.cu (B1):
//  - each thread holds kK i bodies in registers (rows base + lane + 32 k);
//  - warp w sweeps its own slice of the split, warp_len bodies from
//    split_len * s + warp_len * w, in tiles of kTile that it stages itself
//    into its own shared tile under __syncwarp;
//  - each tile is summed into fresh partials before the warp's running sums
//    (a two-level f32 sum), and the kQ warps' sums of each row are added in
//    shared memory in the fixed order w = 0, 1, ...;
//  - the unit writes its sums to part[s, c, i] ([splits, 3, n] in device
//    memory), and the thread that owns body i adds its splits in the order
//    s = 0, 1, ... after the grid.sync that follows the sweep: no extra
//    barrier, no float atomics, the same bits on every run.
// A thread owns the same bodies in every phase (i = first + k * stride), so
// the closing kick and the next opening kick read the accelerations it
// wrote itself. Hi positions only enter the sweep, as in the TPU kernel.
// One MUFU.RSQ a pair (rsqrt.approx.ftz) with eps2 folded into the r2
// chain: eps2 > 0 (the wrapper requires it), so r2 + eps2 is never
// denormal. Dead bodies have mass 0 (they exert nothing) and keep = 0 (their
// acceleration is zeroed), as the stepper's alive mask does.
//
// ds32 exactness: the double-single updates use explicitly rounded
// intrinsics (__fadd_rn, __fsub_rn, __fmul_rn), which nvcc never contracts
// into fused multiply-adds, so dt*v is rounded before the two-sum and the
// error-free transformations stay exact at any -fmad setting. With ds == 0
// the state is plain f32 and each update is one rounded multiply and add,
// the same arithmetic as the eager PyTorch stepper.
//
// kK and kQ are the OT_FUSED_K and OT_FUSED_Q macros below, which
// chip_smoke.py --sweep sets with -D: k = 4, q = 16 (109 registers, one
// 512-thread block an SM) ran 2-3% ahead of q = 8 (two 256-thread blocks
// an SM) at 4,096 and 32,768 bodies, and k = 8, q = 8 (155 registers)
// level with it (NVIDIA H100 80GB HBM3, 700 W; PERF.md). The second
// __launch_bounds__ argument (one block an SM) lets ptxas use the registers
// the tiling needs: without it ptxas capped B1's template at 64-80
// registers and it ran slower.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#ifndef OT_FUSED_K
#define OT_FUSED_K 4
#endif
#ifndef OT_FUSED_Q
#define OT_FUSED_Q 16
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kK = OT_FUSED_K;   // i bodies a thread
constexpr int kQ = OT_FUSED_Q;   // warps a block, one j slice each
constexpr int kTile = 128;       // j bodies a warp's tile
constexpr int kThreads = 32 * kQ;
constexpr int kRows = 32 * kK;   // i bodies a tile
// a warp's shared slot: its tile during the sweep, its sums after it
constexpr int kSlot = kTile > kRows ? kTile : kRows;
static_assert(kK >= 1 && kQ >= 1 && kTile % 32 == 0, "bad launch shape");
static_assert(kQ * kSlot * sizeof(float4) <= 48 * 1024, "static shared memory");

struct State {
  float* pos_hi;  // [3, n]
  float* pos_lo;  // [3, n] (zeros when ds == 0)
  float* vel_hi;  // [3, n]
  float* vel_lo;  // [3, n]
  float* acc;     // [3, n]
  float* part;    // [splits, 3, n] the units' sums
  const float* mass;  // [n] mass * alive
  const float* keep;  // [n] alive as 0 / 1
  int n;
};

struct Plan {
  int tiles, splits, split_len, warp_len;
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

// a(i) = G keep_i (the splits' sums of body i, added in split order)
__device__ __forceinline__ void gather(const State& st, const Plan& plan, int i, float G) {
  const float g = G * st.keep[i];
  for (int c = 0; c < 3; ++c) {
    float a = 0.0f;
    for (int s = 0; s < plan.splits; ++s)
      a += st.part[(static_cast<size_t>(s) * 3 + c) * st.n + i];
    st.acc[c * st.n + i] = g * a;
  }
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

// Sums one tile into fresh partials t (x, y, z) of each of the kK rows,
// which the caller adds to its running totals.
__device__ __forceinline__ void accumulate_tile(const float4* tile, int count,
                                                const float4 (&pi)[kK], float eps2,
                                                float4 (&t)[kK]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) t[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int jj = 0; jj < count; ++jj) {
    const float4 pj = tile[jj];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float dx = pj.x - pi[k].x;
      const float dy = pj.y - pi[k].y;
      const float dz = pj.z - pi[k].z;
      const float inv_r = rsqrt_ftz(fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2))));
      const float w = pj.w * (inv_r * inv_r * inv_r);
      t[k].x = fmaf(w, dx, t[k].x);
      t[k].y = fmaf(w, dy, t[k].y);
      t[k].z = fmaf(w, dz, t[k].z);
    }
  }
}

// One unit: i tile `tile` against j split `split`, written to part[split].
// Every thread of the block runs it, so its __syncthreads are uniform.
__device__ void sweep_unit(const State& st, const Plan& plan, int tile_i, int split,
                           float4 (*slots)[kSlot], float eps2) {
  const int n = st.n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = tile_i * kRows;
  float4 pi[kK], s[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int i = base + lane + 32 * k;
    pi[k] = i < n ? make_float4(st.pos_hi[i], st.pos_hi[n + i], st.pos_hi[2 * n + i], 0.0f)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float4* tile = slots[warp];
  const int a = min(n, split * plan.split_len + warp * plan.warp_len);
  const int b = min(min(n, (split + 1) * plan.split_len), a + plan.warp_len);
  for (int j0 = a; j0 < b; j0 += kTile) {
#pragma unroll
    for (int r = lane; r < kTile; r += 32) {
      const int j = j0 + r;
      if (j < b) tile[r] = make_float4(st.pos_hi[j], st.pos_hi[n + j], st.pos_hi[2 * n + j],
                                       st.mass[j]);
    }
    __syncwarp();
    float4 t[kK];
    if (b - j0 >= kTile) {
      accumulate_tile(tile, kTile, pi, eps2, t);
    } else {
      accumulate_tile(tile, b - j0, pi, eps2, t);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      s[k].x += t[k].x;
      s[k].y += t[k].y;
      s[k].z += t[k].z;
    }
    __syncwarp();
  }
  // the kQ slices' sums of each row, added in warp order
#pragma unroll
  for (int k = 0; k < kK; ++k) tile[lane + 32 * k] = s[k];
  __syncthreads();
  float* const out = st.part + static_cast<size_t>(split) * 3 * n;
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int i = base + r;
    if (i >= n) break;
    float4 v = slots[0][r];
    for (int q = 1; q < kQ; ++q) {
      const float4 u = slots[q][r];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
    }
    out[i] = v.x;
    out[n + i] = v.y;
    out[2 * n + i] = v.z;
  }
  __syncthreads();  // the slots are the next unit's tiles
}

__device__ void sweep(const State& st, const Plan& plan, float4 (*slots)[kSlot],
                      float eps2) {
  const int units = plan.tiles * plan.splits;
  for (int u = blockIdx.x; u < units; u += gridDim.x)
    sweep_unit(st, plan, u % plan.tiles, u / plan.tiles, slots, eps2);
}

__global__ void __launch_bounds__(kThreads, 1)
fused_kdk_kernel(State st, Plan plan, int steps, float dt, float half_dt, float G,
                 float eps2, int ds) {
  __shared__ float4 slots[kQ][kSlot];
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;

  sweep(st, plan, slots, eps2);  // seed a(t) from the positions
  grid.sync();
  for (int i = first; i < st.n; i += stride) gather(st, plan, i, G);
  for (int s = 0; s < steps; ++s) {
    for (int i = first; i < st.n; i += stride) {
      kick(st, i, half_dt, ds);
      drift(st, i, dt, ds);
    }
    grid.sync();
    sweep(st, plan, slots, eps2);
    grid.sync();
    for (int i = first; i < st.n; i += stride) {
      gather(st, plan, i, G);
      kick(st, i, half_dt, ds);
    }
  }
}

cudaError_t resident_blocks(int device, int* blocks) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kdk_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Advances the state in place by `steps` KDK steps. All arrays are float32
// device arrays laid out as documented in State, part [splits, 3, n]
// scratch; eps2 must be > 0. The plan (launch_plan in
// ops/fused_rollout.py): j splits of split_len bodies, warp slices of
// warp_len, `grid` blocks, at most the co-resident count.
int fused_kdk(void* pos_hi, void* pos_lo, void* vel_hi, void* vel_lo, void* acc, void* part,
              const void* mass, const void* keep, int n, int steps, float dt,
              float half_dt, float G, float eps2, int ds, int splits, int split_len,
              int warp_len, int grid, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  if (!(eps2 > 0.0f) || splits < 1 || split_len < 1 || warp_len < 1 ||
      static_cast<long long>(splits) * split_len < n ||
      static_cast<long long>(kQ) * warp_len < split_len)
    return cudaErrorInvalidValue;
  int resident = 0;
  err = resident_blocks(device, &resident);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > resident) return cudaErrorInvalidConfiguration;

  State st{static_cast<float*>(pos_hi), static_cast<float*>(pos_lo),
           static_cast<float*>(vel_hi), static_cast<float*>(vel_lo),
           static_cast<float*>(acc),    static_cast<float*>(part),
           static_cast<const float*>(mass), static_cast<const float*>(keep), n};
  Plan plan{(n + kRows - 1) / kRows, splits, split_len, warp_len};
  void* args[] = {&st, &plan, &steps, &dt, &half_dt, &G, &eps2, &ds};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_kdk_kernel),
                                    dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch shape on the current device: shape[0..4] = i bodies a thread,
// warps (j slices) a block, j bodies a tile, threads a block, co-resident
// blocks (0 if the device cannot tell: the launch then fails). n is unused:
// the plan that fits n is launch_plan's.
void fused_kdk_shape(int n, int* shape) {
  (void)n;
  int device = 0, resident = 0;
  if (cudaGetDevice(&device) != cudaSuccess || resident_blocks(device, &resident) != cudaSuccess)
    resident = 0;
  shape[0] = kK;
  shape[1] = kQ;
  shape[2] = kTile;
  shape[3] = kThreads;
  shape[4] = resident;
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
