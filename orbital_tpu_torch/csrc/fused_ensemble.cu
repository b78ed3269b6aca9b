// K leapfrog (kick-drift-kick) steps of E independent N-body systems in one
// launch, for Hopper (sm_90a): the batched sibling of fused_rollout.cu (B4).
//
// Replaces: no Pallas kernel. It stands in for the XLA code of
// orbital_tpu/parallel/ensemble.py:53-69, jax.vmap over
// rollout(..., fused="never") on the dense force path (the TPU's whole-
// rollout kernel, orbital_tpu/ops/fused_rollout.py::_fused_kernel, is not
// vmapped), and of bench.py:542-552's vmapped step (BASELINE config 5:
// 1,024 perturbed 26-body solar systems). In eager PyTorch the same step is
// about fifty launches of [E, N, N] tensors.
//
// What bounds it on this card: a step at E = 1,024 and N = 26 is 692,224
// pairs, 18 f32 operations and one rsqrt each: ~0.19 us of the card's f32
// and rsqrt peaks, against O(E N) kick and drift work. The state (~64 bytes
// a body) is read once and written once a launch. With one warp a member
// there are 1,024 warps on 528 schedulers, each lane walking a serial chain
// of N pairs, so this first version is latency-bound, not throughput-bound.
//
// Design: members are independent, so this is a plain launch (no grid-wide
// barrier, unlike B4). A member's state (hi and lo positions and
// velocities, acc, mass * alive, alive) is read once into shared memory,
// stays there for all K steps and is written once. Its team of threads owns
// bodies i = t, t + team, ...:
//  - N <= 32: one warp a member, one lane a body, kWarps members a block,
//    the team's barrier __syncwarp;
//  - N > 32: one member a block of min(256, N rounded up to 32) threads,
//    the team's barrier __syncthreads.
// A step: kick(dt/2) + drift of own bodies, which write their hi positions
// (and mass) to the member's float4 table; barrier; each own body sums its
// acceleration over j = 0, 1, ..., N-1 in that order (no float atomics, so
// reruns are bit-equal) from the table, then kicks; barrier. The launch
// starts by seeding a(t) from the hi positions (as fused_rollout_plain in
// ops/fused_rollout.py) and closes with each member's softened potential
// from the last evaluation (with K = 0 it only evaluates acc and potential:
// ensemble_rollout's force initialisation). ENSEMBLE_MAX_N is set by shared
// memory: 68 bytes a body (+128) of the 227 KB a block can use.
//
// Arithmetic: exactly the eager kdk of engine/integrators.py, only the hi
// words entering the sweep. One MUFU.RSQ a pair (rsqrt.approx.ftz) with
// eps2 folded into the r2 chain: eps2 > 0 (the wrapper requires it), so
// r2 + eps2 is never denormal. Dead bodies have mass 0 (they exert nothing)
// and keep = 0 (their acceleration is zeroed). The double-single updates
// use explicitly rounded intrinsics (__fadd_rn, __fsub_rn, __fmul_rn), which
// nvcc never contracts into fused multiply-adds, so the two-sums stay exact
// at any -fmad setting; with ds == 0 each update is one rounded multiply and
// add, the eager f32 stepper's arithmetic. The clock advances by one
// rounded add of dt a step, as the stepper's.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;            // members a block when N <= 32
constexpr int kBlockThreads = 256;   // most threads a member's block when N > 32
constexpr int kMaxN = 3072;          // ENSEMBLE_MAX_N (68 * 3072 + 128 bytes)

struct Args {
  float* pos_hi;  // [E, n, 3] in / out
  float* pos_lo;  // [E, n, 3] in / out (ds only)
  float* vel_hi;  // [E, n, 3] in / out
  float* vel_lo;  // [E, n, 3] in / out (ds only)
  float* acc;     // [E, n, 3] out: the last evaluation's acceleration
  float* pot;     // [E] out: the last evaluation's softened potential
  float* time;    // [E] in / out
  const float* mass;  // [E, n] mass * alive
  const float* keep;  // [E, n] alive as 0 / 1
  int members, n, steps;
  float dt, half_dt, G, eps2;
  int ds;
};

// bytes of one member's shared region: pm float4 [n], then lo pos, hi and
// lo vel and acc ([3, n] each), keep [n] and 32 reduction slots, rounded to
// 16 bytes
__host__ __device__ __forceinline__ int member_bytes(int n) {
  return ((68 * n + 128) + 15) / 16 * 16;
}

// (hi, lo) += x, renormalized: Knuth two-sum then Dekker fast-two-sum.
__device__ __forceinline__ void ds_add(float& hi, float& lo, float x) {
  const float s = __fadd_rn(hi, x);
  const float bb = __fsub_rn(s, hi);
  const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(x, bb));
  const float e = __fadd_rn(err, lo);
  hi = __fadd_rn(s, e);
  lo = __fsub_rn(e, __fsub_rn(hi, s));
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

template <bool kWarp>
__device__ __forceinline__ void team_sync() {
  if (kWarp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// One member's state in shared memory.
struct Member {
  float4* pm;  // [n] hi position, mass * alive
  float* plo;  // [3, n]
  float* vhi;  // [3, n]
  float* vlo;  // [3, n]
  float* acc;  // [3, n]
  float* keep; // [n]
  float* red;  // [32] the warps' potential sums
};

// kick(h): v += h a of body i (compensated when ds)
__device__ __forceinline__ void kick(const Member& s, int n, int i, float h, bool ds) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int k = c * n + i;
    const float inc = __fmul_rn(h, s.acc[k]);
    if (ds) {
      ds_add(s.vhi[k], s.vlo[k], inc);
    } else {
      s.vhi[k] = __fadd_rn(s.vhi[k], inc);
    }
  }
}

// drift(dt): x += dt v_hi (+ dt v_lo when ds) of body i, its hi words into
// the sweep's table
__device__ __forceinline__ void drift(const Member& s, int n, int i, float dt, bool ds) {
  const float4 p = s.pm[i];
  float x[3] = {p.x, p.y, p.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int k = c * n + i;
    if (ds) {
      float lo = s.plo[k];
      ds_add(x[c], lo, __fmul_rn(dt, s.vhi[k]));
      ds_add(x[c], lo, __fmul_rn(dt, s.vlo[k]));
      s.plo[k] = lo;
    } else {
      x[c] = __fadd_rn(x[c], __fmul_rn(dt, s.vhi[k]));
    }
  }
  s.pm[i] = make_float4(x[0], x[1], x[2], p.w);
}

// a(i) = G keep_i sum_j m_j (r_j - r_i) / (|r_j - r_i|^2 + eps2)^(3/2) for the
// team's own bodies, j in index order (the self pair adds exactly 0). With
// kPE it also returns the thread's sum of m_i sum_{j != i} m_j / r_ij.
template <bool kPE>
__device__ __forceinline__ float forces(const Member& s, int n, int t, int team, float G,
                                        float eps2) {
  float pe_sum = 0.0f;
  for (int i = t; i < n; i += team) {
    const float4 pi = s.pm[i];
    float ax = 0.0f, ay = 0.0f, az = 0.0f, pe = 0.0f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 pj = s.pm[j];
      const float dx = pj.x - pi.x;
      const float dy = pj.y - pi.y;
      const float dz = pj.z - pi.z;
      const float inv_r = rsqrt_ftz(fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2))));
      const float w = pj.w * (inv_r * inv_r * inv_r);
      ax = fmaf(w, dx, ax);
      ay = fmaf(w, dy, ay);
      az = fmaf(w, dz, az);
      if (kPE) pe = fmaf(j == i ? 0.0f : pj.w, inv_r, pe);
    }
    const float g = G * s.keep[i];
    s.acc[i] = g * ax;
    s.acc[n + i] = g * ay;
    s.acc[2 * n + i] = g * az;
    if (kPE) pe_sum = fmaf(pi.w, pe, pe_sum);
  }
  return pe_sum;
}

// U = -G/2 sum_i m_i pe_i over the team, in a fixed order: a butterfly in
// each warp, then the warps' sums in warp order. Every thread of the team
// calls it; thread 0 returns U.
template <bool kWarp>
__device__ __forceinline__ float team_potential(const Member& s, int t, int team, float part,
                                                float G) {
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (kWarp) return -0.5f * G * part;
  if ((t & 31) == 0) s.red[t >> 5] = part;
  __syncthreads();
  float sum = 0.0f;
  if (t == 0)
    for (int w = 0; w < team / 32; ++w) sum += s.red[w];
  return -0.5f * G * sum;
}

template <bool kWarp>
__global__ void __launch_bounds__(kWarp ? 32 * kWarps : kBlockThreads)
ensemble_kernel(Args a) {
  extern __shared__ float4 smem[];
  const int team = kWarp ? 32 : blockDim.x;
  const int t = kWarp ? (threadIdx.x & 31) : threadIdx.x;
  const int slot = kWarp ? (threadIdx.x >> 5) : 0;
  const long long m = kWarp ? static_cast<long long>(blockIdx.x) * kWarps + slot
                            : static_cast<long long>(blockIdx.x);
  if (m >= a.members) return;  // a whole warp (kWarp) or block leaves
  const int n = a.n;
  const bool ds = a.ds != 0;

  Member s;
  s.pm = reinterpret_cast<float4*>(reinterpret_cast<char*>(smem) + slot * member_bytes(n));
  s.plo = reinterpret_cast<float*>(s.pm + n);
  s.vhi = s.plo + 3 * n;
  s.vlo = s.vhi + 3 * n;
  s.acc = s.vlo + 3 * n;
  s.keep = s.acc + 3 * n;
  s.red = s.keep + n;

  const size_t body0 = static_cast<size_t>(m) * n;
  for (int i = t; i < n; i += team) {
    const size_t g = (body0 + i) * 3;
    s.pm[i] = make_float4(a.pos_hi[g], a.pos_hi[g + 1], a.pos_hi[g + 2], a.mass[body0 + i]);
    s.keep[i] = a.keep[body0 + i];
    for (int c = 0; c < 3; ++c) {
      s.vhi[c * n + i] = a.vel_hi[g + c];
      s.plo[c * n + i] = ds ? a.pos_lo[g + c] : 0.0f;
      s.vlo[c * n + i] = ds ? a.vel_lo[g + c] : 0.0f;
    }
  }
  team_sync<kWarp>();

  float clock = a.time[m];
  float pe_part = a.steps == 0 ? forces<true>(s, n, t, team, a.G, a.eps2)
                               : forces<false>(s, n, t, team, a.G, a.eps2);
  team_sync<kWarp>();
  for (int step = 0; step < a.steps; ++step) {
    for (int i = t; i < n; i += team) {
      kick(s, n, i, a.half_dt, ds);
      drift(s, n, i, a.dt, ds);
    }
    team_sync<kWarp>();
    if (step == a.steps - 1) {
      pe_part = forces<true>(s, n, t, team, a.G, a.eps2);
    } else {
      forces<false>(s, n, t, team, a.G, a.eps2);
    }
    for (int i = t; i < n; i += team) kick(s, n, i, a.half_dt, ds);
    team_sync<kWarp>();
    clock = __fadd_rn(clock, a.dt);
  }

  const float U = team_potential<kWarp>(s, t, team, pe_part, a.G);
  if (t == 0) {
    a.pot[m] = U;
    a.time[m] = clock;
  }
  for (int i = t; i < n; i += team) {
    const size_t g = (body0 + i) * 3;
    const float4 p = s.pm[i];
    a.pos_hi[g] = p.x;
    a.pos_hi[g + 1] = p.y;
    a.pos_hi[g + 2] = p.z;
    for (int c = 0; c < 3; ++c) {
      a.vel_hi[g + c] = s.vhi[c * n + i];
      a.acc[g + c] = s.acc[c * n + i];
      if (ds) {
        a.pos_lo[g + c] = s.plo[c * n + i];
        a.vel_lo[g + c] = s.vlo[c * n + i];
      }
    }
  }
}

// the launch shape for n bodies: members a block, threads a block, dynamic
// shared bytes a block
void shape_for(int n, int* members_a_block, int* threads, int* bytes) {
  if (n <= 32) {
    *members_a_block = kWarps;
    *threads = 32 * kWarps;
    *bytes = kWarps * member_bytes(n);
  } else {
    *members_a_block = 1;
    *threads = ((n + 31) / 32) * 32 < kBlockThreads ? ((n + 31) / 32) * 32 : kBlockThreads;
    *bytes = member_bytes(n);
  }
}

}  // namespace

extern "C" {

// Advances E = members independent states in place by `steps` KDK steps
// (steps = 0: evaluates acc and potential only). All arrays are float32
// device arrays laid out as documented in Args; pos_lo and vel_lo are read
// and written only when ds != 0. 1 <= n <= kMaxN and eps2 > 0.
int fused_ensemble(void* pos_hi, void* pos_lo, void* vel_hi, void* vel_lo, void* acc,
                   void* pot, void* time, const void* mass, const void* keep, int members,
                   int n, int steps, float dt, float half_dt, float G, float eps2, int ds,
                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (members <= 0) return cudaSuccess;
  if (n < 1 || n > kMaxN || steps < 0 || !(eps2 > 0.0f)) return cudaErrorInvalidValue;
  Args a{static_cast<float*>(pos_hi), static_cast<float*>(pos_lo),
         static_cast<float*>(vel_hi), static_cast<float*>(vel_lo),
         static_cast<float*>(acc),    static_cast<float*>(pot),
         static_cast<float*>(time),   static_cast<const float*>(mass),
         static_cast<const float*>(keep), members, n, steps, dt, half_dt, G, eps2, ds};
  int per_block = 0, threads = 0, bytes = 0;
  shape_for(n, &per_block, &threads, &bytes);
  const unsigned grid = static_cast<unsigned>((members + per_block - 1) / per_block);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 32) {
    ensemble_kernel<true><<<grid, threads, bytes, st>>>(a);
  } else {
    err = cudaFuncSetAttribute(ensemble_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ensemble_kernel<false><<<grid, threads, bytes, st>>>(a);
  }
  return cudaGetLastError();
}

// The launch shape for n bodies: shape[0..3] = members a block, threads a
// block, dynamic shared bytes a block, the largest n (ENSEMBLE_MAX_N).
void fused_ensemble_shape(int n, int* shape) {
  shape_for(n < 1 ? 1 : n, &shape[0], &shape[1], &shape[2]);
  shape[3] = kMaxN;
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
