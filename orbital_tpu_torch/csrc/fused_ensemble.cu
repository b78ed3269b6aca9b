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
// and rsqrt peaks, against O(E N) kick and drift work (four double-single
// adds of ten operations each a coordinate a step). The state (~64 bytes a
// body) is read once and written once a launch. The first version (one
// warp a member, a lane a body walking all N pairs, its kicks and drifts
// reading and writing the state in shared memory, two barriers a step) ran
// at 10% of that bound, one warp's chain setting the step.
//
// Design: members are independent, so this is a plain launch (no grid-wide
// barrier, unlike B4), one member a block, and a member's state is read
// once, stays on chip for all K steps and is written once.
//
// N <= 32 (team kernel; config 5): one warp a member, lane i owning body i.
// The lane
//  - sweeps the member's float4 table (hi position, mass) in kChains = 2
//    independent FMA chains, added in chain order;
//  - holds its body's hi and lo position and velocity in registers for all
//    K steps: it kicks (closing the step), kicks again (opening the next)
//    and drifts them, the three coordinates' chains independent, and writes
//    the hi words into the next step's table.
// The table is double-buffered: a step's drift writes the buffer the last
// step's sweep did not read, so one barrier a step (after the drift) keeps
// every sweep on whole tables. No float atomics, and the layout follows N
// alone, so a member's result does not depend on the ensemble's size, and
// reruns are bit-equal. Splitting a body's j over 2-8 lanes (an xor
// butterfly, kick and drift on (body, coordinate) lanes) passed every check
// on the card but lost at 1,024 and 8,192 members of 26 bodies, where the
// card is busy enough that the cheapest step wins (PERF.md).
//
// N > 32 (block kernel, the first version's layout): a block of
// min(256, N rounded up to 32) threads, thread t owning bodies t, t + team,
// ..., each summing its j in index order; the state in dynamic shared
// memory (68 bytes a body, ENSEMBLE_MAX_N = 3,072).
//
// Both start by seeding a(t) from the hi positions (as fused_rollout_plain
// in ops/fused_rollout.py) and close with each member's softened potential
// from the last evaluation; with K = 0 they only evaluate acc and potential
// (ensemble_rollout's force initialisation).
//
// Arithmetic: exactly the eager kdk of engine/integrators.py, only the hi
// words entering the sweep. One MUFU.RSQ a pair (rsqrt.approx.ftz) with
// eps2 folded into the r2 chain: eps2 > 0 (the wrapper requires it), so
// r2 + eps2 is never denormal. Dead bodies have mass 0 (they exert nothing)
// and keep = 0 (their acceleration is zeroed). The double-single updates use
// explicitly rounded intrinsics (__fadd_rn, __fsub_rn, __fmul_rn), which
// nvcc never contracts into fused multiply-adds, so the two-sums stay exact
// at any -fmad setting; with ds == 0 each update is one rounded multiply and
// add, the eager f32 stepper's arithmetic. The clock advances by one
// rounded add of dt a step, as the stepper's.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 2;            // independent accumulator chains a lane
constexpr int kTeamMaxN = 32;         // the team kernel's largest N: a lane a body
constexpr int kBlockThreads = 256;    // most threads a member's block when N > 32
constexpr int kMaxN = 3072;           // ENSEMBLE_MAX_N (68 * 3072 + 128 bytes)

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

// v += h a (compensated when ds)
__device__ __forceinline__ void kick1(float& vhi, float& vlo, float h, float a, bool ds) {
  const float inc = __fmul_rn(h, a);
  if (ds) {
    ds_add(vhi, vlo, inc);
  } else {
    vhi = __fadd_rn(vhi, inc);
  }
}

// x += dt v_hi (+ dt v_lo when ds)
__device__ __forceinline__ void drift1(float& xhi, float& xlo, float vhi, float vlo, float dt,
                                       bool ds) {
  if (ds) {
    ds_add(xhi, xlo, __fmul_rn(dt, vhi));
    ds_add(xhi, xlo, __fmul_rn(dt, vlo));
  } else {
    xhi = __fadd_rn(xhi, __fmul_rn(dt, vhi));
  }
}

// One pair: body i at pi against the table entry pj (r_j - r_i); with kPE
// also m_j / r_ij unless j is i.
template <bool kPE>
__device__ __forceinline__ void pair(const float4 pi, const float4 pj, float eps2, bool self,
                                     float (&a)[4]) {
  const float dx = pj.x - pi.x;
  const float dy = pj.y - pi.y;
  const float dz = pj.z - pi.z;
  const float inv_r = rsqrt_ftz(fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2))));
  const float w = pj.w * (inv_r * inv_r * inv_r);
  a[0] = fmaf(w, dx, a[0]);
  a[1] = fmaf(w, dy, a[1]);
  a[2] = fmaf(w, dz, a[2]);
  if (kPE) a[3] = fmaf(self ? 0.0f : pj.w, inv_r, a[3]);
}

// ---------------------------------------------------------------- team kernel

struct TeamShared {
  float4 pm[2][kTeamMaxN];  // hi position, mass * alive (two buffers)
};

// The sweep of lane i over the table pm of n bodies: j in kChains
// independent chains (j into chain j % kChains), added in chain order, so
// it returns (x, y, z, and with kPE sum_{j != i} m_j / r_ij).
template <bool kPE>
__device__ __forceinline__ void team_sweep(const float4* pm, int n, int i, float eps2,
                                           float (&a)[4]) {
  const float4 pi = pm[i];
  float acc[kChains][4];
#pragma unroll
  for (int q = 0; q < kChains; ++q) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.0f;
  }
  int j = 0;
  for (; j + kChains <= n; j += kChains) {
#pragma unroll
    for (int q = 0; q < kChains; ++q) pair<kPE>(pi, pm[j + q], eps2, j + q == i, acc[q]);
  }
  for (; j < n; ++j) pair<kPE>(pi, pm[j], eps2, j == i, acc[0]);
#pragma unroll
  for (int c = 0; c < (kPE ? 4 : 3); ++c) {
    a[c] = acc[0][c];
#pragma unroll
    for (int q = 1; q < kChains; ++q) a[c] += acc[q][c];
  }
}

template <bool kDS>
__global__ void __launch_bounds__(32) ensemble_team_kernel(Args a) {
  __shared__ TeamShared s;
  const int i = threadIdx.x;
  const long long m = blockIdx.x;
  const int n = a.n;
  const bool live = i < n;
  const int si = live ? i : 0;  // lanes past n sweep body 0 and own nothing
  const size_t body0 = static_cast<size_t>(m) * n;

  float xhi[3], xlo[3], vhi[3], vlo[3];
  float mi = 0.0f, gk = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xhi[c] = xlo[c] = vhi[c] = vlo[c] = 0.0f;
    if (live) {
      const size_t gi = (body0 + i) * 3 + c;
      xhi[c] = a.pos_hi[gi];
      vhi[c] = a.vel_hi[gi];
      if (kDS) {
        xlo[c] = a.pos_lo[gi];
        vlo[c] = a.vel_lo[gi];
      }
    }
  }
  if (live) {
    mi = a.mass[body0 + i];
    gk = a.G * a.keep[body0 + i];
    s.pm[0][i] = make_float4(xhi[0], xhi[1], xhi[2], mi);
  }
  __syncthreads();

  float clock = a.time[m];
  float sum[4];
  if (a.steps == 0) {
    team_sweep<true>(s.pm[0], n, si, a.eps2, sum);
  } else {
    team_sweep<false>(s.pm[0], n, si, a.eps2, sum);
  }
  float acc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c] = gk * sum[c];
  for (int step = 0; step < a.steps; ++step) {
    // kick (opening the step) and drift into the other table: a lane still
    // sweeping the last step reads this one, and the barrier below keeps a
    // lane from writing it again before every lane has swept it
    float4* next = s.pm[(step + 1) & 1];
    if (live) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        kick1(vhi[c], vlo[c], a.half_dt, acc[c], kDS);
        drift1(xhi[c], xlo[c], vhi[c], vlo[c], a.dt, kDS);
      }
      next[i] = make_float4(xhi[0], xhi[1], xhi[2], mi);
    }
    __syncthreads();
    if (step == a.steps - 1) {
      team_sweep<true>(next, n, si, a.eps2, sum);
    } else {
      team_sweep<false>(next, n, si, a.eps2, sum);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[c] = gk * sum[c];
      if (live) kick1(vhi[c], vlo[c], a.half_dt, acc[c], kDS);
    }
    clock = __fadd_rn(clock, a.dt);
  }

  // U = -G/2 sum_i m_i pe_i by a butterfly over the warp's lanes
  float part = live ? mi * sum[3] : 0.0f;
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (i == 0) {
    a.pot[m] = -0.5f * a.G * part;
    a.time[m] = clock;
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const size_t gi = (body0 + i) * 3 + c;
      a.pos_hi[gi] = xhi[c];
      a.vel_hi[gi] = vhi[c];
      a.acc[gi] = acc[c];
      if (kDS) {
        a.pos_lo[gi] = xlo[c];
        a.vel_lo[gi] = vlo[c];
      }
    }
  }
}

// --------------------------------------------------------------- block kernel

// bytes of one member's shared region in the block kernel: pm float4 [n],
// then lo pos, hi and lo vel and acc ([3, n] each), keep [n] and 32
// reduction slots, rounded to 16 bytes
__host__ __device__ __forceinline__ int member_bytes(int n) {
  return ((68 * n + 128) + 15) / 16 * 16;
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

// kick(h): v += h a of body i
__device__ __forceinline__ void kick(const Member& s, int n, int i, float h, bool ds) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int k = c * n + i;
    kick1(s.vhi[k], s.vlo[k], h, s.acc[k], ds);
  }
}

// drift(dt): x += dt v of body i, its hi words into the sweep's table
__device__ __forceinline__ void drift(const Member& s, int n, int i, float dt, bool ds) {
  const float4 p = s.pm[i];
  float x[3] = {p.x, p.y, p.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int k = c * n + i;
    drift1(x[c], s.plo[k], s.vhi[k], s.vlo[k], dt, ds);
  }
  s.pm[i] = make_float4(x[0], x[1], x[2], p.w);
}

// a(i) = G keep_i sum_j m_j (r_j - r_i) / (|r_j - r_i|^2 + eps2)^(3/2) for the
// block's own bodies, j in index order (the self pair adds exactly 0). With
// kPE it also returns the thread's sum of m_i sum_{j != i} m_j / r_ij.
template <bool kPE>
__device__ __forceinline__ float forces(const Member& s, int n, int t, int team, float G,
                                        float eps2) {
  float pe_sum = 0.0f;
  for (int i = t; i < n; i += team) {
    const float4 pi = s.pm[i];
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int j = 0; j < n; ++j) pair<kPE>(pi, s.pm[j], eps2, j == i, acc);
    const float g = G * s.keep[i];
    s.acc[i] = g * acc[0];
    s.acc[n + i] = g * acc[1];
    s.acc[2 * n + i] = g * acc[2];
    if (kPE) pe_sum = fmaf(pi.w, acc[3], pe_sum);
  }
  return pe_sum;
}

__global__ void __launch_bounds__(kBlockThreads) ensemble_block_kernel(Args a) {
  extern __shared__ float4 smem[];
  const int team = blockDim.x;
  const int t = threadIdx.x;
  const long long m = blockIdx.x;
  const int n = a.n;
  const bool ds = a.ds != 0;

  Member s;
  s.pm = smem;
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
  __syncthreads();

  float clock = a.time[m];
  float pe_part = a.steps == 0 ? forces<true>(s, n, t, team, a.G, a.eps2)
                               : forces<false>(s, n, t, team, a.G, a.eps2);
  __syncthreads();
  for (int step = 0; step < a.steps; ++step) {
    for (int i = t; i < n; i += team) {
      kick(s, n, i, a.half_dt, ds);
      drift(s, n, i, a.dt, ds);
    }
    __syncthreads();
    if (step == a.steps - 1) {
      pe_part = forces<true>(s, n, t, team, a.G, a.eps2);
    } else {
      forces<false>(s, n, t, team, a.G, a.eps2);
    }
    for (int i = t; i < n; i += team) kick(s, n, i, a.half_dt, ds);
    __syncthreads();
    clock = __fadd_rn(clock, a.dt);
  }

  // U = -G/2 sum_i m_i pe_i in a fixed order: a butterfly in each warp, then
  // the warps' sums in warp order
  for (int off = 16; off > 0; off >>= 1) pe_part += __shfl_xor_sync(0xffffffffu, pe_part, off);
  if ((t & 31) == 0) s.red[t >> 5] = pe_part;
  __syncthreads();
  if (t == 0) {
    float sum = 0.0f;
    for (int w = 0; w < team / 32; ++w) sum += s.red[w];
    a.pot[m] = -0.5f * a.G * sum;
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

// the threads of a member's block for n bodies: one warp in the team
// kernel, min(kBlockThreads, n rounded up to 32) in the block kernel
int member_threads(int n) {
  if (n <= kTeamMaxN) return 32;
  const int up = (n + 31) / 32 * 32;
  return up < kBlockThreads ? up : kBlockThreads;
}

}  // namespace

extern "C" {

// Advances E = members independent states in place by `steps` KDK steps
// (steps = 0: evaluates acc and potential only), one block a member. All
// arrays are float32 device arrays laid out as documented in Args; pos_lo
// and vel_lo are read and written only when ds != 0. 1 <= n <= kMaxN and
// eps2 > 0.
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
  const unsigned grid = static_cast<unsigned>(members);
  const int threads = member_threads(n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kTeamMaxN) {
    if (ds) {
      ensemble_team_kernel<true><<<grid, threads, 0, st>>>(a);
    } else {
      ensemble_team_kernel<false><<<grid, threads, 0, st>>>(a);
    }
  } else {
    const int bytes = member_bytes(n);
    err = cudaFuncSetAttribute(ensemble_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ensemble_block_kernel<<<grid, threads, bytes, st>>>(a);
  }
  return cudaGetLastError();
}

// The launch shape for n bodies: shape[0..5] = members a block, threads a
// block, shared bytes a block (the team kernel's static region or the block
// kernel's dynamic one), the largest n (ENSEMBLE_MAX_N), accumulator chains
// a lane (kChains in the team kernel, 1 in the block kernel) and the j a
// thread walks for each of its bodies in a sweep (n).
void fused_ensemble_shape(int n, int* shape) {
  n = n < 1 ? 1 : n;
  const bool team = n <= kTeamMaxN;
  shape[0] = 1;
  shape[1] = member_threads(n);
  shape[2] = team ? static_cast<int>(sizeof(TeamShared)) : member_bytes(n);
  shape[3] = kMaxN;
  shape[4] = team ? kChains : 1;
  shape[5] = n;
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
