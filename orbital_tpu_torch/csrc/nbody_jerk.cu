// Softened O(N^2) acceleration + jerk sweep for Hopper (sm_90a): the force
// evaluation of the 4th-order Hermite integrator (B5).
//
// Replaces: orbital_tpu/ops/pallas_jerk.py::_jerk_kernel, the TPU kernel
// behind accel_jerk_pallas (full sweep) and accel_jerk_detect_pallas (the
// same sweep counting contacts). The row-subset variant (jerk_subset_kernel)
// takes the place of the plain XLA accel_jerk_subset (orbital_tpu/ops/
// forces.py) that the block-timestep steppers call m times per macro step.
//
//   s^2    = |r_ij|^2 + eps^2,  r_ij = r_j - r_i,  v_ij = v_j - v_i
//   acc_i  = G sum_j m_j r_ij / s^3
//   jerk_i = G sum_j m_j [v_ij - 3 (r_ij . v_ij) r_ij / s^2] / s^3
//   pe_i   =   sum_j m_j / s                                (full sweep)
//   count += #{(i, j) : |r_ij|^2 <= ((R_i + R_j) * 1.00001)^2}  (kDetect)
//
// What bounds it on this card: instruction issue. A pair costs 42 f32
// operations (a fused multiply-add counted as two) and one MUFU.RSQ, but
// they are 29 warp instructions, 14 of them single FADD/FMUL, and the card
// issues one warp instruction a clock on each of its 528 schedulers: at
// 65,536 bodies one instruction a pair costs 0.128 ms at 1.98 GHz, against
// 0.064 ms for two flops a pair at the f32 peak. Device memory traffic is
// O(N) a block and stays in L2. The inner loop of this build (cuobjdump
// -sass, sm_90a) takes 30.6 warp instructions a pair (31.6 with kDetect),
// against 35.5 (41.5) for the first version: a 3.93 ms floor at 65,536
// bodies, which it reaches to ~77% on an NVIDIA H100 80GB HBM3 at 700 W
// with the SM clock at 1,980 MHz (chip_smoke.py --parent; PERF.md).
//
// Design, as the force sweep (nbody_forces.cu, which says more):
// - Each thread holds kK i bodies in registers (position, velocity and
//   radius; rows base + lane + 32 k of its block), so each pair of j tile
//   entries, (x, y, z, m) and (vx, vy, vz, R), read from shared memory
//   serves kK pairs, and the thread has kK independent chains of sums.
// - Each block covers 32 kK i bodies with kQ warps; warp w sweeps j tiles
//   w, w + kQ, ... of kTile bodies, staged by the warp into its own shared
//   tiles under a warp barrier.
// - Each tile is summed into fresh partials before it joins the warp's
//   running sums: a two-level sum whose f32 rounding grows with the tile
//   and tile counts, not with N. The jerk terms cancel more than the acc
//   terms do, so they need it more. The kQ running sums of each i body are
//   then added in shared memory in warp order: no float atomics, the same
//   result from run to run.
// - The softened path takes one MUFU.RSQ a pair (rsqrt.approx.ftz; its
//   argument is >= eps2 > 0, so the bits are rsqrtf's without its denormal
//   fix-up); the eps2 == 0 path keeps rsqrtf.
// - The ragged last tile is cut by its own trip count, so N need not divide
//   by the tile; rows past n are swept against zeros and not written.
//   Padded and dead bodies arrive with mass 0.
// - With kQ = 1 each row's summation order is the first version's: that
//   build is bit-equal to it.
// - kK = 2, kQ = 8, kTile = 128: 64 i bodies and 256 threads a block, 1,024
//   blocks at 65,536 bodies, 95 registers, no spills. In the sweep
//   (chip_smoke.py --sweep; PERF.md) k = 4 took 0.6 instructions a pair less
//   but ran slower: 143 registers leave one block of 8 warps an SM. kK and
//   kQ are the OT_JERK_K and OT_JERK_Q macros below, which the sweep sets
//   with -D; chip_smoke.py's phase 2 prints the shape, registers and SASS
//   instructions a pair it built.
//
// Masking, as in the TPU kernel: with eps2 > 0 nothing is masked (a self
// pair has r_ij = v_ij = 0 and adds no acc and no jerk; it adds m_i/eps to
// pe_i, which the caller subtracts). With eps2 == 0 an r2 > 0 select drops
// self pairs and coincident bodies. Never mask i == j as well: the caller's
// self-PE subtraction would then remove the self term twice.
//
// Contact detection (kDetect): the radii ride in the w of the velocity
// tile; the count's work is separate from the sweep's, on the same launch
// shape, so acc, jerk and pe are bit-equal to those of the non-detecting
// launch. As in nbody_forces.cu, the sweep keeps each row's nearest r2 in a
// tile (one FMNMX a pair) and the warp counts the tile exactly, on the same
// unsoftened r2, only where that r2 passes the test at the tile's largest
// radius. Each thread counts each of its rows in an int and drops the rows
// past n; a warp reduction, one shared slot per warp and one atomicAdd per
// block sum them into one int32. Self pairs (r2 = 0) are counted, so the
// caller starts the counter at -N. Dead bodies carry radius 0 and sit at
// spread-out far positions, adding only their self pair.
//
// Row subset (jerk_subset_kernel): the i rows are gathered through an index list of F
// targets (F is at most hermite_fast_cap, a few dozen), which would fill
// one or two of the 132 SMs. So the j range is split across the grid's y
// dimension, each block sweeping `split` sources, and each writes its
// partials to out[split index, row, 0:6]; the caller sums them with one
// deterministic reduction instead of float atomics. No pe and no count.
// A self pair adds exactly zero acc and jerk here too, so no index mask is
// needed and the result equals the index-masked plain version.
//
// Plain C interface for ctypes: pointers and the stream are void*, and each
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

#ifndef OT_JERK_K
#define OT_JERK_K 2
#endif
#ifndef OT_JERK_Q
#define OT_JERK_Q 8
#endif

namespace {

constexpr int kK = OT_JERK_K;          // i bodies a thread, full sweep
constexpr int kQ = OT_JERK_Q;          // warps a block, one j slice each
constexpr int kTile = 128;             // j bodies a warp's tile
constexpr int kThreads = 32 * kQ;
constexpr int kRows = 32 * kK;         // i bodies a block
// a warp's shared slots: its two tiles during the sweep, its sums after it
constexpr int kSlot = kTile > kRows ? kTile : kRows;
static_assert(kK >= 1 && kQ >= 1 && kTile % 32 == 0, "bad launch shape");
constexpr int kSubsetBlock = 64;  // target rows per block and j bodies per tile, subset

struct Sums {
  float ax, ay, az, jx, jy, jz, pe;
};

__device__ __forceinline__ Sums zero_sums() { return Sums{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}; }

__device__ __forceinline__ void add_sums(Sums& s, const Sums& t) {
  s.ax += t.ax;
  s.ay += t.ay;
  s.az += t.az;
  s.jx += t.jx;
  s.jy += t.jy;
  s.jz += t.jz;
  s.pe += t.pe;
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

// |r_j - r_i|^2 in one rounding order, shared by the sweep and the exact
// count, so that the count's prefilter and its test read the same value
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return fmaf(dz, dz, fmaf(dx, dx, dy * dy));
}

// Sums `count` tile entries into fresh partials t of each of the NI rows,
// which the caller adds to its running totals; with kDetect, also each
// row's nearest r2 in the tile. pi = (x, y, z, m), vi = (vx, vy, vz, R) of
// the i bodies.
template <int NI, bool kSoft, bool kPE, bool kDetect>
__device__ __forceinline__ void sweep_tile(const float4* tp, const float4* tv, int count,
                                           const float4 (&pi)[NI], const float4 (&vi)[NI],
                                           float eps2, Sums (&t)[NI], float (&nearest)[NI]) {
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    t[k] = zero_sums();
    nearest[k] = __int_as_float(0x7f800000);  // +inf
  }
#pragma unroll 4
  for (int jj = 0; jj < count; ++jj) {
    const float4 pj = tp[jj];
    const float4 vj = tv[jj];
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const float dx = pj.x - pi[k].x;
      const float dy = pj.y - pi[k].y;
      const float dz = pj.z - pi[k].z;
      const float dvx = vj.x - vi[k].x;
      const float dvy = vj.y - vi[k].y;
      const float dvz = vj.z - vi[k].z;
      const float r2 = dist2(dx, dy, dz);
      if (kDetect) nearest[k] = fminf(nearest[k], r2);
      float inv;
      if (kSoft) {
        inv = rsqrt_ftz(r2 + eps2);
      } else {
        inv = r2 > 0.0f ? rsqrtf(r2) : 0.0f;
      }
      const float inv2 = inv * inv;
      const float w = pj.w * (inv2 * inv);     // m_j / s^3
      const float rv = dx * dvx + dy * dvy + dz * dvz;
      const float c = 3.0f * rv * inv2;         // 3 (r.v) / s^2
      t[k].ax += w * dx;
      t[k].ay += w * dy;
      t[k].az += w * dz;
      t[k].jx += w * (dvx - c * dx);
      t[k].jy += w * (dvy - c * dy);
      t[k].jz += w * (dvz - c * dz);
      if (kPE) t[k].pe += pj.w * inv;
    }
  }
}

// The exact contact count of one tile: r2 <= ((R_i + R_j) * 1.00001)^2,
// the radii in the w of the velocity rows.
__device__ __forceinline__ void count_tile(const float4* tp, const float4* tv, int count,
                                           const float4 (&pi)[kK], const float4 (&vi)[kK],
                                           int (&touch)[kK]) {
  for (int jj = 0; jj < count; ++jj) {
    const float4 pj = tp[jj];
    const float rj = tv[jj].w;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float r2 = dist2(pj.x - pi[k].x, pj.y - pi[k].y, pj.z - pi[k].z);
      const float rsum = (vi[k].w + rj) * 1.00001f;
      touch[k] += r2 <= rsum * rsum;
    }
  }
}

// The second bound (one block an SM) lets ptxas use up to 255 registers a
// thread. Without it ptxas aims at three blocks an SM and caps the kernel at
// 80 registers. That ran B5 4% slower (chip_smoke.py; PERF.md).
template <bool kSoft, bool kDetect>
__global__ void __launch_bounds__(kThreads, 1)
jerk_kernel(const float4* __restrict__ pm, const float4* __restrict__ vr, int n, float G,
            float eps2, float4* __restrict__ out, int* __restrict__ contacts) {
  __shared__ float4 slot_p[kQ][kSlot];
  __shared__ float4 slot_v[kQ][kSlot];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kRows;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 pi[kK], vi[kK];
  Sums s[kK];
  int touch[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int i = base + lane + 32 * k;
    pi[k] = i < n ? pm[i] : zero;
    vi[k] = i < n ? vr[i] : zero;
    s[k] = zero_sums();
    touch[k] = 0;
  }
  float4* tp = slot_p[warp];
  float4* tv = slot_v[warp];
  for (int j0 = warp * kTile; j0 < n; j0 += kQ * kTile) {
    float rmax = 0.0f;  // the largest radius this lane staged
#pragma unroll
    for (int r = lane; r < kTile; r += 32) {
      if (j0 + r < n) {
        const float4 vj = vr[j0 + r];
        tp[r] = pm[j0 + r];
        tv[r] = vj;
        rmax = fmaxf(rmax, vj.w);
      }
    }
    __syncwarp();
    const int count = min(kTile, n - j0);
    Sums t[kK];
    float nearest[kK];
    if (count == kTile) {
      sweep_tile<kK, kSoft, true, kDetect>(tp, tv, kTile, pi, vi, eps2, t, nearest);
    } else {
      sweep_tile<kK, kSoft, true, kDetect>(tp, tv, count, pi, vi, eps2, t, nearest);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) add_sums(s[k], t[k]);
    if (kDetect) {
      // the prefilter of nbody_forces.cu: count the tile exactly only if some
      // row's nearest r2 passes the test at the tile's largest radius
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      bool maybe = false;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const float rsum = (vi[k].w + rmax) * 1.00001f;
        maybe = maybe || nearest[k] <= rsum * rsum;
      }
      if (__any_sync(0xffffffffu, maybe)) count_tile(tp, tv, count, pi, vi, touch);
    }
    __syncwarp();
  }
  // the kQ slices' sums of each row, added in warp order
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    tp[lane + 32 * k] = make_float4(s[k].ax, s[k].ay, s[k].az, s[k].jx);
    tv[lane + 32 * k] = make_float4(s[k].jy, s[k].jz, s[k].pe, 0.0f);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int i = base + r;
    if (i >= n) break;
    float4 a = slot_p[0][r];
    float4 b = slot_v[0][r];
    for (int q = 1; q < kQ; ++q) {
      const float4 c = slot_p[q][r];
      const float4 d = slot_v[q][r];
      a.x += c.x;
      a.y += c.y;
      a.z += c.z;
      a.w += c.w;
      b.x += d.x;
      b.y += d.y;
      b.z += d.z;
    }
    // [N, 8] row: acc (3), jerk (3), pe, 0 -- the TPU kernel's output layout
    out[2 * i] = make_float4(G * a.x, G * a.y, G * a.z, G * a.w);
    out[2 * i + 1] = make_float4(G * b.x, G * b.y, b.z, 0.0f);
  }
  if (kDetect) {
    // rows past n counted against the zero-padded pi: drop them
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kK; ++k) mine += base + lane + 32 * k < n ? touch[k] : 0;
    mine = __reduce_add_sync(0xffffffffu, mine);
    __shared__ int warp_sums[kQ];
    if (lane == 0) warp_sums[warp] = mine;
    __syncthreads();
    if (threadIdx.x == 0) {
      int block_sum = 0;
#pragma unroll
      for (int w = 0; w < kQ; ++w) block_sum += warp_sums[w];
      atomicAdd(contacts, block_sum);
    }
  }
}

template <bool kSoft>
__global__ void __launch_bounds__(kSubsetBlock)
jerk_subset_kernel(const float4* __restrict__ pm, const float4* __restrict__ vr,
                   const long long* __restrict__ idx, int f, int n, int split, float G,
                   float eps2, float* __restrict__ out) {
  __shared__ float4 tp[kSubsetBlock];
  __shared__ float4 tv[kSubsetBlock];
  const int row = blockIdx.x * kSubsetBlock + threadIdx.x;
  const int j_begin = blockIdx.y * split;
  const int j_end = min(j_begin + split, n);
  float4 pi[1] = {make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
  float4 vi[1] = {pi[0]};
  if (row < f) {
    // clamp as a JAX gather does; the steppers pass argsort indices
    const long long g = min(max(idx[row], 0LL), static_cast<long long>(n - 1));
    pi[0] = pm[g];
    vi[0] = vr[g];
  }
  Sums s = zero_sums();
  float unused[1];
  for (int j0 = j_begin; j0 < j_end; j0 += kSubsetBlock) {
    const int j = j0 + threadIdx.x;
    if (j < j_end) {
      tp[threadIdx.x] = pm[j];
      tv[threadIdx.x] = vr[j];
    }
    __syncthreads();
    Sums t[1];
    if (j_end - j0 >= kSubsetBlock) {
      sweep_tile<1, kSoft, false, false>(tp, tv, kSubsetBlock, pi, vi, eps2, t, unused);
    } else {
      sweep_tile<1, kSoft, false, false>(tp, tv, j_end - j0, pi, vi, eps2, t, unused);
    }
    add_sums(s, t[0]);
    __syncthreads();
  }
  if (row < f) {
    float* o = out + (static_cast<size_t>(blockIdx.y) * f + row) * 6;
    o[0] = G * s.ax;
    o[1] = G * s.ay;
    o[2] = G * s.az;
    o[3] = G * s.jx;
    o[4] = G * s.jy;
    o[5] = G * s.jz;
  }
}

template <bool kDetect>
int launch_full(const void* pm, const void* vr, int n, float G, float eps2, void* out,
                void* contacts, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  const int grid = (n + kRows - 1) / kRows;
  const auto* p = static_cast<const float4*>(pm);
  const auto* v = static_cast<const float4*>(vr);
  auto* o = static_cast<float4*>(out);
  auto* c = static_cast<int*>(contacts);
  auto s = static_cast<cudaStream_t>(stream);
  if (eps2 > 0.0f) {
    jerk_kernel<true, kDetect><<<grid, kThreads, 0, s>>>(p, v, n, G, eps2, o, c);
  } else {
    jerk_kernel<false, kDetect><<<grid, kThreads, 0, s>>>(p, v, n, G, eps2, o, c);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pm: [n] float4 (x, y, z, mass_eff); vr: [n] float4 (vx, vy, vz, unused);
// out: [n, 8] float (G*acc, G*jerk, pe, 0).
int nbody_jerk(const void* pm, const void* vr, int n, float G, float eps2, void* out,
               void* stream, int device) {
  return launch_full<false>(pm, vr, n, G, eps2, out, nullptr, stream, device);
}

// nbody_jerk with vr's w = R_i * alive_i and contacts: one int32 on the
// device, which the caller sets to -n; the kernel adds the directed
// touching-pair count including the n self pairs.
int nbody_jerk_detect(const void* pm, const void* vr, int n, float G, float eps2, void* out,
                      void* contacts, void* stream, int device) {
  return launch_full<true>(pm, vr, n, G, eps2, out, contacts, stream, device);
}

// idx: [f] int64 target rows; out: [ceil(n / split), f, 6] float partials
// (G*acc, G*jerk) of each block of `split` sources, to be summed over dim 0.
int nbody_jerk_subset(const void* pm, const void* vr, const void* idx, int f, int n,
                      int split, float G, float eps2, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (f <= 0 || n <= 0) return cudaSuccess;
  if (split <= 0) return cudaErrorInvalidValue;
  const dim3 grid((f + kSubsetBlock - 1) / kSubsetBlock, (n + split - 1) / split);
  const auto* p = static_cast<const float4*>(pm);
  const auto* v = static_cast<const float4*>(vr);
  const auto* ix = static_cast<const long long*>(idx);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (eps2 > 0.0f) {
    jerk_subset_kernel<true><<<grid, kSubsetBlock, 0, s>>>(p, v, ix, f, n, split, G, eps2, o);
  } else {
    jerk_subset_kernel<false><<<grid, kSubsetBlock, 0, s>>>(p, v, ix, f, n, split, G, eps2, o);
  }
  return cudaGetLastError();
}

// The launch shape of the full sweep at n bodies: shape[0..4] = i bodies a
// thread, warps (j slices) a block, j bodies a tile, threads a block, blocks.
void nbody_jerk_shape(int n, int* shape) {
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
