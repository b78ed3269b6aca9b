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
// Row subset (jerk_subset_kernel): acc and jerk of F target rows (F is at
// most hermite_fast_cap, a few dozen) gathered through an index list, from
// all N sources; no pe and no count. At F = 64 and N = 65,536 that is 4.2 M
// pairs, 40 flops and one MUFU.RSQ each: a 0.0025 ms bound, well under the
// cost of a launch, so the design is about the work around the sweep:
// - It reads pos [N, 3], vel [N, 3], mass [N] and alive [N] in place through
//   their pointers and element strides: no packed copy of the N sources for
//   F rows. A dead source drops out by a select on alive (its mass read as
//   0), never by a 0/1 product.
// - A block holds kSubRows = 32 target rows and kSubGroups = 16 groups of
//   them over j (512 threads; lane = row, warp = group, so the lanes of a
//   warp read one staged source at a time); the j range is split across
//   the grid's y dimension so that the grid covers the 132 SMs (the host
//   works the split out from N and F: 64 splits of 1,024 sources at
//   F = 64, N = 65,536). Each block stages kSubTile sources a round in
//   shared memory, each group sweeps its 16 of them into fresh partials
//   (the two-level sum of sweep_tile), and the 16 groups' sums are added in
//   group order.
// - The reduction over the splits happens on the device in the same launch,
//   in a fixed order and without float atomics: each split writes its raw
//   sums to a scratch buffer, then counts itself done on a per-row-tile
//   counter behind a __threadfence; the last block of a row tile to finish
//   adds the splits' sums in split order (each lane a strided run of
//   splits, then a fixed xor-shuffle tree) and writes G times them to the
//   [F, 6] output, then resets the counter to 0 for the next launch. One
//   split writes the output directly.
// The f64 instance (jerk_subset_kernel<double, ...>, entry
// nbody_jerk_subset_f64) takes the place of the JAX stepper's XLA subset in
// f64 state: the same launch and the same order of sums in double, 1 /
// sqrt for the FTZ rsqrt, G and eps2 in double. Its 4.2 M pairs at F = 64
// and N = 65,536 are ~40 FP64 operations each: a 0.005 ms bound at the
// H100 SXM's 33.5 TFLOP/s, still under a launch.
// A self pair adds exactly zero acc and jerk (r_ij = v_ij = 0; with eps2 = 0
// the r2 > 0 select drops it), so no index mask is needed and the result
// equals the index-masked plain version. Target indices are clamped into
// [0, N) as a JAX gather clamps them.
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
// the row subset: target rows a block, groups of them over j (one warp
// each), sources staged a round
constexpr int kSubRows = 32;
constexpr int kSubGroups = 16;
constexpr int kSubThreads = kSubRows * kSubGroups;
constexpr int kSubTile = 256;
constexpr int kSubPer = kSubTile / kSubGroups;  // sources a group sweeps a round
static_assert(kSubRows == 32 && kSubTile % kSubGroups == 0, "bad subset shape");

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

// The subset's f64 instance: its pair sums in double, each in the f32
// instance's order (the same two-level sum), with 1 / sqrt in place of the
// FTZ rsqrt; no pe and no count.
struct Sums64 {
  double ax, ay, az, jx, jy, jz;
};

struct alignas(32) Vec64 {
  double x, y, z, w;
};

template <int NI, bool kSoft>
__device__ __forceinline__ void sweep_tile64(const Vec64* tp, const Vec64* tv, int count,
                                             const Vec64 (&pi)[NI], const Vec64 (&vi)[NI],
                                             double eps2, Sums64 (&t)[NI]) {
#pragma unroll
  for (int k = 0; k < NI; ++k) t[k] = Sums64{0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
  for (int jj = 0; jj < count; ++jj) {
    const Vec64 pj = tp[jj];
    const Vec64 vj = tv[jj];
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const double dx = pj.x - pi[k].x;
      const double dy = pj.y - pi[k].y;
      const double dz = pj.z - pi[k].z;
      const double dvx = vj.x - vi[k].x;
      const double dvy = vj.y - vi[k].y;
      const double dvz = vj.z - vi[k].z;
      const double r2 = fma(dz, dz, fma(dx, dx, dy * dy));
      double inv;
      if (kSoft) {
        inv = 1.0 / sqrt(r2 + eps2);
      } else {
        inv = r2 > 0.0 ? 1.0 / sqrt(r2) : 0.0;
      }
      const double inv2 = inv * inv;
      const double w = pj.w * (inv2 * inv);
      const double rv = dx * dvx + dy * dvy + dz * dvz;
      const double c = 3.0 * rv * inv2;
      t[k].ax += w * dx;
      t[k].ay += w * dy;
      t[k].az += w * dz;
      t[k].jx += w * (dvx - c * dx);
      t[k].jy += w * (dvy - c * dy);
      t[k].jz += w * (dvz - c * dz);
    }
  }
}

// The row subset's scalar type: its row of four, its sums and its sweep of
// a staged run (f32: the full sweep's sweep_tile, bit for bit as before).
template <typename T>
struct Subset;

template <>
struct Subset<float> {
  using V4 = float4;
  using S = Sums;
  static __device__ __forceinline__ float4 vec(float x, float y, float z, float w) {
    return make_float4(x, y, z, w);
  }
  static __device__ __forceinline__ Sums zero() { return zero_sums(); }
  static __device__ __forceinline__ void add(Sums& s, const Sums& t) { add_sums(s, t); }
  template <bool kSoft>
  static __device__ __forceinline__ void sweep(const float4* tp, const float4* tv, int count,
                                               const float4 (&pi)[1], const float4 (&vi)[1],
                                               float eps2, Sums (&t)[1]) {
    float unused[1];
    sweep_tile<1, kSoft, false, false>(tp, tv, count, pi, vi, eps2, t, unused);
  }
};

template <>
struct Subset<double> {
  using V4 = Vec64;
  using S = Sums64;
  static __device__ __forceinline__ Vec64 vec(double x, double y, double z, double w) {
    return Vec64{x, y, z, w};
  }
  static __device__ __forceinline__ Sums64 zero() {
    return Sums64{0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  }
  static __device__ __forceinline__ void add(Sums64& s, const Sums64& t) {
    s.ax += t.ax;
    s.ay += t.ay;
    s.az += t.az;
    s.jx += t.jx;
    s.jy += t.jy;
    s.jz += t.jz;
  }
  template <bool kSoft>
  static __device__ __forceinline__ void sweep(const Vec64* tp, const Vec64* tv, int count,
                                               const Vec64 (&pi)[1], const Vec64 (&vi)[1],
                                               double eps2, Sums64 (&t)[1]) {
    sweep_tile64<1, kSoft>(tp, tv, count, pi, vi, eps2, t);
  }
};

// Reads row j of a strided [N, 3] array.
template <typename T>
__device__ __forceinline__ void row3(const T* __restrict__ a, long long s0, long long s1,
                                     long long j, T& x, T& y, T& z) {
  const T* p = a + j * s0;
  x = p[0];
  y = p[s1];
  z = p[2 * s1];
}

template <typename T, bool kSoft, bool kIdx64>
__global__ void __launch_bounds__(kSubThreads)
jerk_subset_kernel(const T* __restrict__ pos, long long ps0, long long ps1,
                   const T* __restrict__ vel, long long vs0, long long vs1,
                   const T* __restrict__ mass, long long ms,
                   const unsigned char* __restrict__ alive, long long as,
                   const void* __restrict__ idx, int f, int n, int split, T G, T eps2,
                   T* __restrict__ part, unsigned int* __restrict__ done,
                   T* __restrict__ out) {
  using U = Subset<T>;
  using V4 = typename U::V4;
  __shared__ V4 tp[kSubTile];
  __shared__ V4 tv[kSubTile];
  __shared__ T red[kSubGroups][kSubRows][6];
  __shared__ bool last;
  const int r = threadIdx.x & 31;  // the lane: a target row of the tile
  const int g = threadIdx.x >> 5;  // the warp: a group over j
  const int row = blockIdx.x * kSubRows + r;
  V4 pi[1] = {U::vec(T(0), T(0), T(0), T(0))};
  V4 vi[1] = {pi[0]};
  if (row < f) {
    // clamp as a JAX gather does; the steppers pass argsort indices
    long long i = kIdx64 ? static_cast<const long long*>(idx)[row]
                         : static_cast<long long>(static_cast<const int*>(idx)[row]);
    i = min(max(i, 0LL), static_cast<long long>(n - 1));
    T x, y, z, vx, vy, vz;
    row3(pos, ps0, ps1, i, x, y, z);
    row3(vel, vs0, vs1, i, vx, vy, vz);
    pi[0] = U::vec(x, y, z, T(0));
    vi[0] = U::vec(vx, vy, vz, T(0));
  }
  const int j_begin = blockIdx.y * split;
  const int j_end = min(j_begin + split, n);
  typename U::S s = U::zero();
  for (int j0 = j_begin; j0 < j_end; j0 += kSubTile) {
    const int j = j0 + static_cast<int>(threadIdx.x);
    if (threadIdx.x < kSubTile && j < j_end) {
      T x, y, z, vx, vy, vz;
      row3(pos, ps0, ps1, j, x, y, z);
      row3(vel, vs0, vs1, j, vx, vy, vz);
      const bool live = alive == nullptr || alive[j * as] != 0;
      tp[threadIdx.x] = U::vec(x, y, z, live ? mass[j * ms] : T(0));
      tv[threadIdx.x] = U::vec(vx, vy, vz, T(0));
    }
    __syncthreads();
    const int lo = g * kSubPer;
    const int count = min(kSubPer, j_end - j0 - lo);
    typename U::S t[1];
    if (count == kSubPer) {
      U::template sweep<kSoft>(tp + lo, tv + lo, kSubPer, pi, vi, eps2, t);
      U::add(s, t[0]);
    } else if (count > 0) {
      U::template sweep<kSoft>(tp + lo, tv + lo, count, pi, vi, eps2, t);
      U::add(s, t[0]);
    }
    __syncthreads();
  }
  // the groups' sums of each row, added in group order
  const T mine[6] = {s.ax, s.ay, s.az, s.jx, s.jy, s.jz};
#pragma unroll
  for (int c = 0; c < 6; ++c) red[g][r][c] = mine[c];
  __syncthreads();
  const int splits = gridDim.y;
  if (g == 0 && row < f) {
    T sum[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) sum[c] = red[0][r][c];
    for (int q = 1; q < kSubGroups; ++q) {
#pragma unroll
      for (int c = 0; c < 6; ++c) sum[c] += red[q][r][c];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      if (splits == 1) {
        out[row * 6 + c] = G * sum[c];
      } else {
        // [F * 6, splits]: a row tile's splits of one output lie together
        part[static_cast<size_t>(row * 6 + c) * splits + blockIdx.y] = sum[c];
      }
    }
  }
  if (splits == 1) return;
  // the last split of this row tile to finish adds the splits in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&done[blockIdx.x], 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int rows = min(kSubRows, f - static_cast<int>(blockIdx.x) * kSubRows);
  for (int o = g; o < rows * 6; o += kSubGroups) {
    const size_t at = static_cast<size_t>(blockIdx.x * kSubRows * 6 + o) * splits;
    T sum = T(0);
    for (int q = r; q < splits; q += 32) sum += __ldcg(part + at + q);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (r == 0) out[blockIdx.x * kSubRows * 6 + o] = G * sum;
  }
  if (threadIdx.x == 0) done[blockIdx.x] = 0u;
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

template <typename T>
int launch_subset(const void* pos, int ps0, int ps1, const void* vel, int vs0, int vs1,
                  const void* mass, int ms, const void* alive, int as, const void* idx,
                  int idx64, int f, int n, int split, T G, T eps2, void* part, void* done,
                  void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (f <= 0 || n <= 0) return cudaSuccess;
  if (split <= 0 || split % kSubTile != 0) return cudaErrorInvalidValue;
  const dim3 grid((f + kSubRows - 1) / kSubRows, (n + split - 1) / split);
  const auto* p = static_cast<const T*>(pos);
  const auto* v = static_cast<const T*>(vel);
  const auto* m = static_cast<const T*>(mass);
  const auto* a = static_cast<const unsigned char*>(alive);
  auto* pt = static_cast<T*>(part);
  auto* d = static_cast<unsigned int*>(done);
  auto* o = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define OT_SUBSET(kSoft, kIdx64)                                                      \
  jerk_subset_kernel<T, kSoft, kIdx64><<<grid, kSubThreads, 0, s>>>(                  \
      p, ps0, ps1, v, vs0, vs1, m, ms, a, as, idx, f, n, split, G, eps2, pt, d, o)
  if (eps2 > T(0)) {
    if (idx64) OT_SUBSET(true, true); else OT_SUBSET(true, false);
  } else {
    if (idx64) OT_SUBSET(false, true); else OT_SUBSET(false, false);
  }
#undef OT_SUBSET
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

// pos, vel: [n, 3] float with element strides (ps0, ps1), (vs0, vs1); mass:
// [n] float, stride ms; alive: [n] bool (one byte), stride as, or null; idx:
// [f] int64 (idx64 != 0) or int32 target rows; the j range cut into
// ceil(n / split) splits of `split` sources (a multiple of kSubTile).
// part: [f * 6, splits] float scratch (unused at one split); done:
// [ceil(f / kSubRows)] unsigned int counters, 0 on entry and left 0; out:
// [f, 6] float (G*acc, G*jerk).
int nbody_jerk_subset(const void* pos, int ps0, int ps1, const void* vel, int vs0, int vs1,
                      const void* mass, int ms, const void* alive, int as, const void* idx,
                      int idx64, int f, int n, int split, float G, float eps2, void* part,
                      void* done, void* out, void* stream, int device) {
  return launch_subset<float>(pos, ps0, ps1, vel, vs0, vs1, mass, ms, alive, as, idx, idx64, f,
                              n, split, G, eps2, part, done, out, stream, device);
}

// The f64 instance: pos, vel, mass, part and out double, G and eps2 double,
// the rest as nbody_jerk_subset.
int nbody_jerk_subset_f64(const void* pos, int ps0, int ps1, const void* vel, int vs0,
                          int vs1, const void* mass, int ms, const void* alive, int as,
                          const void* idx, int idx64, int f, int n, int split, double G,
                          double eps2, void* part, void* done, void* out, void* stream,
                          int device) {
  return launch_subset<double>(pos, ps0, ps1, vel, vs0, vs1, mass, ms, alive, as, idx, idx64,
                               f, n, split, G, eps2, part, done, out, stream, device);
}

// The row subset's block shape: shape[0..3] = target rows a block, groups
// over j (warps), sources staged a round, threads a block.
void nbody_jerk_subset_shape(int* shape) {
  shape[0] = kSubRows;
  shape[1] = kSubGroups;
  shape[2] = kSubTile;
  shape[3] = kSubThreads;
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
