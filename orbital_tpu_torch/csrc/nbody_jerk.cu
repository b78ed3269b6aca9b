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
// What bounds it on this card: arithmetic. A pair costs 42 f32 operations
// (a fused multiply-add counted as two) and one rsqrtf, for 32 bytes per j
// body read once per block from shared memory; device memory traffic is
// O(N) per block and stays in L2.
//
// Design, as the force sweep (nbody_forces.cu): one thread per i body keeps
// its position, velocity and radius in registers. Each block streams the j
// bodies through shared memory as two float4 tiles, (x, y, z, m) and
// (vx, vy, vz, R), every thread reading the same entry (a broadcast). Each
// tile is summed into fresh partials before it joins the running sums: a
// two-level sum whose f32 rounding grows with the tile and tile counts, not
// with N. The jerk terms cancel more than the acc terms do, so they need it
// more. The ragged last tile is cut by its own trip count, so N need not
// divide by the tile. Padded and dead bodies arrive with mass 0.
//
// Masking, as in the TPU kernel: with eps2 > 0 nothing is masked (a self
// pair has r_ij = v_ij = 0 and adds no acc and no jerk; it adds m_i/eps to
// pe_i, which the caller subtracts). With eps2 == 0 an r2 > 0 select drops
// self pairs and coincident bodies. Never mask i == j as well: the caller's
// self-PE subtraction would then remove the self term twice.
//
// Contact detection (kDetect): the radii ride in the w of the velocity
// tile; the count reads the same unsoftened r2 and adds integer work only,
// so acc, jerk and pe are bit-equal to those of the non-detecting launch.
// Each thread counts in an int; a warp reduction, one shared slot per warp
// and one atomicAdd per block sum them into one int32. Self pairs (r2 = 0)
// are counted, so the caller starts the counter at -N. Dead bodies carry
// radius 0 and sit at spread-out far positions, adding only their self pair.
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

namespace {

constexpr int kBlock = 128;       // i bodies per block and j bodies per tile, full sweep
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

// Sums `count` tile entries into fresh partials t, which the caller adds to
// its running totals. pi = (x, y, z, m), vi = (vx, vy, vz, R) of the i body.
template <bool kSoft, bool kPE, bool kDetect>
__device__ __forceinline__ Sums sweep_tile(const float4* tp, const float4* tv, int count,
                                           float4 pi, float4 vi, float eps2, int& touch) {
  Sums t = zero_sums();
#pragma unroll 4
  for (int k = 0; k < count; ++k) {
    const float4 pj = tp[k];
    const float4 vj = tv[k];
    const float dx = pj.x - pi.x;
    const float dy = pj.y - pi.y;
    const float dz = pj.z - pi.z;
    const float dvx = vj.x - vi.x;
    const float dvy = vj.y - vi.y;
    const float dvz = vj.z - vi.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (kDetect) {
      const float rsum = (vi.w + vj.w) * 1.00001f;
      touch += r2 <= rsum * rsum;
    }
    float inv;
    if (kSoft) {
      inv = rsqrtf(r2 + eps2);
    } else {
      inv = r2 > 0.0f ? rsqrtf(r2) : 0.0f;
    }
    const float inv2 = inv * inv;
    const float w = pj.w * (inv2 * inv);     // m_j / s^3
    const float rv = dx * dvx + dy * dvy + dz * dvz;
    const float c = 3.0f * rv * inv2;         // 3 (r.v) / s^2
    t.ax += w * dx;
    t.ay += w * dy;
    t.az += w * dz;
    t.jx += w * (dvx - c * dx);
    t.jy += w * (dvy - c * dy);
    t.jz += w * (dvz - c * dz);
    if (kPE) t.pe += pj.w * inv;
  }
  return t;
}

template <bool kSoft, bool kDetect>
__global__ void __launch_bounds__(kBlock)
jerk_kernel(const float4* __restrict__ pm, const float4* __restrict__ vr, int n, float G,
            float eps2, float4* __restrict__ out, int* __restrict__ contacts) {
  __shared__ float4 tp[kBlock];
  __shared__ float4 tv[kBlock];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 pi = i < n ? pm[i] : zero;
  const float4 vi = i < n ? vr[i] : zero;
  Sums s = zero_sums();
  int touch = 0;
  for (int j0 = 0; j0 < n; j0 += kBlock) {
    const int j = j0 + threadIdx.x;
    if (j < n) {
      tp[threadIdx.x] = pm[j];
      tv[threadIdx.x] = vr[j];
    }
    __syncthreads();
    const Sums t = n - j0 >= kBlock
        ? sweep_tile<kSoft, true, kDetect>(tp, tv, kBlock, pi, vi, eps2, touch)
        : sweep_tile<kSoft, true, kDetect>(tp, tv, n - j0, pi, vi, eps2, touch);
    add_sums(s, t);
    __syncthreads();
  }
  if (i < n) {
    // [N, 8] row: acc (3), jerk (3), pe, 0 -- the TPU kernel's output layout
    out[2 * i] = make_float4(G * s.ax, G * s.ay, G * s.az, G * s.jx);
    out[2 * i + 1] = make_float4(G * s.jy, G * s.jz, s.pe, 0.0f);
  }
  if (kDetect) {
    // rows past n counted against the zero-padded pi: drop them
    touch = i < n ? touch : 0;
    touch = __reduce_add_sync(0xffffffffu, touch);
    __shared__ int warp_sums[kBlock / 32];
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = touch;
    __syncthreads();
    if (threadIdx.x == 0) {
      int block_sum = 0;
#pragma unroll
      for (int w = 0; w < kBlock / 32; ++w) block_sum += warp_sums[w];
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
  float4 pi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 vi = pi;
  if (row < f) {
    // clamp as a JAX gather does; the steppers pass argsort indices
    const long long g = min(max(idx[row], 0LL), static_cast<long long>(n - 1));
    pi = pm[g];
    vi = vr[g];
  }
  Sums s = zero_sums();
  int unused = 0;
  for (int j0 = j_begin; j0 < j_end; j0 += kSubsetBlock) {
    const int j = j0 + threadIdx.x;
    if (j < j_end) {
      tp[threadIdx.x] = pm[j];
      tv[threadIdx.x] = vr[j];
    }
    __syncthreads();
    const Sums t = j_end - j0 >= kSubsetBlock
        ? sweep_tile<kSoft, false, false>(tp, tv, kSubsetBlock, pi, vi, eps2, unused)
        : sweep_tile<kSoft, false, false>(tp, tv, j_end - j0, pi, vi, eps2, unused);
    add_sums(s, t);
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
  const int grid = (n + kBlock - 1) / kBlock;
  const auto* p = static_cast<const float4*>(pm);
  const auto* v = static_cast<const float4*>(vr);
  auto* o = static_cast<float4*>(out);
  auto* c = static_cast<int*>(contacts);
  auto s = static_cast<cudaStream_t>(stream);
  if (eps2 > 0.0f) {
    jerk_kernel<true, kDetect><<<grid, kBlock, 0, s>>>(p, v, n, G, eps2, o, c);
  } else {
    jerk_kernel<false, kDetect><<<grid, kBlock, 0, s>>>(p, v, n, G, eps2, o, c);
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

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
