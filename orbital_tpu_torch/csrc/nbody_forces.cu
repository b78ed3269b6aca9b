// Softened O(N^2) pairwise gravity for Hopper (sm_90a).
//
// Replaces: orbital_tpu/ops/pallas_forces.py::_nbody_kernel (the TPU force
// sweep behind pairwise_acc_pallas), in its PE and no-PE variants.
//
//   acc_i = G sum_j m_j (r_j - r_i) / (|r_j - r_i|^2 + eps^2)^(3/2)
//   pe_i  =   sum_j m_j / sqrt(|r_j - r_i|^2 + eps^2)          (optional)
//
// What bounds it on this card: arithmetic. Each pair costs ~20 flops and one
// rsqrtf (the SFU issues 16 a clock per SM against 128 FMA lanes), for 16
// bytes per j body that are read once per block from shared memory; device
// memory traffic is O(N) per block and stays in L2.
//
// Design: one thread per i body holds its position and the four sums in
// registers. Each block streams the j bodies through shared memory in tiles
// of kBlock float4 (x, y, z, m), every thread reading the same tile entry
// (a broadcast, no bank conflicts). Each tile is summed into fresh partials
// before it joins the running sums, which keeps the f32 rounding of an
// N-term sum near that of the TPU kernel's tile-wise reductions. The ragged
// last tile is cut by its own trip count, so N need not divide by the tile.
// Padded and dead bodies arrive with mass 0 and exert nothing.
//
// Masking, as in the TPU kernel: with eps2 > 0 nothing is masked (a self
// pair has dx = dy = dz = 0 and adds no force; it adds m_i/eps to pe_i, which
// the caller subtracts). With eps2 == 0 an r2 > 0 select drops self pairs
// and coincident bodies. Never mask i == j here as well: the caller's
// self-PE subtraction would then remove the self term twice.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

// Sums one tile into fresh partials, which the caller adds to its running
// totals: a two-level sum whose f32 rounding error grows with the tile and
// tile counts, not with N.
template <bool kPE, bool kSoft>
__device__ __forceinline__ void accumulate_tile(const float4* tile, int count,
                                                float4 pi, float eps2,
                                                float& ax, float& ay, float& az,
                                                float& pe) {
  ax = ay = az = pe = 0.0f;
#pragma unroll 8
  for (int k = 0; k < count; ++k) {
    const float4 pj = tile[k];
    const float dx = pj.x - pi.x;
    const float dy = pj.y - pi.y;
    const float dz = pj.z - pi.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    float inv_r;
    if (kSoft) {
      inv_r = rsqrtf(r2 + eps2);
    } else {
      inv_r = r2 > 0.0f ? rsqrtf(r2) : 0.0f;
    }
    const float w = pj.w * (inv_r * inv_r * inv_r);
    ax += w * dx;
    ay += w * dy;
    az += w * dz;
    if (kPE) pe += pj.w * inv_r;
  }
}

template <bool kPE, bool kSoft>
__global__ void __launch_bounds__(kBlock)
nbody_forces_kernel(const float4* __restrict__ pts, int n, float G, float eps2,
                    float4* __restrict__ out) {
  __shared__ float4 tile[kBlock];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const float4 pi = i < n ? pts[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float ax = 0.0f, ay = 0.0f, az = 0.0f, pe = 0.0f;
  for (int j0 = 0; j0 < n; j0 += kBlock) {
    const int j = j0 + threadIdx.x;
    if (j < n) tile[threadIdx.x] = pts[j];
    __syncthreads();
    float tx, ty, tz, tp;
    if (n - j0 >= kBlock) {
      accumulate_tile<kPE, kSoft>(tile, kBlock, pi, eps2, tx, ty, tz, tp);
    } else {
      accumulate_tile<kPE, kSoft>(tile, n - j0, pi, eps2, tx, ty, tz, tp);
    }
    ax += tx;
    ay += ty;
    az += tz;
    if (kPE) pe += tp;
    __syncthreads();
  }
  if (i < n) out[i] = make_float4(G * ax, G * ay, G * az, pe);
}

template <bool kPE, bool kSoft>
void launch(const float4* pts, int n, float G, float eps2, float4* out,
            cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  nbody_forces_kernel<kPE, kSoft><<<grid, kBlock, 0, stream>>>(pts, n, G, eps2, out);
}

}  // namespace

extern "C" {

// pts: [n] float4 (x, y, z, mass_eff); out: [n] float4 (G*ax, G*ay, G*az, pe).
int nbody_forces(const void* pts, int n, float G, float eps2, int with_pe,
                 void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  const float4* p = static_cast<const float4*>(pts);
  float4* o = static_cast<float4*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eps2 > 0.0f) {
    if (with_pe) launch<true, true>(p, n, G, eps2, o, s);
    else launch<false, true>(p, n, G, eps2, o, s);
  } else {
    if (with_pe) launch<true, false>(p, n, G, eps2, o, s);
    else launch<false, false>(p, n, G, eps2, o, s);
  }
  return cudaGetLastError();
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
