// Softened O(N^2) pairwise gravity for Hopper (sm_90a).
//
// Replaces: orbital_tpu/ops/pallas_forces.py::_nbody_kernel (the TPU force
// sweep behind pairwise_acc_pallas), in its PE and no-PE variants (B1), its
// detect=True variant behind pairwise_acc_detect_pallas (B2), and its
// rectangular [n_i x n_j] form behind _build_block_call / block_acc_pallas
// (B3, the per-round block of the multi-device ring).
//
//   acc_i = G sum_j m_j (r_j - r_i) / (|r_j - r_i|^2 + eps^2)^(3/2)
//   pe_i  =   sum_j m_j / sqrt(|r_j - r_i|^2 + eps^2)          (optional)
//   count += #{(i, j) : |r_j - r_i|^2 <= ((R_i + R_j) * 1.00001)^2}  (B2)
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
// Contact detection (kDetect, B2): the same kernel with the radii (times
// alive) streamed beside the float4 tiles. The force arithmetic is B1's, op
// for op: the count reads the same unsoftened r2 and adds integer work only,
// so a contact-free step on B2 is bit-equal to one on B1. Each thread counts
// in an int, each block reduces its threads' counts and adds them to one
// int32 with one atomicAdd. Self pairs (r2 = 0) are counted, as in the TPU
// kernel: the caller starts the counter at -N instead of 0 (and does not
// subtract N afterwards). Dead bodies carry radius 0 and sit at spread-out
// far positions, so they add only their own self pair. The 1e-5 inflation
// keeps the gate conservative: a grazing pair can cost a redundant bounce
// sweep but never skip one.
//
// Separate i and j tables (B3): the i side reads (x, y, z) of pts_i, the j
// side (x, y, z, m) of pts_j. B1 and B2 pass one table twice, so their
// arithmetic is unchanged op for op; B3 keeps the PE sum on and subtracts
// nothing (its pe row includes the i == j term where the tables coincide;
// the ring strips it once). kDetect reads one radius table for both sides
// and is launched on coinciding tables only.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

// Sums one tile into fresh partials, which the caller adds to its running
// totals: a two-level sum whose f32 rounding error grows with the tile and
// tile counts, not with N.
template <bool kPE, bool kSoft, bool kDetect>
__device__ __forceinline__ void accumulate_tile(const float4* tile, const float* rtile,
                                                int count, float4 pi, float ri,
                                                float eps2, float& ax, float& ay,
                                                float& az, float& pe, int& touch) {
  ax = ay = az = pe = 0.0f;
#pragma unroll 8
  for (int k = 0; k < count; ++k) {
    const float4 pj = tile[k];
    const float dx = pj.x - pi.x;
    const float dy = pj.y - pi.y;
    const float dz = pj.z - pi.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (kDetect) {
      const float rsum = (ri + rtile[k]) * 1.00001f;
      touch += r2 <= rsum * rsum;
    }
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

template <bool kPE, bool kSoft, bool kDetect>
__global__ void __launch_bounds__(kBlock)
nbody_forces_kernel(const float4* __restrict__ pts_i, int n_i,
                    const float4* __restrict__ pts_j, int n_j,
                    const float* __restrict__ radius, float G, float eps2,
                    float4* __restrict__ out, int* __restrict__ contacts) {
  __shared__ float4 tile[kBlock];
  __shared__ float rtile[kDetect ? kBlock : 1];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const float4 pi = i < n_i ? pts_i[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float ri = (kDetect && i < n_i) ? radius[i] : 0.0f;
  float ax = 0.0f, ay = 0.0f, az = 0.0f, pe = 0.0f;
  int touch = 0;
  for (int j0 = 0; j0 < n_j; j0 += kBlock) {
    const int j = j0 + threadIdx.x;
    if (j < n_j) {
      tile[threadIdx.x] = pts_j[j];
      if (kDetect) rtile[threadIdx.x] = radius[j];
    }
    __syncthreads();
    float tx, ty, tz, tp;
    if (n_j - j0 >= kBlock) {
      accumulate_tile<kPE, kSoft, kDetect>(tile, rtile, kBlock, pi, ri, eps2,
                                           tx, ty, tz, tp, touch);
    } else {
      accumulate_tile<kPE, kSoft, kDetect>(tile, rtile, n_j - j0, pi, ri, eps2,
                                           tx, ty, tz, tp, touch);
    }
    ax += tx;
    ay += ty;
    az += tz;
    if (kPE) pe += tp;
    __syncthreads();
  }
  if (i < n_i) out[i] = make_float4(G * ax, G * ay, G * az, pe);
  if (kDetect) {
    // rows past n counted against the zero-padded pi: drop them, then one
    // warp reduction, one shared slot per warp, one atomic per block
    touch = i < n_i ? touch : 0;
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

template <bool kPE, bool kSoft, bool kDetect>
void launch(const float4* pts_i, int n_i, const float4* pts_j, int n_j,
            const float* radius, float G, float eps2, float4* out, int* contacts,
            cudaStream_t stream) {
  const int grid = (n_i + kBlock - 1) / kBlock;
  nbody_forces_kernel<kPE, kSoft, kDetect><<<grid, kBlock, 0, stream>>>(
      pts_i, n_i, pts_j, n_j, radius, G, eps2, out, contacts);
}

template <bool kDetect>
void dispatch(const float4* p, const float* radius, int n, float G, float eps2,
              int with_pe, float4* o, int* contacts, cudaStream_t s) {
  if (eps2 > 0.0f) {
    if (with_pe) launch<true, true, kDetect>(p, n, p, n, radius, G, eps2, o, contacts, s);
    else launch<false, true, kDetect>(p, n, p, n, radius, G, eps2, o, contacts, s);
  } else {
    if (with_pe) launch<true, false, kDetect>(p, n, p, n, radius, G, eps2, o, contacts, s);
    else launch<false, false, kDetect>(p, n, p, n, radius, G, eps2, o, contacts, s);
  }
}

}  // namespace

extern "C" {

// pts: [n] float4 (x, y, z, mass_eff); out: [n] float4 (G*ax, G*ay, G*az, pe).
int nbody_forces(const void* pts, int n, float G, float eps2, int with_pe,
                 void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  dispatch<false>(static_cast<const float4*>(pts), nullptr, n, G, eps2, with_pe,
                  static_cast<float4*>(out), nullptr, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// B2: nbody_forces plus radius: [n] float (R_i * alive_i) and contacts: one
// int32 on the device, which the caller sets to -n; the kernel adds the
// directed touching-pair count including the n self pairs.
int nbody_forces_detect(const void* pts, const void* radius, int n, float G,
                        float eps2, int with_pe, void* out, void* contacts,
                        void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  dispatch<true>(static_cast<const float4*>(pts), static_cast<const float*>(radius),
                 n, G, eps2, with_pe, static_cast<float4*>(out),
                 static_cast<int*>(contacts), static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// B3: pts_i: [n_i] float4 (x, y, z, unused); pts_j: [n_j] float4 (x, y, z,
// m_j); out: [n_i] float4 (G*ax, G*ay, G*az, pe) with the pe row's i == j
// term kept. Needs eps2 > 0 (the mask-free sweep), as the ring does.
int nbody_block_forces(const void* pts_i, int n_i, const void* pts_j, int n_j, float G,
                       float eps2, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!(eps2 > 0.0f)) return cudaErrorInvalidValue;
  if (n_i <= 0 || n_j <= 0) return cudaSuccess;
  launch<true, true, false>(static_cast<const float4*>(pts_i), n_i,
                            static_cast<const float4*>(pts_j), n_j, nullptr, G, eps2,
                            static_cast<float4*>(out), nullptr,
                            static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
