// Gram-identity softened O(N^2) gravity for Hopper (sm_90a), on the CUDA
// cores.
//
// Replaces: orbital_tpu/ops/pallas_forces_mxu.py::_mxu_kernel (B13, the TPU
// sweep behind pairwise_acc_pallas_mxu), which puts the pair distances and
// the accumulation on the TPU's matrix unit. The function is kept, Gram
// identity and its cancellation included:
//
//   r2_ij = A_i . B_j (8 deep),  A_i = (-2x, -2y, -2z, |r_i|^2, 1, 0, 0, 0),
//                                B_j = (x, y, z, 1, |r_j|^2, m, 0, 0)
//   w_ij  = m_j rsqrt(max(r2_ij, 0) + eps2)^3,   w_ii = 0 (masked)
//   S_i  += sum_j w_ij (x_j, y_j, z_j, 1)
//   pe_i += sum_j m_j rsqrt(max(r2_ij, 0) + eps2)      (kPE, i == j masked)
//
// and the wrapper forms acc = G (S[:, 0:3] - pos * S[:, 3]). The products
// with the 1 and 0 entries of A and B are exact, so the dot is summed from
// its five nonzero terms, in the 8-term dot's order, each product and sum
// rounded on its own (no fused multiply-add): the plain version forms r2 in
// the same order, so the two agree on r2 bit for bit. That matters: the
// identity is ill-conditioned on close pairs, where one ulp of r2 moves a
// weight by ~|r|^2 2^-24 / eps2, and two orders of the dot part by ~2e-3 of
// max |acc| at N = 65,536; with one order the kernel and its plain version
// differ only in the order of the S sums. The self diagonal
// is masked by global index and nothing is subtracted (its weight m_i eps^-3
// would swamp the f32 sums). f32 throughout, no tensor cores: TF32 would
// lose the bits the identity cancels (a 3xTF32 or FP64 tensor-core form is
// a later redesign).
//
// What bounds it on this card: arithmetic, as B1: ~16 f32 instructions and
// one rsqrtf per ordered pair, 32 bytes per j body read once per block from
// shared memory (a broadcast).
//
// Design: B1's. The wrapper packs A and B as JAX does ([N, 8] rows each).
// One thread per i row holds A_i's first four entries (the fifth, 1, only
// multiplies |r_j|^2) and its running (S, pe) in registers; each block
// stages 128 j bodies as (x, y, z, |r|^2) and m in shared memory, sums each
// tile into fresh partials and adds them to the running sums. Only the one
// tile whose j range is the block's own i range runs the masked loop. N is
// a multiple of 128 (the wrapper's tile rule guarantees it).
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

template <bool kPE, bool kMask>
__device__ __forceinline__ void gram_tile(const float4* bj, const float* mj, float4 a, int self,
                                          float eps2, float& sx, float& sy, float& sz,
                                          float& sw, float& pe) {
  sx = sy = sz = sw = pe = 0.0f;
#pragma unroll 8
  for (int k = 0; k < kBlock; ++k) {
    const float4 b = bj[k];
    const float r2 = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x),
                                                            __fmul_rn(a.y, b.y)),
                                                   __fmul_rn(a.z, b.z)),
                                          a.w),
                               b.w);
    const float inv = rsqrtf(fmaxf(r2, 0.0f) + eps2);
    float w = mj[k] * (inv * inv * inv);
    if (kMask && k == self) w = 0.0f;
    sx += w * b.x;
    sy += w * b.y;
    sz += w * b.z;
    sw += w;
    if (kPE) pe += (kMask && k == self) ? 0.0f : mj[k] * inv;
  }
}

template <bool kPE>
__global__ void __launch_bounds__(kBlock)
gram_kernel(const float4* __restrict__ iA, const float4* __restrict__ jB, int n, float eps2,
            float4* __restrict__ sums, float* __restrict__ pe_row) {
  __shared__ float4 bj[kBlock];
  __shared__ float mj[kBlock];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const float4 a = iA[2 * i];  // (-2x, -2y, -2z, |r_i|^2)
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, sw = 0.0f, pe = 0.0f;
  for (int j0 = 0; j0 < n; j0 += kBlock) {
    const float4 lo = jB[2 * (j0 + threadIdx.x)];      // (x, y, z, 1)
    const float4 hi = jB[2 * (j0 + threadIdx.x) + 1];  // (|r_j|^2, m, 0, 0)
    bj[threadIdx.x] = make_float4(lo.x, lo.y, lo.z, hi.x);
    mj[threadIdx.x] = hi.y;
    __syncthreads();
    float tx, ty, tz, tw, tp;
    if (j0 == blockIdx.x * kBlock) {
      gram_tile<kPE, true>(bj, mj, a, threadIdx.x, eps2, tx, ty, tz, tw, tp);
    } else {
      gram_tile<kPE, false>(bj, mj, a, -1, eps2, tx, ty, tz, tw, tp);
    }
    sx += tx;
    sy += ty;
    sz += tz;
    sw += tw;
    if (kPE) pe += tp;
    __syncthreads();
  }
  sums[i] = make_float4(sx, sy, sz, sw);
  if (kPE) pe_row[i] = pe;
}

}  // namespace

extern "C" {

// iA: [n, 8] f32 rows (-2x, -2y, -2z, |r|^2, 1, 0, 0, 0); jB: [n, 8] f32
// rows (x, y, z, 1, |r|^2, m, 0, 0); n a multiple of 128; sums: [n] float4
// (S_x, S_y, S_z, S_1); pe_row: [n] float (written when with_pe); eps2 > 0.
int nbody_forces_mxu(const void* iA, const void* jB, int n, float eps2, int with_pe,
                     void* sums, void* pe_row, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!(eps2 > 0.0f) || n <= 0 || n % kBlock != 0) return cudaErrorInvalidValue;
  const auto* a = static_cast<const float4*>(iA);
  const auto* b = static_cast<const float4*>(jB);
  auto* s = static_cast<float4*>(sums);
  auto* pe = static_cast<float*>(pe_row);
  auto st = static_cast<cudaStream_t>(stream);
  if (with_pe) gram_kernel<true><<<n / kBlock, kBlock, 0, st>>>(a, b, n, eps2, s, pe);
  else gram_kernel<false><<<n / kBlock, kBlock, 0, st>>>(a, b, n, eps2, s, pe);
  return cudaGetLastError();
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
