// Near field of the tree force solver (near="kernel") for Hopper (sm_90a).
//
// Replaces: orbital_tpu/ops/tree_near_wl.py, _wl_kernel (B7) with its pair
// arithmetic _entry_math. The TPU kernel walks a flat worklist of
// (i-chunk, j-block) entries, GROUP entries a grid step, and leaves one output
// row per (entry, i body) for a segment-sum. Here one block walks one i-chunk's
// whole sweep and writes one row per slot: no per-entry output, no
// segment-sum.
//
// For i-chunk c (rows c*C .. c*C+C-1 of the slot-major table rows), over its
// neighbor runs r < n_nb, over the j-blocks start[c, r] .. start[c, r] +
// count[c, r] - 1 (each block blkw = RJ*C consecutive rows, the blocks of a
// run consecutive too), with the arithmetic of _entry_math
// (tree_near_wl.py:134-168):
//
//   r2 = |x_j - x_i|^2 + eps2,   inv = rsqrt(r2)
//   take = |cx_j - cx_i| <= ws && |cy_j - cy_i| <= ws && |cz_j - cz_i| <= ws
//          && idx_j != idx_i
//   out[c*C + i] = (sum take ? m_j inv^3 dx : 0, ... dy, ... dz,
//                   sum take ? m_j inv : 0)
//
// (acc without G; the caller multiplies). A chunk with every count 0 writes
// zeros: the caller zeroes the counts of the chunks the worklist budget
// drops, so this walks exactly the entries of the TPU kernel's worklist.
//
// Rows are 8 floats, two float4: (x, y, z, m) and (idx, cx, cy, cz), idx and
// the cell coordinates exact in f32 below 2^24, as on the TPU. Sentinel rows
// hold position 1e30, mass 0, idx n and cells 1e9: their r2 overflows to
// +inf, rsqrtf(+inf) = +0 (IEEE, no fast-math here), and the band fails, so
// a select (never a 0/1 product, which would turn 0 * inf into NaN) keeps
// them out. The self pair is masked here by idx, and nothing is subtracted
// afterwards: the opposite of the exact sweeps' bookkeeping.
//
// What bounds it on this card: arithmetic, ~26 f32 operations and one rsqrtf
// a pair against 32 bytes a j row that each block reads once into shared
// memory and all its threads reuse. At the 65,536-body Plummer main path,
// ~25k blocks of 32 x 256 pairs, ~207 M pairs a sweep: ~0.08 ms of f32 work.
//
// Design: one block per i-chunk with T = C * groups threads (groups =
// 256 / C): thread (i, g) holds row i and sums the j rows g, g + groups, ...
// of every block. With C = 32 the 32 lanes of a warp read one j row (a
// shared-memory broadcast). A run's blocks are staged in shared memory a few
// at a time; each j-block is summed into fresh partials before the running
// sum, and the groups are reduced in a fixed order at the end: no float
// atomics, the same bits on every run.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // threads of a block: chunk * groups
constexpr int kStageRows = 512;  // j rows staged per pass (16 KB)

__global__ void __launch_bounds__(kThreads)
tree_near_kernel(const float4* __restrict__ rows, const int* __restrict__ start,
                 const int* __restrict__ count, int n_nb, int chunk, int blkw, int groups,
                 int stage_blocks, float wsf, float eps2, float4* __restrict__ out) {
  extern __shared__ float4 smem[];  // [2 * stage_blocks * blkw] j rows, then [T] sums
  float4* red = smem + 2 * stage_blocks * blkw;
  const int T = chunk * groups;
  const int t = threadIdx.x;
  const int i = t % chunk;
  const int g = t / chunk;
  const int c = blockIdx.x;
  const size_t row_i = (size_t)c * chunk + i;
  const float4 pi = rows[2 * row_i];
  const float4 qi = rows[2 * row_i + 1];

  float ax = 0.0f, ay = 0.0f, az = 0.0f, pe = 0.0f;
  for (int r = 0; r < n_nb; ++r) {
    const int n_q = count[c * n_nb + r];
    const int b0 = start[c * n_nb + r];
    for (int q0 = 0; q0 < n_q; q0 += stage_blocks) {
      const int nb = min(stage_blocks, n_q - q0);
      const float4* src = rows + 2 * (size_t)(b0 + q0) * blkw;
      for (int k = t; k < 2 * nb * blkw; k += T) smem[k] = src[k];
      __syncthreads();
      for (int bb = 0; bb < nb; ++bb) {
        const float4* tile = smem + 2 * bb * blkw;
        float tx = 0.0f, ty = 0.0f, tz = 0.0f, tp = 0.0f;
#pragma unroll 4
        for (int j = g; j < blkw; j += groups) {
          const float4 pj = tile[2 * j];
          const float4 qj = tile[2 * j + 1];
          const float dx = pj.x - pi.x;
          const float dy = pj.y - pi.y;
          const float dz = pj.z - pi.z;
          const float r2 = dx * dx + dy * dy + dz * dz + eps2;
          const float inv = rsqrtf(r2);
          const bool take = fabsf(qj.y - qi.y) <= wsf && fabsf(qj.z - qi.z) <= wsf &&
                            fabsf(qj.w - qi.w) <= wsf && qj.x != qi.x;
          const float w = take ? pj.w * (inv * inv * inv) : 0.0f;
          tx += w * dx;
          ty += w * dy;
          tz += w * dz;
          tp += take ? pj.w * inv : 0.0f;
        }
        ax += tx;
        ay += ty;
        az += tz;
        pe += tp;
      }
      __syncthreads();
    }
  }

  red[t] = make_float4(ax, ay, az, pe);
  __syncthreads();
  if (t < chunk) {
    float4 s = red[t];
    for (int k = 1; k < groups; ++k) {
      const float4 v = red[k * chunk + t];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[(size_t)c * chunk + t] = s;
  }
}

}  // namespace

extern "C" {

// rows: [n_rows * 2] float4, the slot-major table (x, y, z, m), (idx, cx, cy,
// cz) per row; start, count: [k_ch * n_nb] int32 block runs of each chunk
// (count 0 for a dropped chunk); out: [k_ch * chunk] float4 (ax, ay, az, pe).
int tree_near(const void* rows, const void* start, const void* count, int k_ch, int n_nb,
              int chunk, int blkw, float ws, float eps2, void* out, void* stream,
              int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k_ch <= 0) return cudaSuccess;
  const int groups = kThreads / chunk > 0 ? kThreads / chunk : 1;
  const int stage_blocks = kStageRows / blkw > 0 ? kStageRows / blkw : 1;
  const size_t smem = sizeof(float4) * (size_t)(2 * stage_blocks * blkw + chunk * groups);
  tree_near_kernel<<<k_ch, chunk * groups, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), static_cast<const int*>(start),
      static_cast<const int*>(count), n_nb, chunk, blkw, groups, stage_blocks, ws, eps2,
      static_cast<float4*>(out));
  return cudaGetLastError();
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
