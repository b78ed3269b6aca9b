// P3M's short-range pair sum over a cell table, for Hopper (sm_90a).
//
// Replaces: no TPU kernel. It stands in for the plain XLA lax.map over cell
// blocks in orbital_tpu/ops/p3m.py:181-231 (p3m_acc_potential), which builds
// [cell_block, M, 27 M] masked pair tiles and segment-sums them back to the
// bodies. It computes what that block computes, over the table that
// ops/p3m.py::p3m_cell_table builds (each cell's kept bodies are a prefix of
// its row, count[c] of them):
//
//   for each kept body i of cell c and each kept body j of the 27 cells
//   around c with idx_i != idx_j and r^2 = |r_j - r_i|^2 < rcut^2:
//     acc_i += G m_j g(r^2) (r_j - r_i),   pe_i += m_j K_short(r^2)
//   g = 1/s^3 - (erf(a r) - (2a/sqrt(pi)) exp(-(a r)^2) r) / r^3,
//   K_short = 1/s - erf(a r)/r,  s^2 = r^2 + eps^2,  a = 1 / (2 sigma),
//   with _short_factors' branches at r^2 = 0: g = 0, K_short = 1/eps - 2a/sqrt(pi).
//
// Each kept body sits in exactly one table slot, so the kernel writes its
// body's row directly: no segment sum. Overflowed and dead bodies have no
// slot; the wrapper zeroes the outputs, so their rows read 0.
//
// What bounds it on this card: the needed pairs' operations. At the P3M bench
// row (65,536 uniform bodies, grid 64, 9^3 cells) the function needs the
// 59.4 M ordered pairs inside rcut, about 50 f32 operations and 3 MUFU
// operations (two rsqrt, one ex2) each: ~0.045 ms, against ~2.6 MB of table
// and output (0.001 ms). This first version walks every live pair of the 27
// cells (344.3 M, 5.8 times the needed ones) with the pair math under a
// branch that a warp almost always takes for some lane, so it costs ~0.1 us
// of issue per 32 walked pairs: it is issue-bound on the walked pairs, as
// the first versions of B7 and the near sweep were. chip_smoke.py phase 33
// prints its time beside the bound; making it fast is later work.
//
// Design, on the template of B7 and the near sweep (tree_near.cu,
// neighbor.cu):
// - One block of kWarps warps per 32-row slice of a cell's live prefix
//   (grid: cells x ceil(capacity / 32); blocks past the prefix exit).
// - Lanes as (row, group over j): a slice of R rows takes S lanes a row (S
//   the power of two >= R) and 32 / S groups a warp, so a cell of one body
//   still fills its warps.
// - The 27 neighbours' live rows are staged kStage at a time into shared
//   memory, as one run through the neighbours' prefix offsets (a binary
//   search a row), with each row's body index for the self-pair test.
// - Each (warp, group) slot sums a fixed stride of the staged rows in
//   order; the groups of a warp are added by a fixed xor-shuffle tree and
//   the warps in warp order in shared memory: no float atomics, the same
//   result from run to run.
// - The card's rsqrtf, erff and expf: their ulps against torch.special.erf
//   in the plain version (ops/p3m.py::p3m_short_plain) are amplified near
//   rcut, where g is the small difference of 1/s^3 and the long-range part
//   (chip_smoke.py states the tolerance that costs).
//
// Plain C interface for ctypes: pointers and the stream are void*, and each
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStage = 512;  // neighbour rows staged a round
constexpr int kNb = 27;
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;

__global__ void __launch_bounds__(kThreads)
p3m_short_kernel(const float* __restrict__ cell_pos, const float* __restrict__ cell_m,
                 const long long* __restrict__ table, const int* __restrict__ count, int gc,
                 int cap, const float* __restrict__ params, float G, float eps2,
                 float* __restrict__ acc, float* __restrict__ pe) {
  __shared__ float4 sp[kStage];     // x, y, z, m of the staged rows
  __shared__ long long sid[kStage]; // their body indices
  __shared__ int nb_cell[kNb];
  __shared__ int nb_off[kNb + 1];
  __shared__ float4 red[kWarps][32];
  const int cell = blockIdx.x;
  const int s0 = blockIdx.y * 32;
  const int cnt = count[cell];
  if (s0 >= cnt) return;
  const int rows = min(32, cnt - s0);
  int width = 1;
  while (width < rows) width <<= 1;
  const int groups = 32 / width;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = lane & (width - 1);
  const int grp = lane / width;
  const bool own = r < rows;

  float xi = 0.0f, yi = 0.0f, zi = 0.0f;
  long long ii = -1;
  if (own) {
    const size_t slot = static_cast<size_t>(cell) * cap + s0 + r;
    xi = cell_pos[3 * slot];
    yi = cell_pos[3 * slot + 1];
    zi = cell_pos[3 * slot + 2];
    ii = table[slot];
  }
  if (threadIdx.x < kNb) {
    // _OFFSETS order: (a, b, c) over x, y, z, each -1, 0, 1, z fastest
    const int t = threadIdx.x;
    const int cz = cell % gc, cy = (cell / gc) % gc, cx = cell / (gc * gc);
    const int nx = cx + t / 9 - 1, ny = cy + (t / 3) % 3 - 1, nz = cz + t % 3 - 1;
    const bool in = 0 <= nx && nx < gc && 0 <= ny && ny < gc && 0 <= nz && nz < gc;
    const int id = (nx * gc + ny) * gc + nz;
    nb_cell[t] = in ? id : 0;
    nb_off[t + 1] = in ? count[id] : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    nb_off[0] = 0;
    for (int t = 0; t < kNb; ++t) nb_off[t + 1] += nb_off[t];
  }
  __syncthreads();

  const int total = nb_off[kNb];
  const float rcut2 = params[0];
  const float alpha = params[1];
  const float cg = kTwoOverSqrtPi * alpha;
  const float k0 = 1.0f / sqrtf(eps2) - cg;
  const int slots = kWarps * groups;
  const int mine = warp * groups + grp;
  float ax = 0.0f, ay = 0.0f, az = 0.0f, p = 0.0f;
  for (int f0 = 0; f0 < total; f0 += kStage) {
    const int m = min(kStage, total - f0);
    for (int t = threadIdx.x; t < m; t += kThreads) {
      const int f = f0 + t;
      int lo = 0, hi = kNb - 1;  // the last neighbour whose run starts at or before f
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (nb_off[mid] <= f) lo = mid; else hi = mid - 1;
      }
      const size_t js = static_cast<size_t>(nb_cell[lo]) * cap + (f - nb_off[lo]);
      sp[t] = make_float4(cell_pos[3 * js], cell_pos[3 * js + 1], cell_pos[3 * js + 2],
                          cell_m[js]);
      sid[t] = table[js];
    }
    __syncthreads();
    if (own) {
      for (int t = mine; t < m; t += slots) {
        const float4 q = sp[t];
        const float dx = q.x - xi;
        const float dy = q.y - yi;
        const float dz = q.z - zi;
        const float r2 = dx * dx + dy * dy + dz * dz;
        if (r2 < rcut2 && sid[t] != ii) {
          float gf, kf;
          if (r2 > 0.0f) {
            const float inv_r = rsqrtf(r2);
            const float rr = r2 * inv_r;
            const float ar = alpha * rr;
            const float erf_t = erff(ar);
            const float gauss = cg * expf(-(ar * ar));
            const float inv_s = rsqrtf(r2 + eps2);
            gf = inv_s * inv_s * inv_s - (erf_t - gauss * rr) * (inv_r * inv_r * inv_r);
            kf = inv_s - erf_t * inv_r;
          } else {
            gf = 0.0f;
            kf = k0;
          }
          const float w = q.w * gf;
          ax += w * dx;
          ay += w * dy;
          az += w * dz;
          p += q.w * kf;
        }
      }
    }
    __syncthreads();
  }
  // the groups of a warp, by a fixed xor tree over the group bits
  for (int o = width; o < 32; o <<= 1) {
    ax += __shfl_xor_sync(0xffffffffu, ax, o);
    ay += __shfl_xor_sync(0xffffffffu, ay, o);
    az += __shfl_xor_sync(0xffffffffu, az, o);
    p += __shfl_xor_sync(0xffffffffu, p, o);
  }
  if (grp == 0 && own) red[warp][r] = make_float4(ax, ay, az, p);
  __syncthreads();
  if (warp == 0 && lane < rows) {
    float4 s = red[0][lane];
    for (int w = 1; w < kWarps; ++w) {
      const float4 t = red[w][lane];
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    const long long i = table[static_cast<size_t>(cell) * cap + s0 + lane];
    acc[3 * i] = G * s.x;
    acc[3 * i + 1] = G * s.y;
    acc[3 * i + 2] = G * s.z;
    pe[i] = s.w;
  }
}

}  // namespace

extern "C" {

// cell_pos: [(gc^3 + 1) * cap, 3] float; cell_m: [(gc^3 + 1) * cap] float;
// table: [(gc^3 + 1) * cap] int64 body indices; count: [gc^3] int32 kept
// bodies a cell (a prefix of its row); params: [2] float on the device
// (rcut^2, alpha = 1 / (2 sigma)); acc: [n, 3] and pe: [n] float, zeroed by
// the caller (rows of bodies without a slot stay 0).
int p3m_short(const void* cell_pos, const void* cell_m, const void* table, const void* count,
              int gc, int cap, const void* params, float G, float eps2, void* acc, void* pe,
              void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (gc <= 0 || cap <= 0) return cudaSuccess;
  if (!(eps2 > 0.0f)) return cudaErrorInvalidValue;
  const dim3 grid(gc * gc * gc, (cap + 31) / 32);
  p3m_short_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cell_pos), static_cast<const float*>(cell_m),
      static_cast<const long long*>(table), static_cast<const int*>(count), gc, cap,
      static_cast<const float*>(params), G, eps2, static_cast<float*>(acc),
      static_cast<float*>(pe));
  return cudaGetLastError();
}

// The launch shape: shape[0..4] = rows a block slice, warps, rows staged a
// round, threads a block, blocks (cells x slices) at gc cells a side and
// capacity cap.
void p3m_short_shape(int gc, int cap, int* shape) {
  shape[0] = 32;
  shape[1] = kWarps;
  shape[2] = kStage;
  shape[3] = kThreads;
  shape[4] = gc * gc * gc * ((cap + 31) / 32);
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
