// The contact-chain root search of merge collisions, for Hopper (sm_90a).
//
// Replaces: no TPU kernel. It stands in for the plain XLA column blocks of
// orbital_tpu/ops/collisions.py:165-196 (collision_roots_chunked), which
// build [N, chunk] touching tiles. It computes their parent array, for
// every column j:
//
//   parent[j] = min(j, min{i < j : touching(i, j)})
//   touching(i, j) = alive_i and alive_j and dist > 0 and dist <= R_i + R_j,
//   dist = sqrt((dx dx + dy dy) + dz dz),  d = r_i - r_j
//
// in the JAX module's order of operations, each product and sum rounded
// once (__fmul_rn / __fadd_rn: nvcc would contract them to FMA) and the
// IEEE square root, so that it is integer-equal to its plain version
// (ops/collisions.py::collision_parents_chunked). The wrapper
// (ops/cuda_collisions.py) turns the parents into roots by pointer jumping.
//
// The gate: `contacts` is the int32 contact count that the detecting force
// sweep (B2, or B5's detecting variant) left on the device. When it is <= 0
// every block writes parent[j] = j and returns at entry: no pair work and no
// host read, as the bounce kernel (collisions.cu) skips its sweep. With a
// null pointer the search always runs.
//
// What bounds it on this card: at a count of 0, the bytes (parent written
// once, 8 B a body: 0.5 MB at N = 65,536); above it, the N^2 / 2 pair tests
// (~10 f32 operations each), a few milliseconds at most. This first version
// is simple: one thread a column, the rows below the block's last column
// staged 256 at a time in shared memory in ascending order; a thread stops
// at its first touching row, and the block stops staging once none of its
// threads is searching. A prefilter on r^2 keeps the square root off pairs
// that cannot touch: fl(sqrt(r2)) <= rsum implies sqrt(r2) <= rsum (1 +
// 2^-24), so r2 <= rsum^2 (1 + 2^-24)^2 < rsum^2 (1 + 2^-20) rounded up,
// and every touching pair passes it (a superset; the exact test decides).
// Dead rows are staged with NaN positions, which fail both tests.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // columns a block
constexpr int kTile = 256;     // rows staged a round

__global__ void __launch_bounds__(kThreads)
parents_kernel(const float* __restrict__ pos, const float* __restrict__ radius,
               const unsigned char* __restrict__ alive, const int* __restrict__ contacts,
               int n, long long* __restrict__ parent) {
  __shared__ float4 tile[kTile];  // x, y, z, R of the staged rows (NaN x when dead)
  const int j = static_cast<int>(blockIdx.x * kThreads + threadIdx.x);
  if (contacts != nullptr && *contacts <= 0) {  // uniform: one count for all
    if (j < n) parent[j] = j;
    return;
  }
  float4 pj = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool searching = false;
  if (j < n) {
    pj = make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], radius[j]);
    searching = alive == nullptr || alive[j] != 0;
  }
  long long found = j;
  // rows i < j, up to the block's last column
  const int rows = min(n, static_cast<int>(blockIdx.x + 1) * kThreads) - 1;
  for (int i0 = 0; i0 < rows; i0 += kTile) {
    if (!__syncthreads_or(searching)) break;
    const int i = i0 + threadIdx.x;
    if (threadIdx.x < kTile && i < rows) {
      const bool live = alive == nullptr || alive[i] != 0;
      tile[threadIdx.x] = make_float4(live ? pos[3 * i] : __int_as_float(0x7fc00000),
                                      pos[3 * i + 1], pos[3 * i + 2], radius[i]);
    }
    __syncthreads();
    if (searching) {
      const int end = min(kTile, j - i0);
      for (int t = 0; t < end; ++t) {
        const float4 pi = tile[t];
        const float dx = __fsub_rn(pi.x, pj.x);
        const float dy = __fsub_rn(pi.y, pj.y);
        const float dz = __fsub_rn(pi.z, pj.z);
        const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        const float rsum = __fadd_rn(pi.w, pj.w);
        if (r2 <= __fmul_ru(__fmul_ru(rsum, rsum), 1.0f + 0x1p-20f)) {
          const float dist = __fsqrt_rn(r2);
          if (dist <= rsum && dist > 0.0f) {
            found = i0 + t;
            searching = false;
            break;
          }
        }
      }
    }
    __syncthreads();
  }
  if (j < n) parent[j] = found;
}

}  // namespace

extern "C" {

// pos: [n, 3] float; radius: [n] float; alive: [n] bool or null (all
// alive); contacts: one int32 on the device or null (no gate); parent: [n]
// int64, written for every body.
int collision_parents(const void* pos, const void* radius, const void* alive,
                      const void* contacts, int n, void* parent, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  parents_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(radius),
      static_cast<const unsigned char*>(alive), static_cast<const int*>(contacts), n,
      static_cast<long long*>(parent));
  return cudaGetLastError();
}

// The launch shape: shape[0..2] = columns a block, rows staged a round,
// blocks at n bodies.
void collision_parents_shape(int n, int* shape) {
  shape[0] = kThreads;
  shape[1] = kTile;
  shape[2] = (n + kThreads - 1) / kThreads;
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
