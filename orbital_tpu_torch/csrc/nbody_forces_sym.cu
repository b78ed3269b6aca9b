// Half-pair (symmetric) softened O(N^2) gravity for Hopper (sm_90a).
//
// Replaces: orbital_tpu/ops/pallas_forces_sym.py::_sym_kernel (B12, the TPU
// sweep behind pairwise_acc_pallas_sym). Newton's third law makes the pair
// matrix antisymmetric, so each upper-triangle tile pair (I <= J) is
// evaluated once and gives both halves from one set of differences:
//
//   acc_i += G sum_j m_j u_ij d_ij       acc_j -= G sum_i m_i u_ij d_ij
//   d_ij = r_j - r_i,  u_ij = (|d_ij|^2 + eps^2)^(-3/2)
//
// acc only (the TPU kernel has no PE), eps2 > 0: a self pair has d = 0 and
// adds nothing, so nothing is masked and nothing subtracted. Diagonal tiles
// (I == J) see every unordered pair twice, once from each side, so their
// weights are halved, as in the TPU kernel.
//
// What bounds it on this card: instruction throughput. A pair costs ~17 f32
// instructions and one rsqrtf against B1's ~13 and one, for half the pairs;
// the j-side sums add a shared-memory read-modify-write per j and per
// thread (kRows pairs), which the register tiling below amortises.
//
// Design (no float atomics; every sum in a fixed order):
//  * sym_tile_kernel: one block of 128 threads per tile pair (I, J),
//    I <= J, numbered along the upper triangle. Tile J's (x, y, z, m) is
//    staged in shared memory; each thread holds kRows = kTile / 128 rows of
//    tile I in registers. The j-side sums live in shared memory and are
//    written without a race by a diagonal schedule: warp w takes the
//    32-body chunk (c + w) mod kChunks at stage c (a block barrier between
//    stages), and lane l takes body (l + s) mod 32 of it at step s (a warp
//    barrier between steps), so each j is touched by one thread at a time.
//    The block writes its i-side sums to the partial slot P[I][J] and its
//    j-side sums to P[J][I]; a diagonal tile adds its j-side sums to its
//    i-side sums (in that order) into P[I][I]. Every slot is written once.
//  * sym_reduce_kernel: one thread per body sums P[t][p] over the partner
//    tiles p = 0 .. T-1 in order and writes G * acc.
// P is [T][T][3][kTile] f32: 100.7 MB at N = 65,536 with 512-body tiles.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launches.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// Tile pair of block k along the upper triangle: k = a (a + 1) / 2 + b with
// 0 <= b <= a, (I, J) = (b, a).
__device__ __forceinline__ void tile_pair(int k, int& I, int& J) {
  int a = static_cast<int>((sqrt(8.0 * k + 1.0) - 1.0) * 0.5);
  while (a * (a + 1) / 2 > k) --a;
  while ((a + 1) * (a + 2) / 2 <= k) ++a;
  I = k - a * (a + 1) / 2;
  J = a;
}

template <int kTile>
__global__ void __launch_bounds__(kThreads)
sym_tile_kernel(const float4* __restrict__ pts, int n_tiles, float eps2,
                float* __restrict__ part) {
  constexpr int kRows = kTile / kThreads;
  constexpr int kChunks = kTile / 32;
  static_assert(kRows * kThreads == kTile && kChunks >= kThreads / 32, "tile shape");
  __shared__ float4 tj[kTile];
  __shared__ float sj[3][kTile];

  int I, J;
  tile_pair(blockIdx.x, I, J);
  const float half = I == J ? 0.5f : 1.0f;
  const float4* ti = pts + static_cast<size_t>(I) * kTile;
  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const float4 q = pts[static_cast<size_t>(J) * kTile + k];
    tj[k] = make_float4(q.x, q.y, q.z, half * q.w);
    sj[0][k] = sj[1][k] = sj[2][k] = 0.0f;
  }
  float4 pi[kRows];
  float ax[kRows], ay[kRows], az[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    pi[r] = ti[r * kThreads + threadIdx.x];
    pi[r].w *= half;
    ax[r] = ay[r] = az[r] = 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = 0; c < kChunks; ++c) {
    const int base = ((c + warp) % kChunks) * 32;
#pragma unroll 4
    for (int s = 0; s < 32; ++s) {
      const int j = base + ((lane + s) & 31);
      const float4 q = tj[j];
      float bx = 0.0f, by = 0.0f, bz = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dx = q.x - pi[r].x;
        const float dy = q.y - pi[r].y;
        const float dz = q.z - pi[r].z;
        const float inv = rsqrtf(dx * dx + dy * dy + dz * dz + eps2);
        const float u3 = inv * inv * inv;
        const float wi = q.w * u3;
        const float wj = pi[r].w * u3;
        ax[r] += wi * dx;
        ay[r] += wi * dy;
        az[r] += wi * dz;
        bx += wj * dx;
        by += wj * dy;
        bz += wj * dz;
      }
      sj[0][j] -= bx;
      sj[1][j] -= by;
      sj[2][j] -= bz;
      __syncwarp();
    }
    __syncthreads();
  }

  float* out_i = part + (static_cast<size_t>(I) * n_tiles + J) * 3 * kTile;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r * kThreads + threadIdx.x;
    if (I == J) {
      out_i[row] = ax[r] + sj[0][row];
      out_i[kTile + row] = ay[r] + sj[1][row];
      out_i[2 * kTile + row] = az[r] + sj[2][row];
    } else {
      out_i[row] = ax[r];
      out_i[kTile + row] = ay[r];
      out_i[2 * kTile + row] = az[r];
    }
  }
  if (I != J) {
    float* out_j = part + (static_cast<size_t>(J) * n_tiles + I) * 3 * kTile;
    for (int k = threadIdx.x; k < 3 * kTile; k += kThreads) {
      out_j[k] = sj[k / kTile][k % kTile];
    }
  }
}

__global__ void sym_reduce_kernel(const float* __restrict__ part, int n_tiles, int tile,
                                  float G, float* __restrict__ acc) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_tiles * tile) return;
  const int t = g / tile;
  const int row = g % tile;
  const float* p = part + static_cast<size_t>(t) * n_tiles * 3 * tile + row;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int q = 0; q < n_tiles; ++q, p += 3 * tile) {
    ax += p[0];
    ay += p[tile];
    az += p[2 * tile];
  }
  acc[3 * g] = G * ax;
  acc[3 * g + 1] = G * ay;
  acc[3 * g + 2] = G * az;
}

template <int kTile>
void launch(const float4* pts, int n, float G, float eps2, float* part, float* acc,
            cudaStream_t s) {
  const int n_tiles = n / kTile;
  const int pairs = n_tiles * (n_tiles + 1) / 2;
  sym_tile_kernel<kTile><<<pairs, kThreads, 0, s>>>(pts, n_tiles, eps2, part);
  sym_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, n_tiles, kTile, G, acc);
}

}  // namespace

extern "C" {

// pts: [n] float4 (x, y, z, mass_eff); part: [n / tile]^2 * 3 * tile floats of
// scratch; acc: [n] x 3 floats (G * acc). tile is 512, 256 or 128 and divides
// n; eps2 > 0.
int nbody_forces_sym(const void* pts, int n, int tile, float G, float eps2, void* part,
                     void* acc, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!(eps2 > 0.0f) || n <= 0 || n % tile != 0) return cudaErrorInvalidValue;
  const auto* p = static_cast<const float4*>(pts);
  auto* pt = static_cast<float*>(part);
  auto* a = static_cast<float*>(acc);
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 512: launch<512>(p, n, G, eps2, pt, a, s); break;
    case 256: launch<256>(p, n, G, eps2, pt, a, s); break;
    case 128: launch<128>(p, n, G, eps2, pt, a, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
