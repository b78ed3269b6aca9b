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
// What bounds it on this card: instruction issue, as for B1 (nbody_forces.cu).
// An unordered pair costs 17 warp instructions: 3 differences, r2 with eps2
// folded into its multiply-add chain (3), one MUFU.RSQ, u^3 (2), the two
// weights (2) and three i-side and three j-side multiply-adds (6), the
// work of two ordered pairs in B1's 14.6 each. The j-side sums add, for each
// j and thread, a shared-memory read-modify-write (a load, 3 adds, a store),
// the j row's load and the lane schedule's index, spread over kK pairs.
// The first version spread them over 4 pairs, took rsqrtf with its
// denormal fix-up around the MUFU and a separate + eps2, and ended each of
// 16 stages of a tile pair with a block barrier: 25.25 SASS instructions an
// unordered pair in its inner loop, against 17.92 in this build (18.84 at
// kK = 8), which puts the issue floor at 65,536 bodies at 1.16 ms (528
// schedulers at 1.98 GHz); it runs at ~72-74% of that on an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py phases 2 and 29, --sweep; PERF.md).
//
// Design (no float atomics; every sum in a fixed order):
//  * sym_tile_kernel: one block of kQ warps per tile pair (I, J), I <= J,
//    numbered along the upper triangle. Tile J's (x, y, z, m) is staged in
//    shared memory. Warp w owns the j rows w * slice .. (w + 1) * slice - 1
//    of tile J (slice = tile / kQ) and their j-side sums, so no other warp
//    touches them: the j loop has no block barrier. Within the warp a
//    lane schedule keeps each j with one lane at a time: at step s lane l
//    takes row l xor s of the warp's current 32-row chunk (a permutation of
//    the chunk at every step, and every row once over the 32 steps) and
//    updates its j-side sum under a warp barrier. Every thread holds kK i
//    rows of tile I in registers (rows p * 32 kK + lane + 32 k of pass p),
//    so each j row's load and j-side update serve kK pairs; the block's
//    warps hold the same i rows and the tile takes tile / (32 kK) passes.
//    After each pass the kQ warps' i-side sums of each row are added in
//    warp order in shared memory (two block barriers a pass).
//  * The block writes its i-side sums to the partial slot P[I][J] and its
//    j-side sums to P[J][I]; a diagonal tile adds its j-side sums to its
//    i-side sums (in that order) into P[I][I]. Every slot is written once.
//  * sym_reduce_kernel: one thread per body sums P[t][p] over the partner
//    tiles p = 0 .. T-1 in order and writes G * acc.
//  * One MUFU.RSQ a pair (rsqrt.approx.ftz): r2 + eps2 >= eps2 > 0 is never
//    denormal, so flushing denormals gives rsqrtf's bits without its fix-up.
// P is [T][T][3][tile] f32, 12 N^2 / tile bytes: 100.7 MB at N = 65,536 and
// 1.61 GB at 262,144 with 512-body tiles.
//
// kK = 16 and kQ = 2 (167 registers, no spills, 12 warps an SM) are the
// OT_SYM_K and OT_SYM_Q macros below, the fastest shape of chip_smoke.py
// --sweep, which sets them with -D (k = 8 ran 2% slower with 96 registers);
// a tile narrower than 32 kK i rows or kQ slices of 32 j rows (256 and 128)
// takes fewer of each.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launches.
#include <cuda_runtime.h>

#ifndef OT_SYM_K
#define OT_SYM_K 16
#endif
#ifndef OT_SYM_Q
#define OT_SYM_Q 2
#endif

namespace {

constexpr int kK = OT_SYM_K;  // i rows a thread
constexpr int kQ = OT_SYM_Q;  // warps a block, one j slice each
static_assert(kK >= 1 && kQ >= 1 && (kK & (kK - 1)) == 0 && (kQ & (kQ - 1)) == 0,
              "kK and kQ are powers of two");

// the launch shape at one tile: i rows a thread, warps, i rows a pass, j rows
// a warp
template <int kTile>
struct Shape {
  static constexpr int k = kK < kTile / 32 ? kK : kTile / 32;
  static constexpr int q = kQ < kTile / 32 ? kQ : kTile / 32;
  static constexpr int threads = 32 * q;
  static constexpr int rows = 32 * k;
  static constexpr int slice = kTile / q;
  static_assert(kTile % rows == 0 && slice % 32 == 0, "tile shape");
};

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
__global__ void __launch_bounds__(Shape<kTile>::threads)
sym_tile_kernel(const float4* __restrict__ pts, int n_tiles, float eps2,
                float* __restrict__ part) {
  using S = Shape<kTile>;
  __shared__ float4 tj[kTile];                  // tile J: x, y, z, half * m
  __shared__ float4 sj[kTile];                  // j-side sums (x, y, z)
  __shared__ float red[3][S::q][S::rows];       // each warp's i-side sums of a pass

  int I, J;
  tile_pair(blockIdx.x, I, J);
  const float half = I == J ? 0.5f : 1.0f;
  for (int k = threadIdx.x; k < kTile; k += S::threads) {
    const float4 v = pts[static_cast<size_t>(J) * kTile + k];
    tj[k] = make_float4(v.x, v.y, v.z, half * v.w);
    sj[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* ti = pts + static_cast<size_t>(I) * kTile;
  float* out_i = part + (static_cast<size_t>(I) * n_tiles + J) * 3 * kTile;
  for (int p0 = 0; p0 < kTile; p0 += S::rows) {
    float4 pi[S::k];
    float ax[S::k], ay[S::k], az[S::k];
#pragma unroll
    for (int r = 0; r < S::k; ++r) {
      pi[r] = ti[p0 + lane + 32 * r];
      pi[r].w *= half;
      ax[r] = ay[r] = az[r] = 0.0f;
    }
    for (int base = warp * S::slice; base < (warp + 1) * S::slice; base += 32) {
#pragma unroll 4
      for (int s = 0; s < 32; ++s) {
        const int j = base + (lane ^ s);
        const float4 q = tj[j];
        float bx = 0.0f, by = 0.0f, bz = 0.0f;
#pragma unroll
        for (int r = 0; r < S::k; ++r) {
          const float dx = q.x - pi[r].x;
          const float dy = q.y - pi[r].y;
          const float dz = q.z - pi[r].z;
          const float inv = rsqrt_ftz(fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2))));
          const float u3 = inv * inv * inv;
          const float wi = q.w * u3;
          const float wj = pi[r].w * u3;
          ax[r] = fmaf(wi, dx, ax[r]);
          ay[r] = fmaf(wi, dy, ay[r]);
          az[r] = fmaf(wi, dz, az[r]);
          bx = fmaf(wj, dx, bx);
          by = fmaf(wj, dy, by);
          bz = fmaf(wj, dz, bz);
        }
        float4 b = sj[j];
        b.x -= bx;
        b.y -= by;
        b.z -= bz;
        sj[j] = b;
        __syncwarp();
      }
    }
    // the kQ slices' sums of each i row of the pass, added in warp order
#pragma unroll
    for (int r = 0; r < S::k; ++r) {
      red[0][warp][lane + 32 * r] = ax[r];
      red[1][warp][lane + 32 * r] = ay[r];
      red[2][warp][lane + 32 * r] = az[r];
    }
    __syncthreads();
    for (int row = threadIdx.x; row < S::rows; row += S::threads) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float a = red[d][0][row];
        for (int w = 1; w < S::q; ++w) a += red[d][w][row];
        out_i[d * kTile + p0 + row] = a;
      }
    }
    __syncthreads();
  }

  if (I == J) {
    // rows this thread wrote above (the same thread, the same order of rows)
    for (int p0 = 0; p0 < kTile; p0 += S::rows) {
      for (int row = p0 + threadIdx.x; row < p0 + S::rows; row += S::threads) {
        out_i[row] += sj[row].x;
        out_i[kTile + row] += sj[row].y;
        out_i[2 * kTile + row] += sj[row].z;
      }
    }
  } else {
    float* out_j = part + (static_cast<size_t>(J) * n_tiles + I) * 3 * kTile;
    for (int k = threadIdx.x; k < kTile; k += S::threads) {
      const float4 b = sj[k];
      out_j[k] = b.x;
      out_j[kTile + k] = b.y;
      out_j[2 * kTile + k] = b.z;
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
  sym_tile_kernel<kTile><<<pairs, Shape<kTile>::threads, 0, s>>>(pts, n_tiles, eps2, part);
  sym_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, n_tiles, kTile, G, acc);
}

template <int kTile>
void shape_of(int n, int* shape) {
  const int n_tiles = n / kTile;
  shape[0] = Shape<kTile>::k;
  shape[1] = Shape<kTile>::q;
  shape[2] = kTile;
  shape[3] = Shape<kTile>::threads;
  shape[4] = n_tiles * (n_tiles + 1) / 2;
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

// The launch shape at n bodies, with the wrapper's tile (512 halved down to
// 128 until it divides n): shape[0..4] = i rows a thread, warps (j slices) a
// block, tile, threads a block, blocks (tile pairs); all 0 if no tile divides n.
void nbody_forces_sym_shape(int n, int* shape) {
  int tile = 512;
  while (tile > 128 && n % tile != 0) tile /= 2;
  for (int i = 0; i < 5; ++i) shape[i] = 0;
  if (n <= 0 || n % tile != 0) return;
  switch (tile) {
    case 512: shape_of<512>(n, shape); break;
    case 256: shape_of<256>(n, shape); break;
    default: shape_of<128>(n, shape); break;
  }
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
