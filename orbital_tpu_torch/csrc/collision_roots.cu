// The contact sweep of merge and resolve collisions, for Hopper (sm_90a):
// merge's root search (mode "parents") and resolve's contact mark (mode
// "mark"), one tiled template.
//
// Replaces: no TPU kernel. It stands in for two plain XLA sweeps of
// orbital_tpu/ops/collisions.py: the column blocks of
// collision_roots_chunked (:165-196), which give each column its parent,
//
//   parent[j] = min(j, min{i < j : touching(i, j)}),
//
// and the row blocks (`i_block`, :452-464) of resolve_outcomes_subset, which
// mark every body in contact,
//
//   mark[i] = any_{j != i} touching(i, j),
//
// with touching(i, j) = alive_i and alive_j and 0 < dist <= R_i + R_j,
// dist = sqrt((dx dx + dy dy) + dz dz), d = r_i - r_j, in the JAX module's
// order of operations: each product and sum rounded once (__fmul_rn /
// __fadd_rn: nvcc would contract them to FMA) and the IEEE square root, so
// that both modes are integer-equal to their plain versions
// (ops/cuda_collisions.py: collision_parents_plain, contact_marks_plain).
// touching is symmetric (the squares and R_i + R_j do not change when i and
// j swap), so both modes sweep the pairs i < j only; the mark marks both
// ends of each touching pair.
//
// What bounds it on this card: at a count of 0, the bytes (the output
// written once: 8 B a body for the parents, 1 B for the mark); above it, the
// N^2 / 2 pair tests (10 f32 operations each, PERF.md), issued at ~7
// instructions a pair. The first version (one thread a column, each column
// scanning every row below it) took 5.6 ms at 65,536 bodies on an H100
// (PERF.md), 5.7% of that bound: block b did (b + 1) 256 rows of work, the
// last columns' threads walked 65,535 rows in one dependent chain, and ~2
// blocks an SM could not hide its latency.
//
// Design:
// - Tiles of kTile rows x kTile columns cover the pairs i < j: tiles
//   (bi, bj) with bi <= bj, (nb + 1) nb / 2 of them for nb = ceil(N / 128)
//   (131,328 at 65,536). Each warp of a cooperative grid of the co-resident
//   blocks takes tiles w, w + W, w + 2W, ... (W warps in all) in row-tile
//   major order, (0, 0), (0, 1), ..., (1, 1), ...: every tile costs the
//   same, so every warp gets the same work to within one tile, and the
//   whole card sweeps the rows upward together. advance() walks that order;
//   ops/cuda_collisions.py::sweep_plan is its host mirror, which a CPU test
//   holds to covering each pair once.
// - A lane holds kK = 4 columns of its tile in registers (j = 128 bj + lane
//   + 32 c), and the warp stages the tile's rows 32 at a time into its own
//   shared slice (x, y, z, T_i) under a warp barrier: one shared load feeds
//   kK pairs, and no block barrier is needed.
// - The prefilter is per row, not per pair: T_i = (R_i + Rmax)^2 (1 +
//   2^-20) rounded up, plus 2^-126, with Rmax the tile's largest column
//   radius, computed once when the row is staged. A pair costs its three
//   differences, r^2 as one product and two FMAs, and one compare that ORs
//   into the column's flag: 7 instructions, 7.25 with the shared load
//   (7.75 in the built loop, with its counter and branch; PERF.md). It
//   is a superset of the exact test: fl(sqrt(s)) <= R_i + R_j gives s <=
//   (R_i + R_j)^2 (1 + 2^-24)^2 for JAX's rounded s; the FMA r^2 and JAX's
//   differ from the exact sum of squares by at most (1 + 2^-24)^3 each way,
//   so the prefilter's r^2 <= (R_i + R_j)^2 (1 + 2^-21 + O(2^-48)) < T_i,
//   since fl(R_i + R_j) <= fl(R_i + Rmax) by monotone rounding; 2^-126 covers
//   the absolute error of subnormal squares. Dead rows and columns, and
//   those past N, hold a NaN x and fail both tests.
// - After each 32-row slice a lane whose column was flagged runs the exact
//   test on the slice's rows i < j, in ascending order. Mode "parents"
//   keeps the lowest touching row and meets the other tiles' in parent[j]
//   by a 64-bit integer atomicMin: an integer minimum does not depend on
//   order, so runs repeat bit for bit. Mode "mark" stores 1 into both
//   ends' bytes (idempotent). Contacts are rare, so the exact pass costs
//   nothing on most slices.
// - Mode "parents" keeps the first version's early exit: each lane reads its
//   columns' parents at the tile's start, and the warp leaves the tile once
//   no column can still find a row below its parent (rows go upward, so the
//   later slices cannot). Mode "mark" has no exit.
// - The outputs are initialised by the same launch (parent[j] = j, mark =
//   0, grid-stride), then a grid barrier, then the sweep: one launch a
//   call, as the first version had, where an init kernel would add one.
//
// The gate: `contacts` is the int32 contact count that the detecting force
// sweep (B2, or B5's detecting variant) left on the device. When it is <= 0
// the launch writes the identity (parents) or zeros (mark) and returns: no
// pair work and no host read, as the bounce kernel (collisions.cu) skips its
// sweep. With a null pointer the sweep always runs.
//
// Plain C interface for ctypes: pointers and the stream are void*, and each
// entry point returns cudaGetLastError() of its launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kK = 4;            // columns a lane holds
constexpr int kTile = 32 * kK;   // rows and columns a tile: 128
constexpr int kSlice = 32;       // rows staged a round, one a lane
constexpr int kWarps = 4;        // warps a block, each on its own tiles
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;

enum Mode { kParents = 0, kMark = 1 };

struct Sweep {
  const float* pos;              // [n, 3]
  const float* radius;           // [n]
  const unsigned char* alive;    // [n] or null (all alive)
  const int* contacts;           // one int32 or null (no gate)
  int n;
  long long* parent;             // [n], mode kParents
  unsigned char* mark;           // [n], mode kMark
};

// The next tile of a warp's walk: `step` tiles on in row-tile-major order
// over (bi, bj), bi <= bj < nb. bi reaches nb past the last tile.
__device__ __forceinline__ void advance(int& bi, int& bj, int step, int nb) {
  bj += step;
  while (bi < nb && bj >= nb) {
    bj -= nb - bi - 1;
    ++bi;
  }
}

__device__ __forceinline__ bool live(const Sweep& s, int i) {
  return i < s.n && (s.alive == nullptr || s.alive[i] != 0);
}

// JAX's touching test of row (x, y, z) radius ri against column c.
__device__ __forceinline__ bool touching(float4 p, float ri, float cx, float cy, float cz,
                                         float cr) {
  const float dx = __fsub_rn(p.x, cx);
  const float dy = __fsub_rn(p.y, cy);
  const float dz = __fsub_rn(p.z, cz);
  const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const float dist = __fsqrt_rn(r2);
  return dist <= __fadd_rn(ri, cr) && dist > 0.0f;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) sweep_kernel(Sweep s) {
  __shared__ float4 rows[kWarps][kSlice];  // x (NaN when dead), y, z, T_i
  __shared__ float rads[kWarps][kSlice];   // R_i
  const float nan = __int_as_float(0x7fffffff);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < s.n; j += gridDim.x * kThreads) {
    if (kMode == kParents)
      s.parent[j] = j;
    else
      s.mark[j] = 0;
  }
  if (s.contacts != nullptr && *s.contacts <= 0) return;  // uniform: one count for all
  cg::this_grid().sync();

  const int nb = (s.n + kTile - 1) / kTile;
  int bi = 0, bj = 0;
  advance(bi, bj, blockIdx.x * kWarps + warp, nb);
  for (; bi < nb; advance(bi, bj, gridDim.x * kWarps, nb)) {
    float cx[kK], cy[kK], cz[kK], cr[kK];
    long long best[kK];  // parents: the lowest touching row known
    float rmax = 0.0f;
#pragma unroll
    for (int c = 0; c < kK; ++c) {
      const int j = bj * kTile + 32 * c + lane;
      const bool on = live(s, j);
      cx[c] = on ? s.pos[3 * j] : nan;
      cy[c] = on ? s.pos[3 * j + 1] : 0.0f;
      cz[c] = on ? s.pos[3 * j + 2] : 0.0f;
      cr[c] = on ? s.radius[j] : 0.0f;
      rmax = fmaxf(rmax, cr[c]);
      // the parent so far, from L2 (other SMs' atomics; a stale value only
      // exits later)
      if (kMode == kParents) best[c] = on ? __ldcg(&s.parent[j]) : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));

    for (int r0 = bi * kTile; r0 < bi * kTile + kTile; r0 += kSlice) {
      if (kMode == kParents) {
        bool want = false;
#pragma unroll
        for (int c = 0; c < kK; ++c) want |= best[c] > r0;
        if (!__any_sync(0xffffffffu, want)) break;
      }
      const int i = r0 + lane;
      const bool on = live(s, i);
      const float ri = on ? s.radius[i] : 0.0f;
      const float a = __fadd_rn(ri, rmax);
      const float t = __fadd_ru(__fmul_ru(__fmul_ru(a, a), 1.0f + 0x1p-20f), 0x1p-126f);
      __syncwarp();
      rows[warp][lane] = make_float4(on ? s.pos[3 * i] : nan, on ? s.pos[3 * i + 1] : 0.0f,
                                     on ? s.pos[3 * i + 2] : 0.0f, t);
      rads[warp][lane] = ri;
      __syncwarp();

      bool hit[kK];
#pragma unroll
      for (int c = 0; c < kK; ++c) hit[c] = false;
#pragma unroll 8
      for (int r = 0; r < kSlice; ++r) {
        const float4 p = rows[warp][r];
#pragma unroll
        for (int c = 0; c < kK; ++c) {
          const float dx = __fsub_rn(p.x, cx[c]);
          const float dy = __fsub_rn(p.y, cy[c]);
          const float dz = __fsub_rn(p.z, cz[c]);
          const float r2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
          hit[c] |= r2 <= p.w;
        }
      }
      // the exact pass, on the flagged columns only
#pragma unroll
      for (int c = 0; c < kK; ++c) {
        if (!hit[c]) continue;
        const int j = bj * kTile + 32 * c + lane;
        const int end = kMode == kParents ? static_cast<int>(best[c]) : j;  // best <= j
        for (int r = 0; r < kSlice && r0 + r < end; ++r) {
          if (!touching(rows[warp][r], rads[warp][r], cx[c], cy[c], cz[c], cr[c])) continue;
          if (kMode == kParents) {
            best[c] = r0 + r;
            atomicMin(&s.parent[j], best[c]);
            break;
          }
          s.mark[r0 + r] = 1;
          s.mark[j] = 1;
        }
      }
    }
  }
}

// The co-resident blocks of the mode's kernel on `device` (the cooperative
// grid), cached a device.
cudaError_t resident_blocks(int device, int mode, int* blocks) {
  static int cache[kMaxDevices][2];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[device][mode] > 0) {
    *blocks = cache[device][mode];
    return cudaSuccess;
  }
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mode == kParents ? sweep_kernel<kParents> : sweep_kernel<kMark>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cache[device][mode] = *blocks = per_sm * sms;
  return cudaSuccess;
}

int launch(int mode, const void* pos, const void* radius, const void* alive,
           const void* contacts, int n, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  int grid = 0;
  err = resident_blocks(device, mode, &grid);
  if (err != cudaSuccess) return err;
  Sweep s{static_cast<const float*>(pos), static_cast<const float*>(radius),
          static_cast<const unsigned char*>(alive), static_cast<const int*>(contacts), n,
          mode == kParents ? static_cast<long long*>(out) : nullptr,
          mode == kMark ? static_cast<unsigned char*>(out) : nullptr};
  void* args[] = {&s};
  err = cudaLaunchCooperativeKernel(
      mode == kParents ? reinterpret_cast<const void*>(sweep_kernel<kParents>)
                       : reinterpret_cast<const void*>(sweep_kernel<kMark>),
      dim3(grid), dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pos: [n, 3] float; radius: [n] float; alive: [n] bool or null (all
// alive); contacts: one int32 on the device or null (no gate); parent: [n]
// int64, written for every body.
int collision_parents(const void* pos, const void* radius, const void* alive,
                      const void* contacts, int n, void* parent, void* stream, int device) {
  return launch(kParents, pos, radius, alive, contacts, n, parent, stream, device);
}

// As collision_parents; mark: [n] bool, written for every body.
int contact_marks(const void* pos, const void* radius, const void* alive,
                  const void* contacts, int n, void* mark, void* stream, int device) {
  return launch(kMark, pos, radius, alive, contacts, n, mark, stream, device);
}

// The launch shape on the current device: shape[0..5] = columns a lane,
// rows and columns a tile, rows staged a round, warps a block, co-resident
// blocks of the parents mode (0 if the device cannot tell), tiles at n.
void collision_parents_shape(int n, int* shape) {
  int device = 0, blocks = 0;
  if (cudaGetDevice(&device) != cudaSuccess || resident_blocks(device, kParents, &blocks) !=
                                                   cudaSuccess)
    blocks = 0;
  const long long nb = (static_cast<long long>(n) + kTile - 1) / kTile;
  shape[0] = kK;
  shape[1] = kTile;
  shape[2] = kSlice;
  shape[3] = kWarps;
  shape[4] = blocks;
  shape[5] = static_cast<int>(nb * (nb + 1) / 2);
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
