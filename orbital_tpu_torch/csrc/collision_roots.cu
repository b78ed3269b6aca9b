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
// The f64 instance (sweep_kernel<double, kMode>) is the same walk on
// double positions and radii, for f64 state: the JAX module runs both XLA
// sweeps in the state's dtype, so an f32 test parts from its roots and
// marks on grazing pairs. Its exact test is the same sequence of
// correctly rounded double operations (__dsub_rn, __dmul_rn, __dadd_rn,
// __dsqrt_rn), so it is integer-equal to the plain versions in f64. Its
// prefilter bound follows the same argument with u = 2^-53: T_i = (R_i +
// Rmax)^2 (1 + 2^-49) rounded up, plus 2^-1022 for subnormal squares. A pair
// costs the same instructions in the FP64 pipes, which run at half the f32
// FMA rate on an H100 SXM (33.5 against 67 TFLOP/s): its bound above a
// count of 0 is the pair tests at the FP64 rate.
//
// The gate: `contacts` is the int32 contact count that the detecting force
// sweep (B2, or B5's detecting variant) left on the device. When it is <= 0
// the launch writes the identity (parents) or zeros (mark) and returns: no
// pair work and no host read, as the bounce kernel (collisions.cu) skips its
// sweep. With a null pointer the sweep always runs.
//
// Mode "count" (count_kernel<T>) is the directed contact count of a ring
// round: body block j on body block i, with global ids i_off + i and j_off +
// j. It stands in for the XLA block count of orbital_tpu/ops/collisions.py:
// 97-113 (_contacts_block), ringed by orbital_tpu/parallel/sharded.py:199-231
// after each step of the mesh solvers (force_impl "pm", "p3m" and "tree")
// with collisions:
//
//   count = #{(i, j) : alive_i, alive_j, i_off + i != j_off + j, r2 <= q},
//   r2 = (dx dx + dy dy) + dz dz, d = r_i - r_j,
//   q = rho rho, rho = (R_i + R_j) 1.00001,
//
// each product and sum rounded once (__fmul_rn / __fadd_rn, or their double
// forms) and 1.00001 in the tables' type (1.00001f in f32), as torch and JAX
// apply it, so the count is integer-equal to its plain version
// (ops/collisions.py::block_contacts) by construction. The f32 instance
// serves f32 and ds32 state (the hi words, as the plain version counts), the
// f64 instance f64 state (JAX counts in double under x64).
//
// What bounds it on this card: the n_i n_j pair tests (10 operations each,
// at the f32 rate, or the FP64 rate for the f64 instance); the count is
// directed, so the whole rectangle is swept. Design, from the sweep above:
// - a warp takes one tile of kTile rows x kTile columns of the rectangle
//   (tile w of row-major order, w = blockIdx.x kWarps + warp): every tile
//   costs the same, so a plain launch of ceil(tiles / kWarps) blocks spreads
//   the work evenly (4,096 blocks at 16,384^2);
// - a lane holds kK columns in registers, and the warp stages the tile's
//   rows 32 at a time into its shared slice (x, y, z, T_i) under a warp
//   barrier;
// - the prefilter is per row: T_i = (fl(R_i + Rmax) c rounded up)^2 (1 + 16
//   u) rounded up, plus the smallest normal (Ops::bound), with Rmax the
//   tile's largest live column radius and c = 1.00001 in the tables' type.
//   It is a superset of the exact test. For a counted pair, s <= q with s
//   the exact test's r2. s and the prefilter's FMA r2, s', each round every
//   term of S = dx^2 + dy^2 + dz^2 (all >= 0) at most three times, so s'
//   <= S (1 + u)^3 <= s (1 + u)^6. q <= rho^2 (1 + u), and rho <= fl(R_i +
//   R_j) c (1 + u) <= a c (1 + u) with a = fl(R_i + Rmax), by monotone
//   rounding; a' = a c rounded up >= a c. So s' <= a'^2 (1 + u)^9 < a'^2 (1 +
//   16 u) <= T_i (u = 2^-24 in f32, 2^-53 in f64; the smallest normal covers
//   the absolute error of subnormal squares). Dead rows and columns, and
//   those past the tables, hold a NaN x and fail both tests by select;
//   parked and sentinel rows (1e30, whose r2 overflows to inf in f32) fail
//   the exact test as the plain version's do.
// - after each 32-row slice a lane whose column was flagged runs the exact
//   test on the slice's rows (self pairs, equal global ids, excluded), adding
//   to its own int count. At the tile's end the warp sums its lanes with
//   __reduce_add_sync and lane 0 makes one integer atomicAdd into the
//   caller's int32, when the sum is not 0: an integer sum does not depend
//   on order, so reruns are bit-equal, and the P rounds of a ring add into
//   one count in place. No memset and no host read: a round is one launch.
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

template <typename T>
struct Sweep {
  const T* pos;                  // [n, 3]
  const T* radius;               // [n]
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

template <typename T>
__device__ __forceinline__ bool live(const Sweep<T>& s, int i) {
  return i < s.n && (s.alive == nullptr || s.alive[i] != 0);
}

// The scalar type's correctly rounded operations, its row of four, its
// quiet NaN, the prefilter's bound T_i from a = R_i + Rmax: a^2 (1 + 16 u)
// rounded up, plus the smallest normal (u the unit roundoff), and the
// count's radius inflation 1.00001 in the type with a product rounded up.
template <typename T>
struct Ops;

template <>
struct Ops<float> {
  using Row = float4;
  static __device__ __forceinline__ float inflate() { return 1.00001f; }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float mul_up(float a, float b) { return __fmul_ru(a, b); }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float nan() { return __int_as_float(0x7fffffff); }
  static __device__ __forceinline__ float bound(float a) {
    return __fadd_ru(__fmul_ru(__fmul_ru(a, a), 1.0f + 0x1p-20f), 0x1p-126f);
  }
  static __device__ __forceinline__ float4 row(float x, float y, float z, float t) {
    return make_float4(x, y, z, t);
  }
};

// four doubles in one 32-byte shared load (CUDA 13 deprecates double4)
struct alignas(32) Row64 {
  double x, y, z, w;
};

template <>
struct Ops<double> {
  using Row = Row64;
  static __device__ __forceinline__ double inflate() { return 1.00001; }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double mul_up(double a, double b) { return __dmul_ru(a, b); }
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return __fma_rn(a, b, c);
  }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double max(double a, double b) { return fmax(a, b); }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7fffffffffffffffLL);
  }
  static __device__ __forceinline__ double bound(double a) {
    return __dadd_ru(__dmul_ru(__dmul_ru(a, a), 1.0 + 0x1p-49), 0x1p-1022);
  }
  static __device__ __forceinline__ Row64 row(double x, double y, double z, double t) {
    return Row64{x, y, z, t};
  }
};

// JAX's touching test of row (x, y, z) radius ri against column c.
template <typename T, typename Row>
__device__ __forceinline__ bool touching(Row p, T ri, T cx, T cy, T cz, T cr) {
  using O = Ops<T>;
  const T dx = O::sub(p.x, cx);
  const T dy = O::sub(p.y, cy);
  const T dz = O::sub(p.z, cz);
  const T r2 = O::add(O::add(O::mul(dx, dx), O::mul(dy, dy)), O::mul(dz, dz));
  const T dist = O::sqrt(r2);
  return dist <= O::add(ri, cr) && dist > T(0);
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads) sweep_kernel(Sweep<T> s) {
  using O = Ops<T>;
  using Row = typename O::Row;
  __shared__ Row rows[kWarps][kSlice];  // x (NaN when dead), y, z, T_i
  __shared__ T rads[kWarps][kSlice];    // R_i
  const T nan = O::nan();
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
    T cx[kK], cy[kK], cz[kK], cr[kK];
    long long best[kK];  // parents: the lowest touching row known
    T rmax = T(0);
#pragma unroll
    for (int c = 0; c < kK; ++c) {
      const int j = bj * kTile + 32 * c + lane;
      const bool on = live(s, j);
      cx[c] = on ? s.pos[3 * j] : nan;
      cy[c] = on ? s.pos[3 * j + 1] : T(0);
      cz[c] = on ? s.pos[3 * j + 2] : T(0);
      cr[c] = on ? s.radius[j] : T(0);
      rmax = O::max(rmax, cr[c]);
      // the parent so far, from L2 (other SMs' atomics; a stale value only
      // exits later)
      if (kMode == kParents) best[c] = on ? __ldcg(&s.parent[j]) : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) rmax = O::max(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));

    for (int r0 = bi * kTile; r0 < bi * kTile + kTile; r0 += kSlice) {
      if (kMode == kParents) {
        bool want = false;
#pragma unroll
        for (int c = 0; c < kK; ++c) want |= best[c] > r0;
        if (!__any_sync(0xffffffffu, want)) break;
      }
      const int i = r0 + lane;
      const bool on = live(s, i);
      const T ri = on ? s.radius[i] : T(0);
      const T t = O::bound(O::add(ri, rmax));
      __syncwarp();
      rows[warp][lane] = O::row(on ? s.pos[3 * i] : nan, on ? s.pos[3 * i + 1] : T(0),
                                on ? s.pos[3 * i + 2] : T(0), t);
      rads[warp][lane] = ri;
      __syncwarp();

      bool hit[kK];
#pragma unroll
      for (int c = 0; c < kK; ++c) hit[c] = false;
#pragma unroll 8
      for (int r = 0; r < kSlice; ++r) {
        const Row p = rows[warp][r];
#pragma unroll
        for (int c = 0; c < kK; ++c) {
          const T dx = O::sub(p.x, cx[c]);
          const T dy = O::sub(p.y, cy[c]);
          const T dz = O::sub(p.z, cz[c]);
          const T r2 = O::fma(dz, dz, O::fma(dy, dy, O::mul(dx, dx)));
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

template <typename T>
const void* kernel_of(int mode) {
  return mode == kParents ? reinterpret_cast<const void*>(sweep_kernel<T, kParents>)
                          : reinterpret_cast<const void*>(sweep_kernel<T, kMark>);
}

// The co-resident blocks of the instance's kernel on `device` (the
// cooperative grid), cached a device; `wide` picks the f64 instance.
cudaError_t resident_blocks(int device, int mode, int wide, int* blocks) {
  static int cache[kMaxDevices][2][2];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[device][wide][mode] > 0) {
    *blocks = cache[device][wide][mode];
    return cudaSuccess;
  }
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, wide ? kernel_of<double>(mode) : kernel_of<float>(mode), kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cache[device][wide][mode] = *blocks = per_sm * sms;
  return cudaSuccess;
}

template <typename T>
int launch(int mode, const void* pos, const void* radius, const void* alive,
           const void* contacts, int n, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  int grid = 0;
  err = resident_blocks(device, mode, sizeof(T) == 8, &grid);
  if (err != cudaSuccess) return err;
  Sweep<T> s{static_cast<const T*>(pos), static_cast<const T*>(radius),
             static_cast<const unsigned char*>(alive), static_cast<const int*>(contacts), n,
             mode == kParents ? static_cast<long long*>(out) : nullptr,
             mode == kMark ? static_cast<unsigned char*>(out) : nullptr};
  void* args[] = {&s};
  err = cudaLaunchCooperativeKernel(kernel_of<T>(mode), dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Mode "count": one table of each side of a ring round.
template <typename T>
struct Side {
  const T* pos;                  // [n, 3]
  const T* radius;               // [n]
  const unsigned char* alive;    // [n] or null (all alive)
  int n;
  long long off;                 // the global id of row 0
};

template <typename T>
__device__ __forceinline__ bool live(const Side<T>& s, int i) {
  return i < s.n && (s.alive == nullptr || s.alive[i] != 0);
}

// The plain version's test of row (x, y, z) radius ri against column c:
// r2 <= rho rho, rho = (R_i + R_j) 1.00001, each operation rounded once.
template <typename T, typename Row>
__device__ __forceinline__ bool counted(Row p, T ri, T cx, T cy, T cz, T cr) {
  using O = Ops<T>;
  const T dx = O::sub(p.x, cx);
  const T dy = O::sub(p.y, cy);
  const T dz = O::sub(p.z, cz);
  const T r2 = O::add(O::add(O::mul(dx, dx), O::mul(dy, dy)), O::mul(dz, dz));
  const T rho = O::mul(O::add(ri, cr), O::inflate());
  return r2 <= O::mul(rho, rho);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) count_kernel(Side<T> si, Side<T> sj, int nbj,
                                                         long long tiles, int* count) {
  using O = Ops<T>;
  using Row = typename O::Row;
  __shared__ Row rows[kWarps][kSlice];  // x (NaN when dead), y, z, T_i
  __shared__ T rads[kWarps][kSlice];    // R_i
  const T nan = O::nan();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (tile >= tiles) return;  // the warp's own: no block barrier below
  const int bi = static_cast<int>(tile / nbj), bj = static_cast<int>(tile % nbj);

  T cx[kK], cy[kK], cz[kK], cr[kK];
  long long id[kK];  // the column's global id, less the rows' offset
  T rmax = T(0);
#pragma unroll
  for (int c = 0; c < kK; ++c) {
    const int j = bj * kTile + 32 * c + lane;
    const bool on = live(sj, j);
    cx[c] = on ? sj.pos[3 * j] : nan;
    cy[c] = on ? sj.pos[3 * j + 1] : T(0);
    cz[c] = on ? sj.pos[3 * j + 2] : T(0);
    cr[c] = on ? sj.radius[j] : T(0);
    id[c] = sj.off + j - si.off;
    rmax = O::max(rmax, cr[c]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) rmax = O::max(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));

  int hits = 0;
  for (int r0 = bi * kTile; r0 < bi * kTile + kTile; r0 += kSlice) {
    const int i = r0 + lane;
    const bool on = live(si, i);
    const T ri = on ? si.radius[i] : T(0);
    const T t = O::bound(O::mul_up(O::add(ri, rmax), O::inflate()));
    __syncwarp();
    rows[warp][lane] = O::row(on ? si.pos[3 * i] : nan, on ? si.pos[3 * i + 1] : T(0),
                              on ? si.pos[3 * i + 2] : T(0), t);
    rads[warp][lane] = ri;
    __syncwarp();

    bool hit[kK];
#pragma unroll
    for (int c = 0; c < kK; ++c) hit[c] = false;
#pragma unroll 8
    for (int r = 0; r < kSlice; ++r) {
      const Row p = rows[warp][r];
#pragma unroll
      for (int c = 0; c < kK; ++c) {
        const T dx = O::sub(p.x, cx[c]);
        const T dy = O::sub(p.y, cy[c]);
        const T dz = O::sub(p.z, cz[c]);
        const T r2 = O::fma(dz, dz, O::fma(dy, dy, O::mul(dx, dx)));
        hit[c] |= r2 <= p.w;
      }
    }
    // the exact pass, on the flagged columns only
#pragma unroll
    for (int c = 0; c < kK; ++c) {
      if (!hit[c]) continue;
      for (int r = 0; r < kSlice; ++r)
        hits += (r0 + r != id[c] &&
                 counted(rows[warp][r], rads[warp][r], cx[c], cy[c], cz[c], cr[c]));
    }
  }
  const int total = __reduce_add_sync(0xffffffffu, hits);
  if (lane == 0 && total != 0) atomicAdd(count, total);
}

constexpr int kCountShape = 6;

// The count's tiles and blocks over an n_i x n_j rectangle.
void count_plan(int n_i, int n_j, long long* tiles, int* nbj, long long* grid) {
  const long long nbi = (static_cast<long long>(n_i) + kTile - 1) / kTile;
  *nbj = (n_j + kTile - 1) / kTile;
  *tiles = nbi * *nbj;
  *grid = (*tiles + kWarps - 1) / kWarps;
}

template <typename T>
int launch_count(const void* pos_i, const void* radius_i, const void* alive_i, long long i_off,
                 int n_i, const void* pos_j, const void* radius_j, const void* alive_j,
                 long long j_off, int n_j, void* count, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_i <= 0 || n_j <= 0) return cudaSuccess;
  long long tiles = 0, grid = 0;
  int nbj = 0;
  count_plan(n_i, n_j, &tiles, &nbj, &grid);
  Side<T> si{static_cast<const T*>(pos_i), static_cast<const T*>(radius_i),
             static_cast<const unsigned char*>(alive_i), n_i, i_off};
  Side<T> sj{static_cast<const T*>(pos_j), static_cast<const T*>(radius_j),
             static_cast<const unsigned char*>(alive_j), n_j, j_off};
  count_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(si, sj, nbj, tiles,
                                                         static_cast<int*>(count));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pos: [n, 3] float; radius: [n] float; alive: [n] bool or null (all
// alive); contacts: one int32 on the device or null (no gate); parent: [n]
// int64, written for every body.
int collision_parents(const void* pos, const void* radius, const void* alive,
                      const void* contacts, int n, void* parent, void* stream, int device) {
  return launch<float>(kParents, pos, radius, alive, contacts, n, parent, stream, device);
}

// As collision_parents; mark: [n] bool, written for every body.
int contact_marks(const void* pos, const void* radius, const void* alive,
                  const void* contacts, int n, void* mark, void* stream, int device) {
  return launch<float>(kMark, pos, radius, alive, contacts, n, mark, stream, device);
}

// The f64 instances: pos [n, 3] and radius [n] double, the rest as above.
int collision_parents_f64(const void* pos, const void* radius, const void* alive,
                          const void* contacts, int n, void* parent, void* stream,
                          int device) {
  return launch<double>(kParents, pos, radius, alive, contacts, n, parent, stream, device);
}

int contact_marks_f64(const void* pos, const void* radius, const void* alive,
                      const void* contacts, int n, void* mark, void* stream, int device) {
  return launch<double>(kMark, pos, radius, alive, contacts, n, mark, stream, device);
}

// The launch shape on the current device: shape[0..5] = columns a lane,
// rows and columns a tile, rows staged a round, warps a block, co-resident
// blocks of the parents mode (0 if the device cannot tell), tiles at n.
void collision_parents_shape(int n, int* shape) {
  int device = 0, blocks = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      resident_blocks(device, kParents, 0, &blocks) != cudaSuccess)
    blocks = 0;
  const long long nb = (static_cast<long long>(n) + kTile - 1) / kTile;
  shape[0] = kK;
  shape[1] = kTile;
  shape[2] = kSlice;
  shape[3] = kWarps;
  shape[4] = blocks;
  shape[5] = static_cast<int>(nb * (nb + 1) / 2);
}

// Mode "count": adds the directed contact count of block j (pos_j [n_j, 3],
// radius_j [n_j], alive_j [n_j] bool or null, global ids j_off + j) on block
// i (likewise) to *count, one int32 on the device; float tables.
int contact_count(const void* pos_i, const void* radius_i, const void* alive_i,
                  long long i_off, int n_i, const void* pos_j, const void* radius_j,
                  const void* alive_j, long long j_off, int n_j, void* count, void* stream,
                  int device) {
  return launch_count<float>(pos_i, radius_i, alive_i, i_off, n_i, pos_j, radius_j, alive_j,
                             j_off, n_j, count, stream, device);
}

// The f64 instance: double tables, the rest as above.
int contact_count_f64(const void* pos_i, const void* radius_i, const void* alive_i,
                      long long i_off, int n_i, const void* pos_j, const void* radius_j,
                      const void* alive_j, long long j_off, int n_j, void* count, void* stream,
                      int device) {
  return launch_count<double>(pos_i, radius_i, alive_i, i_off, n_i, pos_j, radius_j, alive_j,
                              j_off, n_j, count, stream, device);
}

// The count's launch shape at n_i x n_j: shape[0..5] = columns a lane, rows
// and columns a tile, rows staged a round, warps a block, blocks, tiles.
void contact_count_shape(int n_i, int n_j, long long* shape) {
  long long tiles = 0, grid = 0;
  int nbj = 0;
  count_plan(n_i, n_j, &tiles, &nbj, &grid);
  const long long out[kCountShape] = {kK, kTile, kSlice, kWarps, grid, tiles};
  for (int k = 0; k < kCountShape; ++k) shape[k] = out[k];
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
