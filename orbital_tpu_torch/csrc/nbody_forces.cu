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
// What bounds it on this card: instruction issue. A pair costs 18 f32
// operations (a fused multiply-add counted as two) and one MUFU.RSQ, but
// they are 14 warp instructions of which 8 are single FADD/FMUL, and the
// card issues one warp instruction a clock on each of its 528 schedulers:
// at 65,536 bodies one instruction a pair costs 0.128 ms at 1.98 GHz,
// against 0.064 ms for two flops a pair at the f32 peak. Device memory
// traffic is O(N) a block and stays in L2. The inner loop of this build
// (cuobjdump -sass, sm_90a) takes 14.6 warp instructions a pair for B1
// without PE (15.5 with PE, for B3 and for B2), against 18.4 (B1) and 24.9
// (B2) for the first version (one i body a thread, rsqrtf, the contact
// test on every pair): a 1.87 ms floor for B1 at 65,536 bodies, which it
// reaches to ~80% on an NVIDIA H100 80GB HBM3 at 700 W with the SM clock at
// 1,980 MHz (chip_smoke.py --parent; PERF.md). 12 to 24 resident warps an
// SM ran alike in the sweep, so the rest is not latency that more warps
// would hide.
//
// Design (register tiling with the j range split across warps):
// - Each thread holds kK i bodies in registers (rows base + lane + 32 k of
//   its block), so each j entry read from shared memory serves kK pairs and
//   the thread has kK independent chains of sums.
// - Each block covers 32 kK i bodies with kQ warps. Warp w sweeps its own
//   slice of the j range, tiles w, w + kQ, w + 2 kQ, ... of kTile bodies,
//   each staged by the warp itself into its own shared tile (a broadcast
//   read, no bank conflicts); a warp barrier, not a block barrier, guards
//   it, so warps run the loop independently.
// - Each tile is summed into fresh partials before it joins the warp's
//   running sums (a two-level sum whose f32 rounding grows with the tile
//   and tile counts, not with N). At the end the kQ running sums of each
//   i body are added in shared memory in the fixed order w = 0, 1, ..., so
//   the result is the same from run to run: no float atomics.
// - The softened path takes one MUFU.RSQ a pair (rsqrt.approx.ftz): its
//   argument r2 + eps2 >= eps2 > 0 is never denormal, so flushing denormals
//   gives the bits of rsqrtf, which would add a denormal fix-up (a compare
//   and two predicated scales) to every pair. The eps2 == 0 path keeps
//   rsqrtf. This is local to these kernels: the build adds no -ftz flag.
// - The ragged last tile is cut by its own trip count, so N need not divide
//   by the tile; i rows past n are swept against zeros and not written.
//   Padded and dead bodies arrive with mass 0 and exert nothing.
// - With kQ = 1 each row's summation order is the first version's (one i
//   body a thread, tiles of 128): that build is bit-equal to it.
// - kK = 4, kQ = 16, kTile = 128: 128 i bodies and 512 threads a block,
//   512 blocks at 65,536 bodies, 93 registers, no spills. The sweep
//   (chip_smoke.py --sweep; PERF.md) found k = 4 to 8 with q = 4 to 16
//   within ~3% of each other and k = 1 slower. kK and kQ are the
//   OT_FORCES_K and OT_FORCES_Q macros below, which the sweep sets with -D;
//   chip_smoke.py's phase 2 prints the shape, registers and SASS
//   instructions a pair it built.
//
// Masking, as in the TPU kernel: with eps2 > 0 nothing is masked (a self
// pair has dx = dy = dz = 0 and adds no force; it adds m_i/eps to pe_i, which
// the caller subtracts). With eps2 == 0 an r2 > 0 select drops self pairs
// and coincident bodies. Never mask i == j here as well: the caller's
// self-PE subtraction would then remove the self term twice.
//
// Contact detection (kDetect, B2): the same kernel with the radii (times
// alive) staged beside the float4 tiles. The force arithmetic is B1's, op
// for op, on the same launch shape, so a contact-free step on B2 is
// bit-equal to one on B1. The count reads the same unsoftened r2: the sweep
// keeps each row's nearest r2 in the tile (one FMNMX a pair), and only if
// some row of the warp has it within ((R_i + max R_j) * 1.00001)^2 (a
// superset of the exact test, since rounding is monotone) does the warp
// count that tile exactly, ((R_i + R_j) * 1.00001)^2 pair by pair. Contacts
// are rare, so nearly every tile costs the one FMNMX a pair; the tile that
// holds a row's own body is always counted. Each thread counts each of its
// rows in an int, drops the rows past n, and each block reduces its
// threads' counts and adds them to one int32 with one atomicAdd. Self pairs (r2 = 0) are counted, as in the TPU
// kernel: the caller starts the counter at -N instead of 0 (and does not
// subtract N afterwards). Dead bodies carry radius 0 and sit at spread-out
// far positions, so they add only their own self pair. The 1e-5 inflation
// keeps the gate conservative: a grazing pair can cost a redundant bounce
// sweep but never skip one.
//
// Separate i and j tables (B3, block_forces_kernel): the ring's block of
// n_i x n_j pairs, pos_i [n_i, 3] against pos_j [n_j, 3] and mass_j [n_j]
// read in place. Its force arithmetic is B1's tile sweep (accumulate_tile);
// it keeps the PE sum on and subtracts nothing (its pe row includes the
// i == j term where the tables coincide; the ring strips it once).
//
// B3's detecting instance (no TPU kernel: it stands in for the sqrt-free
// count ring of orbital_tpu/parallel/sharded.py:199-231, whose block is
// ops/collisions.py:97-113 _contacts_block): the same sweep with the radius
// and alive tables of each side and the blocks' global offsets, so that the
// ring's closing force evaluation also counts the step's contacts. Its
// force arithmetic is B3's op for op. The count is exact by construction: a
// pair is counted when r2 <= ((R_i + R_j) * 1.00001)^2 and the global ids
// differ (self pairs are excluded by index, not counted and subtracted), and
// a dead body takes a NaN radius as it is staged, for which every
// comparison is false. The kernel writes the count whole.
//
// What bounded the block at the ring's shapes (16,384^2 at 4 ranks,
// 8,192^2 at 8): its launch. On B1's shape (one block of 16 warps an SM,
// n_i / 128 blocks) it ran 128 blocks at 16,384 (4 SMs idle) and 64 at
// 8,192, each with a quarter or an eighth of the j work it has at 65,536,
// so that B3 detect took 0.230 ms at 16,384^2 (40% of its bound) with the
// same inner loop as B2 (16.5 SASS instructions a pair against 15.5, one
// FMNMX; the loop has nothing else to take out) and a wrapper that packed
// both sides and built the NaN radius tables in ~7 eager kernels a call.
// The redesign splits j across blocks as well as across warps (the plan
// takes at least 2 x 132 units where the i tiles allow), holds 2 i bodies a
// thread so that two blocks of 16 warps fit an SM (__launch_bounds__(512,
// 2): 32 warps, against 16), adds the splits' partials in a fixed order on
// the device, and reads the tables in place. A row's sum over one split is
// B1's, so B3 on coinciding tables stays bit-equal to B1. In turns with the
// first block form (chip_smoke.py --parent; NVIDIA H100 80GB HBM3, 700 W):
// B3 detect 0.186 ms at 16,384^2 (0.203) and 0.082 at 8,192^2 (0.184), B3
// 0.165 (0.175) and 0.064 (0.102). It stays issue-bound: 17.0 SASS
// instructions a pair for B3 detect and 16.0 for B3 (two i bodies a thread
// add half an LDS and half a loop instruction a pair to B1's loop), with
// B3 detect ~12% behind B3 where its FMNMX adds 6%: both loops sit at the
// 64-register cap, the detecting one with more live values.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

#ifndef OT_FORCES_K
#define OT_FORCES_K 4
#endif
#ifndef OT_FORCES_Q
#define OT_FORCES_Q 16
#endif
#ifndef OT_BLOCK_K
#define OT_BLOCK_K 2
#endif
#ifndef OT_BLOCK_Q
#define OT_BLOCK_Q 16
#endif
#ifndef OT_BLOCK_MIN
#define OT_BLOCK_MIN 2
#endif

namespace {

constexpr int kK = OT_FORCES_K;          // i bodies a thread
constexpr int kQ = OT_FORCES_Q;          // warps a block, one j slice each
constexpr int kTile = 128;               // j bodies a warp's tile
constexpr int kThreads = 32 * kQ;
constexpr int kRows = 32 * kK;           // i bodies a block
// a warp's shared slot: its tile during the sweep, its sums after it
constexpr int kSlot = kTile > kRows ? kTile : kRows;
static_assert(kK >= 1 && kQ >= 1 && kTile % 32 == 0, "bad launch shape");
// B3 and B3 detect (block_forces_kernel): i bodies a thread, warps a block,
// and the blocks an SM its registers are capped for
constexpr int kBK = OT_BLOCK_K;
constexpr int kBQ = OT_BLOCK_Q;
constexpr int kBMin = OT_BLOCK_MIN;
constexpr int kBThreads = 32 * kBQ;
constexpr int kBRows = 32 * kBK;
constexpr int kBSlot = kTile > kBRows ? kTile : kBRows;
static_assert(kBK >= 1 && kBQ >= 1 && kBMin >= 1, "bad block launch shape");

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

// |r_j - r_i|^2 in one rounding order, shared by the sweep and the exact
// count, so that the count's prefilter and its test read the same value
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return fmaf(dz, dz, fmaf(dx, dx, dy * dy));
}

// Sums one tile into fresh partials t (x, y, z, pe) of each of the kK rows,
// which the caller adds to its running totals; with kDetect, also each
// row's nearest r2 in the tile.
template <int K, bool kPE, bool kSoft, bool kDetect>
__device__ __forceinline__ void accumulate_tile(const float4* tile, int count,
                                                const float4 (&pi)[K], float eps2,
                                                float4 (&t)[K], float (&nearest)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    t[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    nearest[k] = __int_as_float(0x7f800000);  // +inf
  }
#pragma unroll 4
  for (int jj = 0; jj < count; ++jj) {
    const float4 pj = tile[jj];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float dx = pj.x - pi[k].x;
      const float dy = pj.y - pi[k].y;
      const float dz = pj.z - pi[k].z;
      const float r2 = dist2(dx, dy, dz);
      if (kDetect) nearest[k] = fminf(nearest[k], r2);
      float inv_r;
      if (kSoft) {
        inv_r = rsqrt_ftz(r2 + eps2);
      } else {
        inv_r = r2 > 0.0f ? rsqrtf(r2) : 0.0f;
      }
      const float w = pj.w * (inv_r * inv_r * inv_r);
      t[k].x += w * dx;
      t[k].y += w * dy;
      t[k].z += w * dz;
      if (kPE) t[k].w += pj.w * inv_r;
    }
  }
}

// The exact contact count of one tile: r2 <= ((R_i + R_j) * 1.00001)^2.
__device__ __forceinline__ void count_tile(const float4* tile, const float* rtile, int count,
                                           const float4 (&pi)[kK], const float (&ri)[kK],
                                           int (&touch)[kK]) {
  for (int jj = 0; jj < count; ++jj) {
    const float4 pj = tile[jj];
    const float rj = rtile[jj];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float r2 = dist2(pj.x - pi[k].x, pj.y - pi[k].y, pj.z - pi[k].z);
      const float rsum = (ri[k] + rj) * 1.00001f;
      touch[k] += r2 <= rsum * rsum;
    }
  }
}

// count_tile over separate tables (B3 detect): row k of the thread and
// column jj of the tile have equal global ids when i0 + 32 k == jj, i0 being
// the thread's first row, minus the tile's first column, minus the blocks'
// offset difference; such a pair is skipped. Alive is in the radii (NaN
// when dead).
template <int K>
__device__ __forceinline__ void count_tile_ids(const float4* tile, const float* rtile,
                                               int count, const float4 (&pi)[K],
                                               const float (&ri)[K], int i0,
                                               int (&touch)[K]) {
  for (int jj = 0; jj < count; ++jj) {
    const float4 pj = tile[jj];
    const float rj = rtile[jj];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float r2 = dist2(pj.x - pi[k].x, pj.y - pi[k].y, pj.z - pi[k].z);
      const float rsum = (ri[k] + rj) * 1.00001f;
      touch[k] += (r2 <= rsum * rsum) && (i0 + 32 * k != jj);
    }
  }
}

// The second bound (one block an SM) lets ptxas use up to 128 registers a
// thread. Without it ptxas aims at two blocks an SM and caps the kernel at 64
// registers. That ran B1 4% and B2 18% slower (chip_smoke.py; PERF.md).
template <bool kPE, bool kSoft, bool kDetect>
__global__ void __launch_bounds__(kThreads, 1)
nbody_forces_kernel(const float4* __restrict__ pts_i, int n_i,
                    const float4* __restrict__ pts_j, int n_j,
                    const float* __restrict__ radius_i,
                    const float* __restrict__ radius_j, float G, float eps2,
                    float4* __restrict__ out, int* __restrict__ contacts) {
  __shared__ float4 slots[kQ][kSlot];
  __shared__ float rtiles[kDetect ? kQ : 1][kDetect ? kTile : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kRows;
  float4 pi[kK], s[kK];
  float ri[kK];
  int touch[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int i = base + lane + 32 * k;
    pi[k] = i < n_i ? pts_i[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    ri[k] = (kDetect && i < n_i) ? radius_i[i] : 0.0f;
    s[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    touch[k] = 0;
  }
  float4* tile = slots[warp];
  float* rtile = rtiles[kDetect ? warp : 0];
  for (int j0 = warp * kTile; j0 < n_j; j0 += kQ * kTile) {
    float rmax = 0.0f;  // the largest radius this lane staged
#pragma unroll
    for (int r = lane; r < kTile; r += 32) {
      if (j0 + r < n_j) {
        tile[r] = pts_j[j0 + r];
        if (kDetect) {
          const float rj = radius_j[j0 + r];
          rtile[r] = rj;
          rmax = fmaxf(rmax, rj);
        }
      }
    }
    __syncwarp();
    const int count = min(kTile, n_j - j0);
    float4 t[kK];
    float nearest[kK];
    if (count == kTile) {
      accumulate_tile<kK, kPE, kSoft, kDetect>(tile, kTile, pi, eps2, t, nearest);
    } else {
      accumulate_tile<kK, kPE, kSoft, kDetect>(tile, count, pi, eps2, t, nearest);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      s[k].x += t[k].x;
      s[k].y += t[k].y;
      s[k].z += t[k].z;
      if (kPE) s[k].w += t[k].w;
    }
    if (kDetect) {
      // a row can touch a body of the tile only if its nearest r2 passes the
      // test at the tile's largest radius (rounding is monotone, so this is
      // a superset of the exact test); then the warp counts the tile exactly
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      bool maybe = false;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const float rsum = (ri[k] + rmax) * 1.00001f;
        maybe = maybe || nearest[k] <= rsum * rsum;
      }
      if (__any_sync(0xffffffffu, maybe)) count_tile(tile, rtile, count, pi, ri, touch);
    }
    __syncwarp();
  }
  // the kQ slices' sums of each row, added in warp order
#pragma unroll
  for (int k = 0; k < kK; ++k) tile[lane + 32 * k] = s[k];
  __syncthreads();
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    if (base + r >= n_i) break;
    float4 a = slots[0][r];
    for (int q = 1; q < kQ; ++q) {
      const float4 b = slots[q][r];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    out[base + r] = make_float4(G * a.x, G * a.y, G * a.z, a.w);
  }
  if (kDetect) {
    // rows past n counted against the zero-padded pi: drop them, then one
    // warp reduction, one shared slot per warp, one atomic per block
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kK; ++k) mine += base + lane + 32 * k < n_i ? touch[k] : 0;
    mine = __reduce_add_sync(0xffffffffu, mine);
    __shared__ int warp_sums[kQ];
    if (lane == 0) warp_sums[warp] = mine;
    __syncthreads();
    if (threadIdx.x == 0) {
      int block_sum = 0;
#pragma unroll
      for (int w = 0; w < kQ; ++w) block_sum += warp_sums[w];
      atomicAdd(contacts, block_sum);
    }
  }
}

template <bool kPE, bool kSoft, bool kDetect>
void launch(const float4* p, int n, const float* radius, float G, float eps2, float4* out,
            int* contacts, cudaStream_t stream) {
  const int grid = (n + kRows - 1) / kRows;
  nbody_forces_kernel<kPE, kSoft, kDetect><<<grid, kThreads, 0, stream>>>(
      p, n, p, n, radius, radius, G, eps2, out, contacts);
}

// ---- B3 and B3 detect: the ring's block over separate i and j tables ----
//
// Each block takes one unit of the launch plan (ops/cuda_forces.py::
// block_plan): i tile t = unit % tiles (kBRows rows) against j split s =
// unit / tiles (split_len bodies, a multiple of kTile), warp w of the block
// sweeping the split's j tiles w, w + kBQ, w + 2 kBQ, ... (cut at the
// split's end and n_j), each staged by the warp, as B1's warps sweep the
// whole j range: with one split a row's sums are B1's, bit for bit, when
// kBQ is B1's kQ. The kBQ warps' sums are
// added in warp order in shared memory; with one split they are the
// output, else the split's partial, and the last block of the tile to
// finish (an integer counter a tile behind a __threadfence, which it
// resets) adds the tile's partials in split order: no float atomics, the
// same result from run to run. The count is a per-block integer atomic
// into a tally behind the tiles' counters (done[tiles]); the last block of
// the grid to finish (done[tiles + 1] counts them) moves it to `contacts`
// and sets both back to 0.
// B3 and B3 detect are one template, so their forces are bit-equal.
template <bool kDetect>
__global__ void __launch_bounds__(kBThreads, kBMin)
block_forces_kernel(const float* __restrict__ pos_i, int n_i, const float* __restrict__ pos_j,
                    const float* __restrict__ mass_j, int n_j,
                    const float* __restrict__ radius_i,
                    const unsigned char* __restrict__ alive_i,
                    const float* __restrict__ radius_j,
                    const unsigned char* __restrict__ alive_j, int diag, float G, float eps2,
                    int tiles, int splits, int split_len, float4* __restrict__ part, unsigned int* __restrict__ done,
                    float4* __restrict__ out, int* __restrict__ contacts) {
  __shared__ float4 slots[kBQ][kBSlot];
  __shared__ float rtiles[kDetect ? kBQ : 1][kDetect ? kTile : 1];
  __shared__ int warp_sums[kBQ];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile_i = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int base = tile_i * kBRows;
  const float nan = __int_as_float(0x7fc00000);
  float4 pi[kBK], s[kBK];
  float ri[kBK];
  int touch[kBK];
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const int i = base + lane + 32 * k;
    pi[k] = i < n_i ? make_float4(pos_i[3 * i], pos_i[3 * i + 1], pos_i[3 * i + 2], 0.0f)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // a dead body's NaN radius fails every comparison
    ri[k] = (kDetect && i < n_i) ? (alive_i[i] ? radius_i[i] : nan) : 0.0f;
    s[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    touch[k] = 0;
  }
  float4* tile = slots[warp];
  float* rtile = rtiles[kDetect ? warp : 0];
  const int j_end = min((split + 1) * split_len, n_j);
  for (int j0 = split * split_len + warp * kTile; j0 < j_end; j0 += kBQ * kTile) {
    const int count = min(kTile, j_end - j0);
    float rmax = 0.0f;  // the largest radius this lane staged
#pragma unroll
    for (int r = lane; r < kTile; r += 32) {
      if (r < count) {
        const int j = j0 + r;
        tile[r] = make_float4(pos_j[3 * j], pos_j[3 * j + 1], pos_j[3 * j + 2], mass_j[j]);
        if (kDetect) {
          const float rj = alive_j[j] ? radius_j[j] : nan;
          rtile[r] = rj;
          rmax = fmaxf(rmax, rj);
        }
      }
    }
    __syncwarp();
    float4 t[kBK];
    float nearest[kBK];
    if (count == kTile) {
      accumulate_tile<kBK, true, true, kDetect>(tile, kTile, pi, eps2, t, nearest);
    } else {
      accumulate_tile<kBK, true, true, kDetect>(tile, count, pi, eps2, t, nearest);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      s[k].x += t[k].x;
      s[k].y += t[k].y;
      s[k].z += t[k].z;
      s[k].w += t[k].w;
    }
    if (kDetect) {
      // the prefilter of B2: a row's nearest r2 in the tile against the
      // tile's largest radius, then the exact count of the tile
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      bool maybe = false;
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float rsum = (ri[k] + rmax) * 1.00001f;
        maybe = maybe || nearest[k] <= rsum * rsum;
      }
      if (__any_sync(0xffffffffu, maybe))
        count_tile_ids<kBK>(tile, rtile, count, pi, ri, base + lane - j0 - diag, touch);
    }
    __syncwarp();
  }
  // the kBQ warps' sums of each row, added in warp order
#pragma unroll
  for (int k = 0; k < kBK; ++k) tile[lane + 32 * k] = s[k];
  __syncthreads();
  for (int r = threadIdx.x; r < kBRows && base + r < n_i; r += kBThreads) {
    float4 a = slots[0][r];
    for (int q = 1; q < kBQ; ++q) {
      const float4 b = slots[q][r];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    if (splits == 1) {
      out[base + r] = make_float4(G * a.x, G * a.y, G * a.z, a.w);
    } else {
      part[static_cast<size_t>(split) * n_i + base + r] = a;
    }
  }
  if (kDetect) {
    // rows past n counted against the zero-padded pi: drop them, then one
    // warp reduction, one shared slot per warp, one atomic per block
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kBK; ++k) mine += base + lane + 32 * k < n_i ? touch[k] : 0;
    mine = __reduce_add_sync(0xffffffffu, mine);
    if (lane == 0) warp_sums[warp] = mine;
    __syncthreads();
    if (threadIdx.x == 0) {
      int block_sum = 0;
      for (int w = 0; w < kBQ; ++w) block_sum += warp_sums[w];
      unsigned int* tally = done + tiles;
      if (block_sum) atomicAdd(tally, static_cast<unsigned>(block_sum));
      __threadfence();
      if (atomicAdd(tally + 1, 1u) == gridDim.x - 1) {
        *contacts = static_cast<int>(atomicExch(tally, 0u));
        tally[1] = 0u;
      }
    }
  }
  if (splits == 1) return;
  // the last split of this i tile to finish adds the splits in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&done[tile_i], 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r = threadIdx.x; r < kBRows && base + r < n_i; r += kBThreads) {
    float4 a = __ldcg(part + base + r);
    for (int q = 1; q < splits; ++q) {
      const float4 b = __ldcg(part + static_cast<size_t>(q) * n_i + base + r);
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    out[base + r] = make_float4(G * a.x, G * a.y, G * a.z, a.w);
  }
  if (threadIdx.x == 0) done[tile_i] = 0u;
}

// The co-resident blocks of block_forces_kernel<kDetect> on a device and its
// SM count, asked once a device.
template <bool kDetect>
void block_residency(int device, int* resident, int* sms) {
  static int cache[64][2] = {{0, 0}};
  const int d = device >= 0 && device < 64 ? device : 0;
  if (cache[d][0] == 0) {
    int per_sm = 0, count = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_forces_kernel<kDetect>,
                                                  kBThreads, 0);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    cache[d][1] = count > 0 ? count : 1;
    cache[d][0] = per_sm * count > 0 ? per_sm * count : 1;
  }
  *resident = cache[d][0];
  *sms = cache[d][1];
}

template <bool kDetect>
int launch_block(const void* pos_i, const void* radius_i, const void* alive_i, int n_i,
                 int i_off, const void* pos_j, const void* mass_j, const void* radius_j,
                 const void* alive_j, int n_j, int j_off, float G, float eps2, int splits,
                 int split_len, void* part, void* done, void* out, void* contacts,
                 void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!(eps2 > 0.0f)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_i <= 0 || n_j <= 0)  // no pairs: a count of 0
    return kDetect ? cudaMemsetAsync(contacts, 0, sizeof(int), s) : cudaSuccess;
  // the plan must cover [0, n_j) once: splits of split_len, whole tiles
  if (splits < 1 || split_len < 1 || split_len % kTile != 0 ||
      static_cast<long long>(splits) * split_len < n_j ||
      static_cast<long long>(splits - 1) * split_len >= n_j)
    return cudaErrorInvalidValue;
  const int tiles = (n_i + kBRows - 1) / kBRows;
  block_forces_kernel<kDetect><<<tiles * splits, kBThreads, 0, s>>>(
      static_cast<const float*>(pos_i), n_i, static_cast<const float*>(pos_j),
      static_cast<const float*>(mass_j), n_j, static_cast<const float*>(radius_i),
      static_cast<const unsigned char*>(alive_i), static_cast<const float*>(radius_j),
      static_cast<const unsigned char*>(alive_j), j_off - i_off, G, eps2, tiles, splits,
      split_len, static_cast<float4*>(part), static_cast<unsigned int*>(done),
      static_cast<float4*>(out), static_cast<int*>(contacts));
  return cudaGetLastError();
}

template <bool kDetect>
void dispatch(const float4* p, const float* radius, int n, float G, float eps2,
              int with_pe, float4* o, int* contacts, cudaStream_t s) {
  const float* r = radius;
  if (eps2 > 0.0f) {
    if (with_pe) launch<true, true, kDetect>(p, n, r, G, eps2, o, contacts, s);
    else launch<false, true, kDetect>(p, n, r, G, eps2, o, contacts, s);
  } else {
    if (with_pe) launch<true, false, kDetect>(p, n, r, G, eps2, o, contacts, s);
    else launch<false, false, kDetect>(p, n, r, G, eps2, o, contacts, s);
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

// B3: pos_i [n_i, 3], pos_j [n_j, 3] and mass_j [n_j] float, contiguous;
// out: [n_i] float4 (G*ax, G*ay, G*az, pe) with the pe row's i == j term
// kept. The launch plan (splits, split_len: ops/cuda_forces.py::block_plan)
// cuts the j range; part: [splits * n_i] float4 scratch (unused
// with one split) and done: [ceil(n_i / rows) + 2] unsigned int counters,
// 0 on entry and left 0. Needs eps2 > 0 (the mask-free sweep), as the ring
// does.
int nbody_block_forces(const void* pos_i, int n_i, const void* pos_j, const void* mass_j,
                       int n_j, float G, float eps2, int splits, int split_len, void* part,
                       void* done, void* out, void* stream, int device) {
  return launch_block<false>(pos_i, nullptr, nullptr, n_i, 0, pos_j, mass_j, nullptr,
                             nullptr, n_j, 0, G, eps2, splits, split_len, part, done, out,
                             nullptr, stream, device);
}

// B3 with detection: nbody_block_forces plus radius_i [n_i] and radius_j
// [n_j] float and alive_i [n_i] and alive_j [n_j] bool (one byte), the
// blocks' global offsets i_off and j_off, and contacts: one int32 on the
// device, to which the kernel writes the directed touching-pair count of
// live pairs with different global ids. The force
// output is bit-equal to nbody_block_forces' on the same tables and plan.
int nbody_block_forces_detect(const void* pos_i, const void* radius_i, const void* alive_i,
                              int n_i, int i_off, const void* pos_j, const void* mass_j,
                              const void* radius_j, const void* alive_j, int n_j, int j_off,
                              float G, float eps2, int splits, int split_len, void* part,
                              void* done, void* out, void* contacts, void* stream,
                              int device) {
  return launch_block<true>(pos_i, radius_i, alive_i, n_i, i_off, pos_j, mass_j, radius_j,
                            alive_j, n_j, j_off, G, eps2, splits, split_len, part, done, out,
                            contacts, stream, device);
}

// The block kernel's shape on a device: shape[0..5] = i bodies a thread,
// warps a block, j bodies a tile, threads a block, co-resident blocks (of
// the detecting instance, the fewer) and SMs.
void nbody_block_shape(int device, int* shape) {
  cudaSetDevice(device);
  int resident = 0, sms = 0, resident_b3 = 0;
  block_residency<true>(device, &resident, &sms);
  block_residency<false>(device, &resident_b3, &sms);
  shape[0] = kBK;
  shape[1] = kBQ;
  shape[2] = kTile;
  shape[3] = kBThreads;
  shape[4] = resident < resident_b3 ? resident : resident_b3;
  shape[5] = sms;
}

// The launch shape at n i rows: shape[0..4] = i bodies a thread, warps (j
// slices) a block, j bodies a tile, threads a block, blocks.
void nbody_forces_shape(int n, int* shape) {
  shape[0] = kK;
  shape[1] = kQ;
  shape[2] = kTile;
  shape[3] = kThreads;
  shape[4] = (n + kRows - 1) / kRows;
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
