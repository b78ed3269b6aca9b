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
// Separate i and j tables (B3): the i side reads (x, y, z) of pts_i, the j
// side (x, y, z, m) of pts_j. B1 and B2 pass one table twice, so their
// arithmetic is unchanged op for op; B3 keeps the PE sum on and subtracts
// nothing (its pe row includes the i == j term where the tables coincide;
// the ring strips it once). B2's kDetect reads one radius table for both
// sides and is launched on coinciding tables only.
//
// B3's detecting instance (kBlock, with kDetect; no TPU kernel: it stands
// in for the sqrt-free count ring of orbital_tpu/parallel/sharded.py:199-231,
// whose block is ops/collisions.py:97-113 _contacts_block): the same sweep
// over separate i and j tables with a radius table for each side and the
// blocks' global offsets, so that the ring's closing force evaluation also
// counts the step's contacts. Its force arithmetic is B3's op for op. The
// count is exact by construction: a pair is counted when r2 <= ((R_i + R_j)
// * 1.00001)^2 and the global ids differ (self pairs are excluded by index,
// not counted and subtracted), and a dead body carries a NaN radius, for
// which every comparison is false, so alive is tested on both sides
// without a table of its own. The counter starts at 0.
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

namespace {

constexpr int kK = OT_FORCES_K;          // i bodies a thread
constexpr int kQ = OT_FORCES_Q;          // warps a block, one j slice each
constexpr int kTile = 128;               // j bodies a warp's tile
constexpr int kThreads = 32 * kQ;
constexpr int kRows = 32 * kK;           // i bodies a block
// a warp's shared slot: its tile during the sweep, its sums after it
constexpr int kSlot = kTile > kRows ? kTile : kRows;
static_assert(kK >= 1 && kQ >= 1 && kTile % 32 == 0, "bad launch shape");

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
template <bool kPE, bool kSoft, bool kDetect>
__device__ __forceinline__ void accumulate_tile(const float4* tile, int count,
                                                const float4 (&pi)[kK], float eps2,
                                                float4 (&t)[kK], float (&nearest)[kK]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    t[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    nearest[k] = __int_as_float(0x7f800000);  // +inf
  }
#pragma unroll 4
  for (int jj = 0; jj < count; ++jj) {
    const float4 pj = tile[jj];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
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

// count_tile over separate tables (kBlock): row k of the thread and column
// jj of the tile have equal global ids when i0 + 32 k == jj, i0 being the
// thread's first row, minus the tile's first column, minus the blocks'
// offset difference; such a pair is skipped. Alive is in the radii (NaN
// when dead).
__device__ __forceinline__ void count_tile_ids(const float4* tile, const float* rtile,
                                               int count, const float4 (&pi)[kK],
                                               const float (&ri)[kK], int i0,
                                               int (&touch)[kK]) {
  for (int jj = 0; jj < count; ++jj) {
    const float4 pj = tile[jj];
    const float rj = rtile[jj];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float r2 = dist2(pj.x - pi[k].x, pj.y - pi[k].y, pj.z - pi[k].z);
      const float rsum = (ri[k] + rj) * 1.00001f;
      touch[k] += (r2 <= rsum * rsum) && (i0 + 32 * k != jj);
    }
  }
}

// The second bound (one block an SM) lets ptxas use up to 128 registers a
// thread. Without it ptxas aims at two blocks an SM and caps the kernel at 64
// registers. That ran B1 4% and B2 18% slower (chip_smoke.py; PERF.md).
// kBlock (with kDetect): radius_i and radius_j are separate tables and a
// pair (i, j) with i == j + diag (equal global ids) is not counted.
template <bool kPE, bool kSoft, bool kDetect, bool kBlock>
__global__ void __launch_bounds__(kThreads, 1)
nbody_forces_kernel(const float4* __restrict__ pts_i, int n_i,
                    const float4* __restrict__ pts_j, int n_j,
                    const float* __restrict__ radius_i,
                    const float* __restrict__ radius_j, int diag, float G, float eps2,
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
      accumulate_tile<kPE, kSoft, kDetect>(tile, kTile, pi, eps2, t, nearest);
    } else {
      accumulate_tile<kPE, kSoft, kDetect>(tile, count, pi, eps2, t, nearest);
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
      if (__any_sync(0xffffffffu, maybe)) {
        if (kBlock) {
          count_tile_ids(tile, rtile, count, pi, ri, base + lane - j0 - diag, touch);
        } else {
          count_tile(tile, rtile, count, pi, ri, touch);
        }
      }
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

template <bool kPE, bool kSoft, bool kDetect, bool kBlock = false>
void launch(const float4* pts_i, int n_i, const float4* pts_j, int n_j,
            const float* radius_i, const float* radius_j, int diag, float G, float eps2,
            float4* out, int* contacts, cudaStream_t stream) {
  const int grid = (n_i + kRows - 1) / kRows;
  nbody_forces_kernel<kPE, kSoft, kDetect, kBlock><<<grid, kThreads, 0, stream>>>(
      pts_i, n_i, pts_j, n_j, radius_i, radius_j, diag, G, eps2, out, contacts);
}

template <bool kDetect>
void dispatch(const float4* p, const float* radius, int n, float G, float eps2,
              int with_pe, float4* o, int* contacts, cudaStream_t s) {
  const float* r = radius;
  if (eps2 > 0.0f) {
    if (with_pe) launch<true, true, kDetect>(p, n, p, n, r, r, 0, G, eps2, o, contacts, s);
    else launch<false, true, kDetect>(p, n, p, n, r, r, 0, G, eps2, o, contacts, s);
  } else {
    if (with_pe) launch<true, false, kDetect>(p, n, p, n, r, r, 0, G, eps2, o, contacts, s);
    else launch<false, false, kDetect>(p, n, p, n, r, r, 0, G, eps2, o, contacts, s);
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
                            static_cast<const float4*>(pts_j), n_j, nullptr, nullptr, 0, G,
                            eps2, static_cast<float4*>(out), nullptr,
                            static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// B3 with detection (kBlock): nbody_block_forces plus radius_i [n_i] and
// radius_j [n_j] float (R, or NaN for a dead body), the blocks' global
// offsets i_off and j_off, and contacts: one int32 on the device, which the
// caller sets to 0; the kernel adds the directed touching-pair count of
// live pairs with different global ids. The force output is bit-equal to
// nbody_block_forces' on the same tables.
int nbody_block_forces_detect(const void* pts_i, const void* radius_i, int n_i, int i_off,
                              const void* pts_j, const void* radius_j, int n_j, int j_off,
                              float G, float eps2, void* out, void* contacts, void* stream,
                              int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!(eps2 > 0.0f)) return cudaErrorInvalidValue;
  if (n_i <= 0 || n_j <= 0) return cudaSuccess;
  launch<true, true, true, true>(static_cast<const float4*>(pts_i), n_i,
                                 static_cast<const float4*>(pts_j), n_j,
                                 static_cast<const float*>(radius_i),
                                 static_cast<const float*>(radius_j), j_off - i_off, G, eps2,
                                 static_cast<float4*>(out), static_cast<int*>(contacts),
                                 static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
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
