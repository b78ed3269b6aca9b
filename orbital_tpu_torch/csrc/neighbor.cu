// Switched near-field sweep of the multirate (RESPA) stepper for Hopper
// (sm_90a).
//
// Replaces: orbital_tpu/ops/neighbor_pallas.py, whose four TPU kernels are
// four schedules of one computation: _kernel (B8, streaming padded grid),
// _kernel_wl (B9, compacted worklist), _kernel_sb (B10, per-substep gathered
// superblocks) and _kernel_resident (B11, resident j-table with a per-chunk
// trip count). This one kernel serves all four.
//
// For each i-chunk c of C slot rows, over the j-blocks blocks[off_c + q],
// q < count_c, each block being blkw = RJ*C consecutive rows of the slot
// channels (x, y, z, m), with _pair_terms' arithmetic
// (neighbor_pallas.py:47-69):
//
//   s = clip((rc^2 - r^2) inv_d, 0, 1),   S = s^3 (10 - 15 s + 6 s^2)
//   spd = 30 inv_d s^2 (1 - s)^2,          inv_r = rsqrt(r^2 + eps^2)
//   w = m_j (S inv_r^3 + 2 spd inv_r)
//   out[c*C + i] = (G sum w dx, G sum w dy, G sum w dz,
//                   sum m_j inv_r S - m_i / eps)
//
// The last term takes the self pair off pe here, once: the kernel does not
// mask i == j (dx = dy = dz = 0 adds no force, and m_i inv_eps S(0) = m_i /
// eps to pe), and the wrappers subtract nothing more. A chunk with count 0
// sums nothing, so its live rows get (0, 0, 0, -m_i / eps), as the plain
// sweep gives them. off_c is off[c] with count from count[c] (the worklist,
// B9), or c * stride with count_c the number of entries of row c of the
// padded table jbl [k_ch, stride] that are not the sentinel block (B8, B10,
// B11: its live entries are its prefix).
//
// Which pairs it visits. A pair whose s is 0 adds exactly 0 (S = spd = 0
// and inv_r is finite), so the kernel may skip it, and skips only such
// pairs:
//  * i side: only the chunk's live slots. A sentinel slot (x, y and z at
//    SENTINEL_POS = 1e15, mass 0) is told by its position, >= half of
//    SENTINEL_POS on every axis, and never by its mass: a live body may be
//    massless. It gets (0, 0, 0, 0) written directly, the plain sweep's
//    value for it.
//  * j side: only the staged rows inside the chunk's box, [min - h, max + h]
//    on each axis over the live i rows, with lo rounded down and hi up. The
//    rounding rule: the sweep forms r2e = r^2 + eps^2 (rounded) and s =
//    sat(r2e * neg_inv_d + sc) in one FFMA, sc = (rc^2 + eps^2) inv_d, so
//    s > 0 needs r2e < rc2e = sc / inv_d (of the f32 constants). A row
//    outside the box lies further than h from every live i row on one
//    axis, exactly; the host passes h >= sqrt(rc2e) (1 + 2^-16) (1 -
//    2^-24), so that row's r2e, which is at least (1 - 2^-24)^5 times its
//    exact r^2, is > rc2e: its s is 0 for every i row of the chunk.
//    Sentinel rows, the dead tail of a block and live rows beyond rc all
//    fall outside. The box belongs to the chunk (to its 32-row slice when
//    C > 32), not to the row: the per-pair arithmetic stays whole.
// On the 65,536-body headline geometry (rc = 0.05, chunk 32, rj 4) the
// first version walked 90.9 M pairs (every row of every live entry,
// sentinel rows on either side included); this one visits 6.3 M, for
// 0.05 M that the function needs (chip_smoke.near_work).
//
// What bounds it on this card: the bytes it must move (the slot channels
// once, the table and the output: ~10.6 MB, 0.003 ms) and, above them, the
// latency of each chunk's staging rounds from L2. 28.5 SASS instructions a
// visited pair (3 differences, r2e with eps2 folded (3), s as one
// saturating FFMA, S (5), spd (3), one MUFU.RSQ, the weight (4), four
// multiply-adds, the shared load and the loop) over 6.9 M lane slots put
// its issue floor at 0.006 ms; it takes 0.029 ms of device time (the first
// version 0.136; NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 20 and
// --parent; PERF.md). CUDA events around a call also count the wrapper's
// host time, 0.05-0.06 ms a call, which phase 20 prints.
//
// Design (no float atomics; every sum in a fixed order), on the template of
// tree_near.cu (B7):
//  * One block of kQ warps per 32-row slice of an i-chunk. Every warp finds
//    the slice's live rows (a ballot on the positions) and their box (warp
//    min/max), and puts its lanes on the live rows only: with L live rows,
//    lane (i, g) holds the i-th live row (in table order) and g is one of
//    G = 32 / S groups over the j rows, S the power of two >= L. A chunk of
//    one body uses all 32 lanes, as one of 32.
//  * The warps split the chunk's j walk: each j-block is cut into rounds of
//    32 kK rows, and warp w stages rounds w, w + kQ, ... of the chunk's
//    blocks in order. Each lane loads its kK rows of the round (x, y, z, m
//    through the four channel pointers and one element stride, so a row
//    table [n, 4] is read in place), tests them against the box, and the
//    in-box rows are compacted into the warp's shared buffer in table order
//    by a ballot and a prefix count. Whenever the buffer holds >= G rows,
//    the warp sweeps the largest multiple of G of them (each group a fixed
//    share, summed into fresh partials before the running sums) and carries
//    the rest (< G) to the front.
//  * At the end the groups of each row are added by xor shuffles in a fixed
//    order, then the kQ warps' sums in warp order in shared memory; warp 0
//    writes every slot of the slice.
//  * One MUFU.RSQ a pair (rsqrt.approx.ftz) with eps2 folded into the r^2
//    chain: only live rows reach the sweep, so r2e is finite and >= eps2 >
//    0 (the wrappers require eps2 > 0), never denormal.
// kK and kQ are the OT_NEAR_K and OT_NEAR_Q macros below, which
// chip_smoke.py --sweep sets with -D; its shapes (k 2-8, q 2-8) timed alike
// within their spreads, all under the wrapper's host time.
//
// Plain C interface for ctypes: pointers and the stream are void*, and the
// entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

#ifndef OT_NEAR_K
#define OT_NEAR_K 4
#endif
#ifndef OT_NEAR_Q
#define OT_NEAR_Q 4
#endif

namespace {

constexpr int kK = OT_NEAR_K;          // j rows a lane stages a round
constexpr int kQ = OT_NEAR_Q;          // warps a block, one share of the j walk each
constexpr int kThreads = 32 * kQ;
constexpr int kRound = 32 * kK;        // j rows a warp stages at once
constexpr int kBuf = kRound + 31;      // a round's in-box rows and < 32 carried
constexpr float kHalfSentinel = 5e14f; // half of SENTINEL_POS (ops/neighbor.py)
static_assert(kK >= 1 && kQ >= 1, "bad launch shape");
static_assert(kQ * kBuf * sizeof(float4) + kQ * 32 * (sizeof(float4) + sizeof(int)) <=
                  48 * 1024,
              "static shared memory");

struct Switch {
  float sc;      // rc2e * inv_d, rc2e = rc^2 + eps^2
  float neg_inv_d;
  float c60;     // 2 * 30 * inv_d
  float eps2;
  float G;
  float inv_eps; // eps2^-1/2, the self pair's pe
  float h;       // the box's half-width (see the rounding rule above)
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

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Adds buffered rows 0 .. nb - 1 (x, y, z, m) to the sums of row pi: group
// g of G = 1 << gshift takes rows g, g + G, ..., summed into fresh partials
// first.
__device__ __forceinline__ void sweep_rows(const float4* buf, int nb, int g, int gshift,
                                           float4 pi, const Switch& p, float4& acc) {
  float tx = 0.0f, ty = 0.0f, tz = 0.0f, tp = 0.0f;
  const int n_it = nb > g ? (nb - g + (1 << gshift) - 1) >> gshift : 0;
  const float4* row = buf + g;
  const int step = 1 << gshift;
#pragma unroll 2
  for (int t = 0; t < n_it; ++t, row += step) {
    const float4 pj = *row;
    const float dx = pj.x - pi.x;
    const float dy = pj.y - pi.y;
    const float dz = pj.z - pi.z;
    const float r2e = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, p.eps2)));
    const float s = __saturatef(fmaf(r2e, p.neg_inv_d, p.sc));
    const float s2 = s * s;
    const float S = s * s2 * fmaf(s, fmaf(s, 6.0f, -15.0f), 10.0f);
    const float sq = s - s2;  // s (1 - s)
    const float spd2 = p.c60 * sq * sq;
    const float inv = rsqrt_ftz(r2e);
    const float mi = pj.w * inv;  // m_j / r
    const float w = mi * fmaf(S, inv * inv, spd2);
    tx = fmaf(w, dx, tx);
    ty = fmaf(w, dy, ty);
    tz = fmaf(w, dz, tz);
    tp = fmaf(mi, S, tp);
  }
  acc.x += tx;
  acc.y += ty;
  acc.z += tz;
  acc.w += tp;
}

// The second bound (one block an SM) lets ptxas use the registers the
// staging needs, as B7's does.
__global__ void __launch_bounds__(kThreads, 1)
near_sweep_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                  const float* __restrict__ zs, const float* __restrict__ ms, long long cs,
                  const int* __restrict__ blocks, const int* __restrict__ off, int stride,
                  const int* __restrict__ count, int sentinel, int chunk, int slices,
                  int blkw, int i0, Switch p, float4* __restrict__ out) {
  __shared__ float4 bufs[kQ][kBuf];  // in-box j rows (x, y, z, m)
  __shared__ float4 red[kQ][32];     // each warp's sums of the live i rows
  __shared__ int order[kQ][32];      // the slice's live rows, in table order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int c = blockIdx.x / slices;
  const int row0 = blockIdx.x % slices * 32;
  const int nrows = min(32, chunk - row0);
  // the i rows are chunk i0 + c's slots; the output row is chunk c's
  const size_t row = static_cast<size_t>(c) * chunk + row0 + lane;
  const size_t slot = static_cast<size_t>(i0) * chunk + row;

  // the chunk's entries: count[c] from off[c] (worklist), or the
  // non-sentinel entries of row c of the padded table
  int base, n_q;
  if (off) {
    base = off[c];
    n_q = count[c];
  } else {
    base = c * stride;
    n_q = 0;
    for (int k = lane; k - lane < stride; k += 32) {
      const bool used = k < stride && blocks[base + k] != sentinel;
      n_q += __popc(__ballot_sync(0xffffffffu, used));
    }
  }

  // the slice's rows, its live rows and their box
  float4 mine = make_float4(2.0f * kHalfSentinel, 2.0f * kHalfSentinel,
                            2.0f * kHalfSentinel, 0.0f);
  if (lane < nrows) {
    const size_t e = slot * cs;
    mine = make_float4(xs[e], ys[e], zs[e], ms[e]);
  }
  const bool live = lane < nrows && !(mine.x >= kHalfSentinel && mine.y >= kHalfSentinel &&
                                      mine.z >= kHalfSentinel);
  const unsigned lmask = __ballot_sync(0xffffffffu, live);
  const int L = __popc(lmask);
  if (L == 0 || n_q == 0) {
    // nothing to sum: a live row keeps only the self term off its pe
    if (warp == 0 && lane < nrows) {
      out[row] = make_float4(0.0f, 0.0f, 0.0f,
                             live ? __fsub_rn(0.0f, __fmul_rn(mine.w, p.inv_eps)) : 0.0f);
    }
    return;
  }
  const float big = 2.0f * kHalfSentinel;
  const float lo_x = __fsub_rd(warp_min(live ? mine.x : big), p.h);
  const float lo_y = __fsub_rd(warp_min(live ? mine.y : big), p.h);
  const float lo_z = __fsub_rd(warp_min(live ? mine.z : big), p.h);
  const float hi_x = __fadd_ru(warp_max(live ? mine.x : -big), p.h);
  const float hi_y = __fadd_ru(warp_max(live ? mine.y : -big), p.h);
  const float hi_z = __fadd_ru(warp_max(live ? mine.z : -big), p.h);
  if (live) order[warp][__popc(lmask & below)] = lane;
  __syncwarp();

  // lane (i, g): the i-th live row, group g of G = 32 / S over the j rows
  int sshift = 0;
  while ((1 << sshift) < L) ++sshift;
  const int gshift = 5 - sshift;
  const int G = 1 << gshift;
  const int i = lane & ((1 << sshift) - 1);
  const int g = lane >> sshift;
  const int src_i = order[warp][i < L ? i : 0];
  const float4 pi = make_float4(__shfl_sync(0xffffffffu, mine.x, src_i),
                                __shfl_sync(0xffffffffu, mine.y, src_i),
                                __shfl_sync(0xffffffffu, mine.z, src_i), 0.0f);
  float4* const buf = bufs[warp];

  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // the row's running sums
  int fill = 0;                                    // rows in the warp's buffer
  const int rpe = (blkw + kRound - 1) / kRound;    // rounds a j-block
  const int rounds = n_q * rpe;
  for (int t = warp; t < rounds; t += kQ) {
    const int q = rpe == 1 ? t : t / rpe;
    const int sub = rpe == 1 ? 0 : t - q * rpe;
    const int b = blocks[base + q];
    const int a = b * blkw + sub * kRound;              // the round's first row
    const int e = min(kRound, blkw - sub * kRound);     // its rows
    float4 pj[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int r = 32 * k + lane;
      if (r < e) {
        const size_t at = static_cast<size_t>(a + r) * cs;
        pj[k] = make_float4(xs[at], ys[at], zs[at], ms[at]);
      } else {
        pj[k] = make_float4(big, big, big, 0.0f);
      }
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const bool in = pj[k].x >= lo_x && pj[k].x <= hi_x && pj[k].y >= lo_y &&
                      pj[k].y <= hi_y && pj[k].z >= lo_z && pj[k].z <= hi_z;
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (in) buf[fill + __popc(m & below)] = pj[k];
      fill += __popc(m);
    }
    if (fill >= G) {
      __syncwarp();
      const int nb = fill & ~(G - 1);
      sweep_rows(buf, nb, g, gshift, pi, p, s);
      // carry the rows past nb (fewer than G <= 32) to the front
      const int rest = fill - nb;
      float4 cp;
      if (lane < rest) cp = buf[nb + lane];
      __syncwarp();
      if (lane < rest) buf[lane] = cp;
      __syncwarp();
      fill = rest;
    }
  }
  __syncwarp();
  if (fill > 0) sweep_rows(buf, fill, g, gshift, pi, p, s);

  // the G groups of each row, then the kQ warps, each in a fixed order
  for (int o = 1 << sshift; o < 32; o <<= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
    s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
    s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
  }
  if (g == 0 && i < L) red[warp][i] = s;
  __syncthreads();
  if (warp == 0 && lane < nrows) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (live) {
      const int rank = __popc(lmask & below);
      float4 t = red[0][rank];
      for (int w = 1; w < kQ; ++w) {
        const float4 u = red[w][rank];
        t.x += u.x;
        t.y += u.y;
        t.z += u.z;
        t.w += u.w;
      }
      v = make_float4(p.G * t.x, p.G * t.y, p.G * t.z,
                      __fsub_rn(t.w, __fmul_rn(mine.w, p.inv_eps)));
    }
    out[row] = v;
  }
}

}  // namespace

extern "C" {

// xs, ys, zs, ms: the slot channels [n_slots], element i at ptr[i * cs];
// blocks: int32 j-block indices; off: [k_ch] int32 first entry of each
// chunk's list with count: [k_ch] int32 entries to walk (the worklist), or
// both null for the padded table blocks [k_ch, stride], whose entries other
// than `sentinel` are walked; out: [k_ch * chunk] float4 (G ax, G ay, G az,
// pe without the self pair). sc = (rc^2 + eps2) inv_d, neg_inv_d = -inv_d,
// c60 = 60 inv_d with inv_d = 1 / (rc^2 - r1^2); inv_eps = eps2^-1/2; h the
// box's half-width (see the note at the top).
int near_sweep_rows(const void* xs, const void* ys, const void* zs, const void* ms,
                    long long cs, const void* blocks, const void* off, int stride,
                    const void* count, int sentinel, int i0, int k_ch, int chunk, int blkw,
                    float sc, float neg_inv_d, float c60, float eps2, float G, float inv_eps,
                    float h, void* out, void* stream, int device);

int near_sweep(const void* xs, const void* ys, const void* zs, const void* ms, long long cs,
               const void* blocks, const void* off, int stride, const void* count,
               int sentinel, int k_ch, int chunk, int blkw, float sc, float neg_inv_d,
               float c60, float eps2, float G, float inv_eps, float h, void* out,
               void* stream, int device) {
  return near_sweep_rows(xs, ys, zs, ms, cs, blocks, off, stride, count, sentinel, 0, k_ch,
                         chunk, blkw, sc, neg_inv_d, c60, eps2, G, inv_eps, h, out, stream,
                         device);
}

// The sweep of the i chunks [i0, i0 + k_ch) only (the mesh-sharded RESPA:
// orbital_tpu/ops/neighbor.py:238-314, near_acc_slots(i0=)): `blocks`,
// `off` and `count` are those chunks' rows, the j side is the whole slot
// table, and out holds [k_ch * chunk] rows, chunk i0 + c's at c. The
// sharded stepper passes the rank's rows of the int32 table, a contiguous
// view that ops/cuda_neighbor.py hands on in place (no copy). Each chunk's rows are summed exactly as the whole sweep sums them:
// a rank's rows are the whole sweep's bits. On the RESPA row at 4 ranks
// (65,536 bodies, 9,648 chunks) rank 0's 2,412 chunks hold 57% of the
// table's entries and take 0.019 ms of device time against the whole
// sweep's 0.029; ranks 2 and 3 hold no live chunk and take 0.004, each
// block returning after its prologue. A call is host-bound: its wrapper's
// host time (0.03-0.09 ms, as the host's load goes) is above the device
// time (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 64; PERF.md).
int near_sweep_rows(const void* xs, const void* ys, const void* zs, const void* ms,
                    long long cs, const void* blocks, const void* off, int stride,
                    const void* count, int sentinel, int i0, int k_ch, int chunk, int blkw,
                    float sc, float neg_inv_d, float c60, float eps2, float G, float inv_eps,
                    float h, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k_ch <= 0) return cudaSuccess;
  if (chunk <= 0 || blkw <= 0 || i0 < 0 || !(eps2 > 0.0f) ||
      (off == nullptr) != (count == nullptr))
    return cudaErrorInvalidValue;
  const int slices = (chunk + 31) / 32;
  near_sweep_kernel<<<k_ch * slices, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const float*>(zs), static_cast<const float*>(ms), cs,
      static_cast<const int*>(blocks), static_cast<const int*>(off), stride,
      static_cast<const int*>(count), sentinel, chunk, slices, blkw, i0,
      Switch{sc, neg_inv_d, c60, eps2, G, inv_eps, h}, static_cast<float4*>(out));
  return cudaGetLastError();
}

// The launch shape for n 32-row chunk slices (k_ch of them at chunk <= 32):
// shape[0..4] = j rows a lane stages a round, warps a block, j rows a warp
// stages a round, threads a block, blocks.
void near_sweep_shape(int n, int* shape) {
  shape[0] = kK;
  shape[1] = kQ;
  shape[2] = kRound;
  shape[3] = kThreads;
  shape[4] = n;
}

const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
