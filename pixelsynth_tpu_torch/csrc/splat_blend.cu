// K2: the soft z-buffer splat blend, for Hopper (sm_90a).
//
// Replaces the TPU kernel pixelsynth_tpu/ops/splat_pallas.py _blend_kernel
// (:40), which computes the same function as the XLA blend
// pixelsynth_tpu/ops/splat.py _blend_tiles (:395).  Binning (one stable
// sort of packed keys, searchsorted offsets, fixed-capacity slot tables)
// stays outside; this kernel reads the binner's tables as they are: the
// z-sorted point index of every (image, tile, slot) and its valid flag.
//
// Function.  Per pixel, front to back over its tile's slots: a slot covers
// the pixel when its point lies within the radius; a covered slot is kept
// iff the inclusive count of covered slots (kept or not) is <= pp_pixel;
// alpha = (1 - sqrt(clip(d, 1e-3, 1)))^tau; alphacomposite / wsum /
// wsumnorm accumulate the features; the coverage map is "any slot covers".
// The TPU kernel turns the front-to-back prefix into a triangular-matrix
// product because the MXU is its fast path; with C = 3 features the blend
// is no matrix product on this card, so it runs as _blend_tiles' cumsum /
// cumprod taken sequentially, a thread a pixel.
//
// C <= 8 (every RGB path): the body below, a thread a pixel, each slot's
// weight multiplied into C accumulators as it is walked.
//
// Design.  One block a 16x16 tile (TS x TS, TS a multiple of 8 up to 32).
//   * the gather is inside: the block walks the tile's valid slots in
//     chunks of CH, and each chunk's points (x, y) and features are
//     gathered from the (B, N, .) arrays (L2-resident) into shared memory
//     by one thread a slot, double-buffered: while the warps blend chunk
//     k, chunk k + 1's points and chunk k + 2's slot indices are in flight
//     (an index is loaded a chunk before the point it names, so no load
//     waits on another), one __syncthreads a chunk;
//   * the walk stops at the tile's count of valid slots, taken once (valid
//     slots form a prefix of each list; an invalid slot inside the count is
//     pushed out of every pixel's radius, as before);
//   * warp culling: a warp owns a 4 x 8 pixel rectangle.  For each 32
//     staged slots each lane tests one slot's disc against the rectangle
//     -- conservatively: the distance from the point to the rectangle,
//     squared, is held to r^2 with a relative margin of 1e-6 (its rounding
//     may differ from a pixel's by an ulp or two), so a slot that covers
//     any pixel of the rectangle is never dropped -- and a ballot leaves
//     the warp the slots to walk, in ascending z order.  A dropped slot
//     covers none of the warp's pixels, and an uncovered slot changes
//     nothing a pixel carries, so every pixel performs the same
//     floating-point operations in the same order as a walk over every
//     slot: output and coverage are bit-identical to it.  A radius-4 disc
//     reaches ~30% of the slots of a tile's list.
//
// Bound on this card (W=256, 2 images x 131072 points, C=3, M=1024): the
// bytes the function must move (the valid flags, each valid slot's index,
// the points and features, the image and coverage out: ~12 MB, ~3.7 us at
// 3.35 TB/s) against the covered pixel x slot pairs (~9% of the pixel x
// valid-slot pairs) at ~21 fp32 flops each (chip_smoke.py counts both on
// its inputs).
//
// bf16 features (`splat.blend_dtype="bfloat16"`, the XLA blend's
// `w.astype(feats.dtype) @ feats` with an f32 accumulator, splat.py
// :438-441,480-481): the second entry, `splat_blend_bf16`, reads bf16
// feature rows and widens them to f32 as they are staged (16-byte loads of
// a group's 8 channels where a row is a multiple of 16 bytes, as at C = 64;
// 2-byte loads otherwise, as at C = 3, whose 6-byte rows sit at any even
// address), and rounds each slot's weight to bf16 (round to nearest even)
// before its multiply-add.  A bf16 x bf16 product is exact in f32, so the
// sums are the function's f32 sums.  Alpha, transmittance and coverage are
// the f32 body's, so the coverage is bit-equal to the f32 entry's.  A
// weight within an f32 ulp of a bf16 rounding boundary rounds the other way
// wherever the weight's f32 value differs by an ulp, so both entries round
// the distance as the plain version does (no contraction into an FMA), and
// alpha takes the NDC scale folded into one multiply, which is exact where
// W and the radius are powers of two (the default sizes).  Under
// wsumnorm the XLA blend rounds alpha / max(sum alpha, 1e-4), which needs
// the pixel's whole sum before its first weight: the bf16 entry walks the
// slots twice, the first walk summing the kept alphas (the f32 entry
// normalises once at the end instead).  That sum is taken in f64 and
// rounded once to f32, as the plain version takes it: an f32 sum in
// another order moves the denominator by an ulp, which rounds about one
// weight in 30000 to the other bf16 neighbour.

// C > 8 (the encoder's 64-wide features; any width): one walk a tile and
// the product on the tensor cores, after the TPU kernel's own formulation
// (splat_pallas.py:40-111: a chunk's weights once, then one (pixels x
// chunk) @ (chunk x C) product, :98).  `blend_wide_kernel`:
//   * one block a tile and every channel (up to 64; above that a block
//     takes 64 channels, its own walk): the grid is B * nT blocks, with a
//     second dimension only where a tile has more than 8 of the warps' 4 x
//     8 rectangles (tile_size 24, 32) or C > 64;
//   * the walk runs once: the same culling ballot, r2_cull margin, z order
//     and per-slot serial step as the C <= 8 body (distance rounded
//     unfused, coverage, the inclusive count against pp_pixel, alpha, the
//     transmittance), but the step yields the slot's weight (alpha * trans,
//     or alpha; 0 where the slot does not cover the pixel or is past the
//     cap; the bf16 entry's rounded to bf16) and each lane stores it into
//     its warp's weight tile in shared memory: 16 culled slots x 32
//     pixels, stored slot-major so that the 32 lanes' stores are one row
//     (the distances and alphas of four culled slots are taken together,
//     two for f32 at 64 channels);
//   * each full tile of 16 culled slots, and a chunk's last (zero weights
//     pad it), is one product on mma.sync: two m16 halves of the warp's 32
//     pixels x ceil(C / 8) n8 tiles (C = 9 pads to 16), f32 accumulators
//     in registers (64 a lane at C = 64).  The B operand is the culled
//     slots' feature rows of the staged chunk, one row address a lane, so
//     no compaction copy is made;
//       - bf16 entry: m16n8k16 bf16, A and B by ldmatrix.trans.  A bf16 x
//         bf16 product is exact in f32: only the order of the f32 sums
//         differs from the plain version;
//       - f32 entry: m16n8k8 tf32 on the three-product split (x = hi + lo,
//         each rounded to tf32 by cvt.rna; lo*hi + hi*lo + hi*hi, the
//         lo*lo term dropped): ~2^-21 of each product, where tf32 alone
//         keeps ~3 digits;
//   * wsumnorm: the f32 entry normalises at the end, each pixel's mass
//     reaching the lanes that hold its accumulator fragments by shuffles;
//     the bf16 entry keeps its two walks (the f64 mass sum first);
//   * staging: CH_WIDE = 128 slots a chunk, double-buffered by index a
//     chunk ahead as in the C <= 8 body; each valid slot's point and its
//     feature row (all of the block's channels) go to shared memory by
//     cp.async, 16-byte copies where rows are 16-byte aligned (C = 64),
//     else 4-byte ones (bf16 rows of odd C: 2-byte loads and stores).
// Coverage is written once a pixel.  The product is not what binds: at C
// = 64 the padded product over the culled slots is a few GFLOP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CH = 256;   // slots a chunk
constexpr int MAXC = 8;
constexpr int RW = 8;     // a warp's rectangle: RH rows x RW columns
constexpr int RH = 4;
constexpr int WALK = 2;   // slots of a warp's walk taken together (1 and 4 ran slower)

enum Accum { ALPHACOMPOSITE = 0, WSUM = 1, WSUMNORM = 2 };

struct Params {
  int N, nT, nside, M, C, TS, W;
  float r2;        // radius^2 in pixels^2
  float r2_cull;   // r2 with the culling test's margin
  float dscale;    // (2/W)^2 / (radius * 2/W)^rad_pow
  float tau;
  int pp_pixel;
  int accum;
  int vec;         // C <= 8: bf16 rows of 8 channels as one 16-byte load; C > 8:
                   // the staging copies' bytes (16, 4, or 2 for plain loads)
  int rgroups;     // C > 8: blocks a tile's rectangles take (8 warps a block)
};

// a slot's C (<= MAXC) channels, as f32
__device__ __forceinline__ void load_row(const float* fb, long long li, int C, int,
                                         float* lf) {
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) lf[c] = fb[li * C + c];
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* fb, long long li, int C,
                                         int vec, float* lf) {
  const __nv_bfloat16* row = fb + li * C;
  if (vec) {   // C == 8 and a 16-byte aligned base
    const uint4 v = *reinterpret_cast<const uint4*>(row);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < MAXC / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      lf[2 * i] = f.x;
      lf[2 * i + 1] = f.y;
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) lf[c] = __bfloat162float(row[c]);
}

template <typename T>
__global__ void __launch_bounds__(1024)
blend_kernel(const float* __restrict__ pts,        // (B, N, 3)
             const T* __restrict__ feats,          // (B, N, C) f32 or bf16
             const long long* __restrict__ slot,   // (B, nT, M) point index
             const uint8_t* __restrict__ valid,    // (B, nT, M)
             float* __restrict__ out,              // (B, W, W, C)
             uint8_t* __restrict__ cov,            // (B, W, W)
             Params P) {
  __shared__ float2 sxy[2][CH];            // a slot's point (x, y)
  __shared__ float4 sf[2][CH][MAXC / 4];    // and its features
  __shared__ int s_count;

  const int bt = blockIdx.x;              // image * nT + tile
  const int b = bt / P.nT;
  const int t = bt - b * P.nT;
  const int C = P.C;                      // <= MAXC
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rects = P.TS / RW;            // rectangles across a tile row
  const int pr = (warp / rects) * RH + lane / RW;   // the lane's pixel in the tile
  const int pc = (warp % rects) * RW + lane % RW;
  const int row0 = (t / P.nside) * P.TS;
  const int col0 = (t % P.nside) * P.TS;
  const float row = (float)row0 + (float)pr;
  const float col = (float)col0 + (float)pc;
  // the warp's rectangle of pixel centres
  const float r_lo = (float)(row0 + (warp / rects) * RH), r_hi = r_lo + (RH - 1);
  const float c_lo = (float)(col0 + (warp % rects) * RW), c_hi = c_lo + (RW - 1);

  // the count of valid slots: one past the last valid one
  const size_t base = (size_t)bt * P.M;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  {
    int last = 0;
    for (int j = threadIdx.x; j < P.M; j += blockDim.x)
      if (valid[base + j]) last = j + 1;
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0 && last > 0) atomicMax(&s_count, last);
  }
  __syncthreads();
  const int n = s_count;

  // the loader's slot of a chunk: thread j < CH loads slot j0 + j
  const int ch = blockDim.x < CH ? blockDim.x : CH;
  const bool loader = threadIdx.x < ch;
  const float* pb = pts + (size_t)b * P.N * 3;
  const T* fb = feats + (size_t)b * P.N * C;
  constexpr bool BF16 = sizeof(T) == 2;
  long long li = 0;   // the next chunk's point index and valid flag
  bool lv = false;
  float lx, ly, lf[MAXC];   // the next chunk's slot of this thread
  auto fetch_index = [&](int j0) {   // the two loads do not wait on each other
    const int j = j0 + threadIdx.x;
    const bool in = loader && j < n;
    lv = in && valid[base + j];
    li = in ? slot[base + j] : 0;
  };
  auto fetch_point = [&]() {
    lx = ly = 3.0e30f;   // invalid slots are pushed out of every pixel's radius
#pragma unroll
    for (int c = 0; c < MAXC; ++c) lf[c] = 0.f;
    if (lv) {
      lx = pb[li * 3];
      ly = pb[li * 3 + 1];
      load_row(fb, li, C, P.vec, lf);
    }
  };
  auto stage = [&](int buf) {
    if (loader) {
      sxy[buf][threadIdx.x] = make_float2(lx, ly);
      sf[buf][threadIdx.x][0] = make_float4(lf[0], lf[1], lf[2], lf[3]);
      if (C > 4) sf[buf][threadIdx.x][1] = make_float4(lf[4], lf[5], lf[6], lf[7]);
    }
  };

  float acc[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) acc[c] = 0.f;
  float trans = 1.f, asum = 0.f;
  int count = 0;
  bool covered = false;
  bool sum_only = false;   // the bf16 wsumnorm's first walk: the alphas' sum,
  double asum_d = 0.0;     // in f64 (rounded once to f32, as the plain version's),
  float denom = 1.f;       // and its max(sum, 1e-4) for the second walk
  // slot j of buffer buf onto this lane's pixel, given its distance^2 and
  // alpha: the per-slot step of _blend_tiles' front-to-back walk
  auto blend = [&](float d2, float alpha, const float4& f0, const float4& f1) {
    if (!(d2 < P.r2)) return;
    covered = true;
    ++count;
    if (count > P.pp_pixel) return;
    if (BF16 && sum_only) {
      asum_d += (double)alpha;
      return;
    }
    float w = (P.accum == ALPHACOMPOSITE) ? alpha * trans : alpha;
    if (BF16) {   // the weight rounded to the features' type
      if (P.accum == WSUMNORM) w = __fdiv_rn(w, denom);
      w = __bfloat162float(__float2bfloat16_rn(w));
    }
    const float f[MAXC] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) acc[c] += w * f[c];
    trans *= (1.f - alpha);
    asum += alpha;
  };
  auto alpha_of = [&](float d2) {
    const float d = fminf(fmaxf(d2 * P.dscale, 1e-3f), 1.f);
    float alpha = 1.f - sqrtf(d);
    if (P.tau != 1.f) alpha = powf(alpha, P.tau);
    return alpha;
  };

  // one walk over the tile's slots (every thread of the block calls it)
  auto walk = [&]() {
    if (n > 0) {
      fetch_index(0);
      fetch_point();
      stage(0);
      fetch_index(ch);
    }
    __syncthreads();
    for (int j0 = 0, buf = 0; j0 < n; j0 += ch, buf ^= 1) {
      const bool more = j0 + ch < n;
      if (more) {                   // in flight while this chunk is blended
        fetch_point();              // chunk k + 1, by the indices loaded before
        fetch_index(j0 + 2 * ch);   // chunk k + 2
      }
      const int m = min(ch, n - j0);
      for (int g = 0; g < m; g += 32) {
        bool hit = false;
        if (g + lane < m) {
          const float2 q = sxy[buf][g + lane];
          const float ex = fmaxf(fmaxf(c_lo - q.x, q.x - c_hi), 0.f);
          const float ey = fmaxf(fmaxf(r_lo - q.y, q.y - r_hi), 0.f);
          hit = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)) <= P.r2_cull;
        }
        // the set bits WALK at a time: their loads, distances and alphas
        // are independent, their blends run in z order
        uint32_t todo = __ballot_sync(0xffffffffu, hit);
        while (todo) {
          int js[WALK];
          bool has[WALK];
  #pragma unroll
          for (int u = 0; u < WALK; ++u) {
            has[u] = todo != 0;
            js[u] = has[u] ? g + __ffs(todo) - 1 : g;
            todo &= todo - 1;
          }
          float d2[WALK], al[WALK];
          float4 f0[WALK], f1[WALK];
  #pragma unroll
          for (int u = 0; u < WALK; ++u) {
            const float2 q = sxy[buf][js[u]];
            const float dx = col - q.x, dy = row - q.y;
            // rounded as the plain version rounds it (no contraction), so
            // both entries' coverage is the same and equals the plain one
            d2[u] = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
            al[u] = alpha_of(d2[u]);
            f0[u] = sf[buf][js[u]][0];
            f1[u] = C > 4 ? sf[buf][js[u]][1] : make_float4(0.f, 0.f, 0.f, 0.f);
          }
  #pragma unroll
          for (int u = 0; u < WALK; ++u)
            if (has[u]) blend(d2[u], al[u], f0[u], f1[u]);
        }
      }
      if (more) stage(buf ^ 1);   // that buffer's chunk was blended before the last barrier
      __syncthreads();
    }
  };
  if (BF16 && P.accum == WSUMNORM) {   // every thread has passed the last barrier
    sum_only = true;
    walk();
    denom = fmaxf((float)asum_d, 1e-4f);
    sum_only = covered = false;
    count = 0;
  }
  walk();
  const float norm = (!BF16 && P.accum == WSUMNORM) ? 1.f / fmaxf(asum, 1e-4f) : 1.f;
  const size_t p = ((size_t)b * P.W + row0 + pr) * P.W + col0 + pc;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) out[p * C + c] = acc[c] * norm;
  cov[p] = covered ? 1 : 0;
}

// ---- C > 8: one walk, the product on the tensor cores (see the note) ----

constexpr int CH_WIDE = 128;   // slots a chunk
constexpr int KT = 16;         // culled slots a weight tile (the mma's k)
constexpr int WTS = 40;        // a weight tile row: 32 pixels + 8 (no bank conflicts)
constexpr int CW = 64;         // channels a block: 8 n8 tiles

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = hi + lo, each rounded to tf32 (nearest, ties away from zero), as
// the three-product split takes it
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}
__device__ __forceinline__ float to_tile(float w, float) { return w; }
__device__ __forceinline__ __nv_bfloat16 to_tile(float w, __nv_bfloat16) {
  return __float2bfloat16_rn(w);
}

template <typename T, int NT>
struct WideLayout {   // the block's dynamic shared memory, in this order
  static constexpr bool BF16 = sizeof(T) == 2;
  using WT = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  static constexpr int RS = 8 * NT + 8;   // a staged row: 8 NT channels + 16 or 32 bytes
  __host__ __device__ static size_t xy_bytes(int ch) { return (size_t)16 * ch; }
  __host__ __device__ static size_t rows_bytes(int ch) {
    return (size_t)2 * ch * RS * sizeof(T);
  }
  __host__ __device__ static size_t tile_bytes(int nw) {
    return (size_t)nw * KT * WTS * sizeof(WT);
  }
  __host__ __device__ static size_t bytes(int ch, int nw) {
    return xy_bytes(ch) + rows_bytes(ch) + tile_bytes(nw) + (size_t)nw * KT * 4;
  }
};

template <typename T, int NT>
__global__ void __launch_bounds__(256, 2)
blend_wide_kernel(const float* __restrict__ pts,        // (B, N, 3)
                  const T* __restrict__ feats,          // (B, N, C) f32 or bf16
                  const long long* __restrict__ slot,   // (B, nT, M) point index
                  const uint8_t* __restrict__ valid,    // (B, nT, M)
                  float* __restrict__ out,              // (B, W, W, C)
                  uint8_t* __restrict__ cov,            // (B, W, W)
                  Params P) {
  using L = WideLayout<T, NT>;
  using WT = typename L::WT;
  constexpr bool BF16 = L::BF16;
  constexpr int RS = L::RS;
  // culled slots whose distances and alphas are taken together: 4, but 2
  // for f32 at 64 channels, where 4 spills registers (both measured)
  constexpr int WW = !BF16 && NT == 8 ? 2 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count;

  const int nw = blockDim.x >> 5;
  const int ch = min((int)blockDim.x, CH_WIDE);
  float2* sxy = reinterpret_cast<float2*>(smem);                              // [2][ch]
  T* srow = reinterpret_cast<T*>(smem + L::xy_bytes(ch));                     // [2][ch][RS]
  WT* tiles = reinterpret_cast<WT*>(smem + L::xy_bytes(ch) + L::rows_bytes(ch));
  int* lists = reinterpret_cast<int*>(smem + L::xy_bytes(ch) + L::rows_bytes(ch) +
                                      L::tile_bytes(nw));

  const int bt = blockIdx.x;              // image * nT + tile
  const int b = bt / P.nT;
  const int t = bt - b * P.nT;
  const int rg = blockIdx.y % P.rgroups;          // this block's rectangles ...
  const int c0 = (blockIdx.y / P.rgroups) * CW;   // ... and channels
  const int C = P.C;                      // the features' row stride
  const int Cb = min(CW, C - c0);         // the block's channels
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rects = P.TS / RW;            // rectangles across a tile row
  const int rect = rg * nw + warp;
  const bool active = rect < (P.TS / RH) * rects;
  const int rr = active ? rect : 0;
  const int row0 = (t / P.nside) * P.TS + (rr / rects) * RH;   // the warp's rectangle
  const int col0 = (t % P.nside) * P.TS + (rr % rects) * RW;
  const float row = (float)(row0 + lane / RW);   // the lane's pixel
  const float col = (float)(col0 + lane % RW);
  const float r_lo = (float)row0, r_hi = r_lo + (RH - 1);
  const float c_lo = (float)col0, c_hi = c_lo + (RW - 1);
  WT* wt = tiles + warp * KT * WTS;       // [KT slots][WTS pixels]
  int* list = lists + warp * KT;          // the tile's slots in the chunk

  // the count of valid slots: one past the last valid one
  const size_t base = (size_t)bt * P.M;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  {
    int last = 0;
    for (int j = threadIdx.x; j < P.M; j += blockDim.x)
      if (valid[base + j]) last = j + 1;
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0 && last > 0) atomicMax(&s_count, last);
  }
  __syncthreads();
  const int n = s_count;

  // the loader's slot of a chunk: thread j < ch stages slot j0 + j
  const bool loader = (int)threadIdx.x < ch;
  const float* pb = pts + (size_t)b * P.N * 3;
  const T* fb = feats + (size_t)b * P.N * C + c0;
  long long li = 0;   // the next chunk's point index and valid flag
  bool lv = false;
  auto fetch_index = [&](int j0) {   // the two loads do not wait on each other
    const int j = j0 + threadIdx.x;
    const bool in = loader && j < n;
    lv = in && valid[base + j];
    li = in ? slot[base + j] : 0;
  };
  auto issue = [&](int buf) {   // this thread's slot of the next chunk into buffer buf
    if (!loader) return;
    float2* xy = sxy + buf * ch + threadIdx.x;
    if (!lv) {   // invalid slots are pushed out of every pixel's radius
      *xy = make_float2(3.0e30f, 3.0e30f);
      return;
    }
    cp_async4(&xy->x, pb + li * 3);
    cp_async4(&xy->y, pb + li * 3 + 1);
    T* dst = srow + ((size_t)buf * ch + threadIdx.x) * RS;
    const T* src = fb + li * C;
    if (P.vec == 16) {
      for (int k = 0; k < Cb * (int)sizeof(T) / 16; ++k)
        cp_async16(dst + k * (16 / sizeof(T)), src + k * (16 / sizeof(T)));
    } else if (P.vec == 4) {
      for (int k = 0; k < Cb * (int)sizeof(T) / 4; ++k)
        cp_async4(dst + k * (4 / sizeof(T)), src + k * (4 / sizeof(T)));
    } else {   // bf16 rows of odd C sit at any even address
      for (int c = 0; c < Cb; ++c) dst[c] = src[c];
    }
  };

  float acc[2][NT][4];   // [m16 half][n8 tile][fragment]
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.f;
  float trans = 1.f, asum = 0.f;
  int count = 0;
  bool covered = false;
  bool sum_only = false;   // the bf16 wsumnorm's first walk, as the C <= 8 body's
  double asum_d = 0.0;
  float denom = 1.f;
  int nk = 0;              // slots in the warp's weight tile (warp-uniform)
  const int g = lane >> 2, tq = lane & 3;   // a fragment's row and column group

  // the per-slot step of _blend_tiles' front-to-back walk for this lane's
  // pixel -> the slot's weight (0 where it adds nothing)
  auto step = [&](float d2, float alpha) -> float {
    if (!(d2 < P.r2)) return 0.f;
    covered = true;
    ++count;
    if (count > P.pp_pixel) return 0.f;
    if (BF16 && sum_only) {
      asum_d += (double)alpha;
      return 0.f;
    }
    float w = (P.accum == ALPHACOMPOSITE) ? alpha * trans : alpha;
    if (BF16 && P.accum == WSUMNORM) w = __fdiv_rn(w, denom);
    trans *= (1.f - alpha);
    asum += alpha;
    return w;
  };
  auto alpha_of = [&](float d2) {
    const float d = fminf(fmaxf(d2 * P.dscale, 1e-3f), 1.f);
    float alpha = 1.f - sqrtf(d);
    if (P.tau != 1.f) alpha = powf(alpha, P.tau);
    return alpha;
  };

  // the weight tile's product, acc += W (32 x KT) @ F (KT x 8 NT), the
  // tile padded to KT slots with zero weights (the whole warp calls it)
  auto flush = [&](int buf) {
    for (int k = nk; k < KT; ++k) {
      wt[k * WTS + lane] = to_tile(0.f, WT());
      if (lane == 0) list[k] = list[0];
    }
    __syncwarp();
    const T* rows = srow + (size_t)buf * ch * RS;
    if constexpr (BF16) {
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)   // matrix i = lane / 8: slots 8 (i / 2), pixels 8 (i % 2)
        ldsm_x4_trans(a[h], wt + ((lane & 7) + 8 * (lane >> 4)) * WTS + 16 * h +
                                8 * ((lane >> 3) & 1));
      // matrix i: slots 8 (i % 2), n8 tile i / 2 of the pair
      const T* brow = rows + list[lane & 15] * RS + 8 * (lane >> 4);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {   // n8 tiles j, j + 1
        uint32_t bf[4];
        ldsm_x4_trans(bf, brow + 8 * j);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_bf16(acc[h][j], a[h], bf[0], bf[1]);
          mma_bf16(acc[h][j + 1], a[h], bf[2], bf[3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KT; kk += 8) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)   // (pixel g or g + 8, slot tq or tq + 4)
            split_tf32(wt[(kk + tq + 4 * (e >> 1)) * WTS + 16 * h + g + 8 * (e & 1)],
                       ahi[h][e], alo[h][e]);
        const T* r0 = rows + list[kk + tq] * RS + g;
        const T* r1 = rows + list[kk + tq + 4] * RS + g;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(r0[8 * j], bh0, bl0);
          split_tf32(r1[8 * j], bh1, bl1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {   // the small terms first
            mma_tf32(acc[h][j], alo[h], bh0, bh1);
            mma_tf32(acc[h][j], ahi[h], bl0, bl1);
            mma_tf32(acc[h][j], ahi[h], bh0, bh1);
          }
        }
      }
    }
    __syncwarp();   // the tile is read before it is written again
    nk = 0;
  };

  // one walk over the tile's slots (every thread of the block calls it)
  auto walk = [&]() {
    if (n > 0) {
      fetch_index(0);
      issue(0);
      fetch_index(ch);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int j0 = 0, buf = 0; j0 < n; j0 += ch, buf ^= 1) {
      if (j0 + ch < n) {            // in flight while this chunk is walked
        issue(buf ^ 1);             // chunk k + 1, by the indices loaded before
        fetch_index(j0 + 2 * ch);   // chunk k + 2
      }
      if (active) {
        const float2* xy = sxy + buf * ch;
        const int m = min(ch, n - j0);
        for (int g0 = 0; g0 < m; g0 += 32) {
          bool hit = false;
          if (g0 + lane < m) {
            const float2 q = xy[g0 + lane];
            const float ex = fmaxf(fmaxf(c_lo - q.x, q.x - c_hi), 0.f);
            const float ey = fmaxf(fmaxf(r_lo - q.y, q.y - r_hi), 0.f);
            hit = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)) <= P.r2_cull;
          }
          uint32_t todo = __ballot_sync(0xffffffffu, hit);
          while (todo) {   // WW set bits at a time, their steps in z order
            int js[WW];
            bool has[WW];
#pragma unroll
            for (int u = 0; u < WW; ++u) {
              has[u] = todo != 0;
              js[u] = has[u] ? g0 + __ffs(todo) - 1 : g0;
              todo &= todo - 1;
            }
            float d2[WW], al[WW];
#pragma unroll
            for (int u = 0; u < WW; ++u) {
              const float2 q = xy[js[u]];
              const float dx = col - q.x, dy = row - q.y;
              d2[u] = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
              al[u] = alpha_of(d2[u]);
            }
#pragma unroll
            for (int u = 0; u < WW; ++u) {
              if (!has[u]) continue;
              const float w = step(d2[u], al[u]);
              if (sum_only) continue;
              wt[nk * WTS + lane] = to_tile(w, WT());   // bf16: nearest even
              if (lane == 0) list[nk] = js[u];
              if (++nk == KT) flush(buf);
            }
          }
        }
        if (nk > 0) flush(buf);   // before the buffer is staged again
      }
      cp_async_wait_all();
      __syncthreads();
    }
  };
  if (BF16 && P.accum == WSUMNORM) {   // every thread has passed the last barrier
    sum_only = true;
    walk();
    denom = fmaxf((float)asum_d, 1e-4f);
    sum_only = covered = false;
    count = 0;
  }
  walk();
  if (!active) return;
  const float norm = (!BF16 && P.accum == WSUMNORM) ? 1.f / fmaxf(asum, 1e-4f) : 1.f;
  if (c0 == 0) cov[((size_t)b * P.W + row0 + lane / RW) * P.W + col0 + lane % RW] = covered;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {   // fragment rows g and g + 8 of half h
      const int px = 16 * h + 8 * e + g;   // the pixel's lane
      const float nm = __shfl_sync(0xffffffffu, norm, px);
      const size_t p = ((size_t)b * P.W + row0 + px / RW) * P.W + col0 + px % RW;
      float* o = out + p * C + c0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * tq;
        if (c + 1 < Cb && (C & 1) == 0) {
          *reinterpret_cast<float2*>(o + c) =
              make_float2(acc[h][j][2 * e] * nm, acc[h][j][2 * e + 1] * nm);
        } else {
          if (c < Cb) o[c] = acc[h][j][2 * e] * nm;
          if (c + 1 < Cb) o[c + 1] = acc[h][j][2 * e + 1] * nm;
        }
      }
    }
}

}  // namespace

namespace {

template <typename T, int NT>
int launch_wide(const T* feats, Params P, int B, const void* pts, const void* slot,
                const void* valid, void* out, void* cov, cudaStream_t stream) {
  const int rects = (P.TS / RH) * (P.TS / RW);
  const int nw = rects < 8 ? rects : 8;
  P.rgroups = (rects + nw - 1) / nw;
  const size_t smem = WideLayout<T, NT>::bytes(32 * nw < CH_WIDE ? 32 * nw : CH_WIDE, nw);
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        blend_wide_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const dim3 grid(B * P.nT, P.rgroups * ((P.C + CW - 1) / CW));
  blend_wide_kernel<T, NT><<<grid, 32 * nw, smem, stream>>>(
      (const float*)pts, feats, (const long long*)slot, (const uint8_t*)valid,
      (float*)out, (uint8_t*)cov, P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* pts, const void* feats, const void* slot, const void* valid,
           void* out, void* cov, int B, int N, int W, int M, int C, int TS, float r2,
           float dscale, float tau, int pp_pixel, int accum, void* stream) {
  if (C < 1 || TS % RW != 0 || TS % RH != 0 || TS > 32 || W % TS != 0)
    return (int)cudaErrorInvalidValue;
  const int nside = W / TS;
  const uintptr_t at = (uintptr_t)feats;
  const cudaStream_t s = (cudaStream_t)stream;
  Params P = {N, nside * nside, nside, M, C, TS, W, r2, r2 * (1.f + 1e-6f), dscale, tau,
              pp_pixel, accum, 0, 1};
  if (C <= MAXC) {
    P.vec = sizeof(T) == 2 && C % MAXC == 0 && at % 16 == 0;
    blend_kernel<T><<<B * P.nT, TS * TS, 0, s>>>(
        (const float*)pts, (const T*)feats, (const long long*)slot,
        (const uint8_t*)valid, (float*)out, (uint8_t*)cov, P);
    return (int)cudaGetLastError();
  }
  const int row = C * (int)sizeof(T);   // a feature row's bytes
  P.vec = row % 16 == 0 && at % 16 == 0 ? 16 : row % 4 == 0 && at % 4 == 0 ? 4 : 2;
  const int cw = C < CW ? C : CW;   // channels a block
  const T* f = (const T*)feats;
  if (cw <= 16) return launch_wide<T, 2>(f, P, B, pts, slot, valid, out, cov, s);
  if (cw <= 32) return launch_wide<T, 4>(f, P, B, pts, slot, valid, out, cov, s);
  return launch_wide<T, 8>(f, P, B, pts, slot, valid, out, cov, s);
}

}  // namespace

// pts (B, N, 3) f32 [col, row, depth]; feats (B, N, C) f32; slot (B, nT, M)
// int64 point indices of the z-sorted slots; valid (B, nT, M) bool; out
// (B, W, W, C) f32; cov (B, W, W) bool.  nT = (W / TS)^2.  One launch: B * nT
// blocks at C <= 8 (a thread a pixel); at C > 8 B * nT x (tile rectangles / 8,
// rounded up) x ceil(C / 64) blocks of at most 8 warps (B * nT at tile 16,
// C <= 64).
extern "C" int splat_blend(const void* pts, const void* feats, const void* slot,
                           const void* valid, void* out, void* cov, int B, int N, int W,
                           int M, int C, int TS, float r2, float dscale, float tau,
                           int pp_pixel, int accum, void* stream) {
  return launch<float>(pts, feats, slot, valid, out, cov, B, N, W, M, C, TS, r2, dscale,
                       tau, pp_pixel, accum, stream);
}

// The same with feats (B, N, C) bf16: each weight rounded to bf16, the sums
// f32, out f32.
extern "C" int splat_blend_bf16(const void* pts, const void* feats, const void* slot,
                                const void* valid, void* out, void* cov, int B, int N,
                                int W, int M, int C, int TS, float r2, float dscale,
                                float tau, int pp_pixel, int accum, void* stream) {
  return launch<__nv_bfloat16>(pts, feats, slot, valid, out, cov, B, N, W, M, C, TS, r2,
                               dscale, tau, pp_pixel, accum, stream);
}
