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
// Any feature width C >= 1 (the TPU kernel's C is feats.shape[-1]): the
// grid's second dimension runs over groups of MAXC = 8 channels, and each
// group's block is the body below for its 8 channels -- the same slots
// walked, the same distances and alphas recomputed, only its channels
// gathered and accumulated (the tail group masked), and group 0 alone
// writing the coverage.  Per channel the arithmetic is the C <= 8 body's;
// C <= 8 (every RGB path) runs the instantiation without groups, whose
// code is the one-group body as it was.  At C = 64
// the walk runs 8 times over; a tensor-core formulation (a chunk's
// (pixels x slots) weights in shared memory, then one product with the
// (slots x C) features) is the open redesign for wide C.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  int vec;         // bf16 rows: a group's 8 channels as one 16-byte load
};

// a slot's Cg (<= MAXC) channels from channel c0 of its feature row, as f32
__device__ __forceinline__ void load_row(const float* fb, long long li, int C, int c0,
                                         int Cg, int, float* lf) {
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < Cg) lf[c] = fb[li * C + c0 + c];
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* fb, long long li, int C,
                                         int c0, int Cg, int vec, float* lf) {
  const __nv_bfloat16* row = fb + li * C + c0;
  if (vec) {   // C % 8 == 0 and a 16-byte aligned base: Cg == 8
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
    if (c < Cg) lf[c] = __bfloat162float(row[c]);
}

template <typename T, bool GROUPS>
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
  const int C = P.C;                      // the features' row stride
  const int c0 = GROUPS ? blockIdx.y * MAXC : 0;   // this block's channel group
  const int Cg = GROUPS ? min(MAXC, C - c0) : C;   // its channels
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
      load_row(fb, li, C, c0, Cg, P.vec, lf);
    }
  };
  auto stage = [&](int buf) {
    if (loader) {
      sxy[buf][threadIdx.x] = make_float2(lx, ly);
      sf[buf][threadIdx.x][0] = make_float4(lf[0], lf[1], lf[2], lf[3]);
      if (Cg > 4) sf[buf][threadIdx.x][1] = make_float4(lf[4], lf[5], lf[6], lf[7]);
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
      if (c < Cg) acc[c] += w * f[c];
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
            f1[u] = Cg > 4 ? sf[buf][js[u]][1] : make_float4(0.f, 0.f, 0.f, 0.f);
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
    if (c < Cg) out[p * C + c0 + c] = acc[c] * norm;
  if (!GROUPS || blockIdx.y == 0) cov[p] = covered ? 1 : 0;
}

}  // namespace

namespace {

template <typename T>
int launch(const void* pts, const void* feats, const void* slot, const void* valid,
           void* out, void* cov, int B, int N, int W, int M, int C, int TS, float r2,
           float dscale, float tau, int pp_pixel, int accum, void* stream) {
  if (C < 1 || TS % RW != 0 || TS % RH != 0 || TS > 32 || W % TS != 0)
    return (int)cudaErrorInvalidValue;
  const int nside = W / TS;
  const int vec = sizeof(T) == 2 && C % MAXC == 0 && (uintptr_t)feats % 16 == 0;
  Params P = {N, nside * nside, nside, M, C, TS, W, r2, r2 * (1.f + 1e-6f), dscale, tau,
              pp_pixel, accum, vec};
  const dim3 grid(B * P.nT, (C + MAXC - 1) / MAXC);
  auto kernel = C <= MAXC ? blend_kernel<T, false> : blend_kernel<T, true>;
  kernel<<<grid, TS * TS, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const T*)feats, (const long long*)slot,
      (const uint8_t*)valid, (float*)out, (uint8_t*)cov, P);
  return (int)cudaGetLastError();
}

}  // namespace

// pts (B, N, 3) f32 [col, row, depth]; feats (B, N, C) f32; slot (B, nT, M)
// int64 point indices of the z-sorted slots; valid (B, nT, M) bool; out
// (B, W, W, C) f32; cov (B, W, W) bool.  nT = (W / TS)^2.  One launch of
// B * nT x ceil(C / 8) blocks.
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
