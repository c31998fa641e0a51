// K2: the soft z-buffer splat blend, for Hopper (sm_90a).
//
// Replaces the TPU kernel pixelsynth_tpu/ops/splat_pallas.py _blend_kernel
// (:40), which computes the same function as the XLA blend
// pixelsynth_tpu/ops/splat.py _blend_tiles (:395).  Binning (one stable
// sort of packed keys, searchsorted offsets, fixed-capacity gather) stays
// in PyTorch; this kernel reads the gathered, z-sorted per-tile slot lists.
//
// Design.  The TPU kernel turns the front-to-back prefix into a
// triangular-matrix product because the MXU is its fast path.  With C = 3
// point features the blend is no matrix product on this card, so it is the
// natural GPU form: one block per 16x16 tile, one thread per pixel.  The
// block walks the tile's z-sorted slots front to back in shared-memory
// chunks; each thread carries in registers its transmittance, the covered
// count for the K-nearest-in-z cap (a slot is kept iff covered and the
// inclusive count of covered slots, kept or not, is <= pp_pixel), the
// accumulated features, the alpha mass (wsumnorm) and the covered flag --
// exactly _blend_tiles' cumsum / cumprod, taken sequentially.  Valid slots
// form a prefix of each list, so the walk stops at the first chunk that
// holds none.
//
// Bound on this card (W=256, 2 images, M=1024): a few tens of millions of
// pixel x slot pairs of fp32 CUDA-core work (~20 flops each) against
// ~13 MB of slot traffic: operations bound it, at tens of microseconds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 256;
constexpr int MAXC = 8;

enum Accum { ALPHACOMPOSITE = 0, WSUM = 1, WSUMNORM = 2 };

struct Params {
  int M, C, TS;
  float r2;        // radius^2 in pixels^2
  float dscale;    // (2/W)^2 / (radius * 2/W)^rad_pow
  float tau;
  int pp_pixel;
  int accum;
};

__global__ void blend_kernel(const float* __restrict__ pts,     // (T, M, 3)
                             const float* __restrict__ feats,   // (T, M, C)
                             const uint8_t* __restrict__ valid, // (T, M)
                             const float* __restrict__ origins, // (T, 2)
                             float* __restrict__ out,           // (T, TS*TS, C)
                             uint8_t* __restrict__ cov,         // (T, TS*TS)
                             Params P) {
  __shared__ float sx[CHUNK], sy[CHUNK];
  __shared__ float sf[CHUNK * MAXC];
  __shared__ int s_any;

  const int t = blockIdx.x;
  const int pix = threadIdx.x;
  const int M = P.M, C = P.C;
  const float row = origins[2 * t] + (float)(pix / P.TS);
  const float col = origins[2 * t + 1] + (float)(pix % P.TS);

  float acc[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) acc[c] = 0.f;
  float trans = 1.f, asum = 0.f;
  int count = 0;
  bool covered = false;

  const size_t base = (size_t)t * M;
  for (int j0 = 0; j0 < M; j0 += CHUNK) {
    const int n = min(CHUNK, M - j0);
    if (threadIdx.x == 0) s_any = 0;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const bool v = valid[base + j0 + j] != 0;
      // invalid slots are pushed out of every pixel's radius
      sx[j] = v ? pts[(base + j0 + j) * 3 + 0] : 3.0e30f;
      sy[j] = v ? pts[(base + j0 + j) * 3 + 1] : 3.0e30f;
      for (int c = 0; c < C; ++c) sf[j * MAXC + c] = feats[(base + j0 + j) * C + c];
      if (v) s_any = 1;
    }
    __syncthreads();
    if (!s_any) break;  // valid slots are a prefix: nothing further
    for (int j = 0; j < n; ++j) {
      const float dx = col - sx[j];
      const float dy = row - sy[j];
      const float d2 = dx * dx + dy * dy;
      if (!(d2 < P.r2)) continue;
      covered = true;
      ++count;
      if (count > P.pp_pixel) continue;
      const float d = fminf(fmaxf(d2 * P.dscale, 1e-3f), 1.f);
      float alpha = 1.f - sqrtf(d);
      if (P.tau != 1.f) alpha = powf(alpha, P.tau);
      const float w = (P.accum == ALPHACOMPOSITE) ? alpha * trans : alpha;
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) acc[c] += w * sf[j * MAXC + c];
      trans *= (1.f - alpha);
      asum += alpha;
    }
    __syncthreads();
  }
  const float norm = (P.accum == WSUMNORM) ? 1.f / fmaxf(asum, 1e-4f) : 1.f;
  const size_t o = ((size_t)t * P.TS * P.TS + pix) * C;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) out[o + c] = acc[c] * norm;
  cov[(size_t)t * P.TS * P.TS + pix] = covered ? 1 : 0;
}

}  // namespace

extern "C" int splat_blend(const void* pts, const void* feats,
                           const void* valid, const void* origins, void* out,
                           void* cov, int T, int M, int C, int TS, float r2,
                           float dscale, float tau, int pp_pixel, int accum,
                           void* stream) {
  if (C > MAXC || TS * TS > 1024) return (int)cudaErrorInvalidValue;
  Params P = {M, C, TS, r2, dscale, tau, pp_pixel, accum};
  blend_kernel<<<T, TS * TS, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)feats, (const uint8_t*)valid,
      (const float*)origins, (float*)out, (uint8_t*)cov, P);
  return (int)cudaGetLastError();
}
