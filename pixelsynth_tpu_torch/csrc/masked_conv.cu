// K3: the locally masked convolution, for Hopper (sm_90a).
//
// Replaces the TPU kernel of pixelsynth_tpu/ops/masked_conv_pallas.py
// (_kernel, :26):
//   out[p] = sum_t m_t[p] * (x[p + o_t] @ W_t) + b
// over the 9 taps of a 3x3 kernel with dilation d, zero outside the image.
//
// Design.  The TPU kernel keeps G whole images in VMEM and runs nine big
// matmuls; a candidate's (1024 x 160) bf16 activation is 320 KB, more
// than a block's shared memory.  So the kernel tiles over positions: a
// block owns 128 positions and all Cout, loops over the taps, and takes
// each tap's shifted rows from device memory (L2-resident) through the
// cp.async ring of lmconv_layer.cuh, with the products on the tensor
// cores (wmma, bf16 operands, f32 accumulation).  It is K1's layer
// without its epilogue: the bias is added and the f32 result stored.
//   * The masks are the raw (B, HW, 9) ones ({0, 1} entries), so the
//     kernel zero-pads itself: a tap whose source row or column leaves the
//     image is not read (guard_image), and a tap whose mask is 0 is not
//     read either -- never multiplied by 0, since 0 * NaN = NaN.
//   * (Cin, Cout) are arguments: each must be F or 2F for one width F, a
//     multiple of 16 up to 80 (the trunk's shapes: (2F, F), (2F, 2F),
//     (F, F), and (F, 2F)); anything else is refused.
//   * compute_dtype float32 has its own kernel on the CUDA cores
//     (masked_conv_f32_kernel): a block stages 8 positions' shifted rows
//     per tap in shared memory, each thread owns output channels, and the
//     f32 FMAs follow the plain version's order (per tap: the product,
//     scaled by the mask value, then accumulated).  It is there to hold
//     the indexing to 1e-4 against the plain version, not for speed.
//
// Bound on this card (pop 16, 32x32, Cin = Cout = 160): 2 * 9 * 16384 *
// 160 * 160 = 7.5 GFLOP dense on bf16 tensor cores (7.6 us at 989
// TFLOP/s) against 5.2 MB of x, 10.5 MB of output and 0.6 MB of masks
// (4.9 us at 3.35 TB/s): operations bound it, barely; this simple version
// (wmma from a two-stage ring) sits well above either (PERF.md).

#include "lmconv_layer.cuh"

using namespace lmk;

namespace {

// f32 on the CUDA cores.  A block takes PT positions of one image; per
// tap it stages their shifted rows (zero outside the image) and each
// thread accumulates its output channels co = tid + j * FT.
constexpr int PT = 8;
constexpr int FT = 128;
constexpr int MAXCO = 4;  // Cout <= MAXCO * FT

__global__ void __launch_bounds__(FT)
masked_conv_f32_kernel(const float* x, const float* mask, const float* w,
                       const float* bias, float* out, int H, int W, int Cin,
                       int Cout, int d) {
  extern __shared__ float xs[];  // (PT, Cin)
  const int HW = H * W;
  const int tiles = HW / PT;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - b * tiles) * PT;
  float acc[PT][MAXCO];
#pragma unroll
  for (int r = 0; r < PT; ++r)
#pragma unroll
    for (int j = 0; j < MAXCO; ++j) acc[r][j] = 0.f;

  for (int t = 0; t < 9; ++t) {
    const int dr = (t / 3 - 1) * d;
    const int dc = (t % 3 - 1) * d;
    __syncthreads();  // the previous tap's rows have been read
    for (int idx = threadIdx.x; idx < PT * Cin; idx += FT) {
      const int r = idx / Cin;
      const int c = idx - r * Cin;
      const int p = p0 + r;
      const int rr = p / W + dr;
      const int cc = p % W + dc;
      const bool ok = rr >= 0 && rr < H && cc >= 0 && cc < W;
      xs[idx] = ok ? x[((size_t)b * HW + rr * W + cc) * Cin + c] : 0.f;
    }
    __syncthreads();
    float mt[PT];
#pragma unroll
    for (int r = 0; r < PT; ++r) mt[r] = mask[((size_t)b * HW + p0 + r) * 9 + t];
#pragma unroll
    for (int j = 0; j < MAXCO; ++j) {
      const int co = threadIdx.x + j * FT;
      if (co >= Cout) break;
      float z[PT];
#pragma unroll
      for (int r = 0; r < PT; ++r) z[r] = 0.f;
      const float* wt = w + (size_t)t * Cin * Cout + co;
      for (int ci = 0; ci < Cin; ++ci) {
        const float wv = wt[(size_t)ci * Cout];
#pragma unroll
        for (int r = 0; r < PT; ++r) z[r] = fmaf(xs[r * Cin + ci], wv, z[r]);
      }
#pragma unroll
      for (int r = 0; r < PT; ++r) acc[r][j] += mt[r] * z[r];
    }
  }
#pragma unroll
  for (int j = 0; j < MAXCO; ++j) {
    const int co = threadIdx.x + j * FT;
    if (co >= Cout) break;
#pragma unroll
    for (int r = 0; r < PT; ++r)
      out[((size_t)b * HW + p0 + r) * Cout + co] = acc[r][j] + bias[co];
  }
}

}  // namespace

extern "C" {

// bf16 operands, f32 accumulation.  x (B, HW, Cin) bf16; mask (B, HW, 9)
// f32 with {0, 1} entries, NOT boundary-folded; w (9, Cin, Cout) bf16;
// bias (Cout) f32; out (B, HW, Cout) f32.
int masked_conv_bf16(const void* x, const void* mask, const void* w,
                     const void* bias, void* out, int B, int H, int W,
                     int Cin, int Cout, int dilation, void* stream) {
  const int HW = H * W;
  int F = 0;
  if (width_ok(Cin) && (Cout == Cin || Cout == 2 * Cin)) F = Cin;
  else if (Cin % 2 == 0 && width_ok(Cin / 2) &&
           (Cout == Cin || Cout == Cin / 2)) F = Cin / 2;
  if (F == 0 || HW % TP != 0) return (int)cudaErrorInvalidValue;
  int sh[9];
  make_shifts(sh, W, dilation);
  Layer L = conv_layer((const bf16*)x, (long long)HW * Cin, Cin,
                       (const float*)mask, (const bf16*)w, (const float*)bias,
                       Cout, sh);
  guard_image(L, H, W, dilation);
  L.linear = 1;
  L.out = (float*)out;
  return (int)launch_layer(L, B, HW, F, (cudaStream_t)stream);
}

// float32 throughout.  x (B, HW, Cin) f32; mask (B, HW, 9) f32 (any
// values); w (9, Cin, Cout) f32; bias (Cout) f32; out (B, HW, Cout) f32.
int masked_conv_f32(const void* x, const void* mask, const void* w,
                    const void* bias, void* out, int B, int H, int W, int Cin,
                    int Cout, int dilation, void* stream) {
  const int HW = H * W;
  const size_t smem = (size_t)PT * Cin * sizeof(float);
  if (HW % PT != 0 || Cout > MAXCO * FT || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  masked_conv_f32_kernel<<<B * HW / PT, FT, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)mask, (const float*)w,
      (const float*)bias, (float*)out, H, W, Cin, Cout, dilation);
  return (int)cudaGetLastError();
}

}  // extern "C"
