// K4: one whole gated resnet block in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel of pixelsynth_tpu/ops/gated_resnet_pallas.py
// (_kernel, :71):
//   x   = pono(masked_conv(concat_elu(og), w1) + b1)
//   x  += concat_elu(a) @ w_skip + b_skip          (when a is given)
//   y   = masked_conv(concat_elu(x), w2) + b2
//   out = og + pono(y[:, :F]) * sigmoid(y[:, F:])
//
// Design.  The second conv at position p needs the first conv's output at
// p's 3x3 neighbours.  The TPU holds the whole image in VMEM between the
// two convs; a block here holds 128 positions.  Of the three ways to get
// the neighbours across blocks in ONE launch -- recomputing a halo of
// conv1 rows per block (~50% more conv1 work on a 4-row tile), one
// thread-block cluster per image with the cluster's barrier, or a
// cooperative launch with a grid-wide barrier -- this takes the
// cooperative launch.  The cluster version was built first and measured:
// at one block an SM, clusters of 8 pack only 15 images onto the card's
// 132 SMs (a cluster must sit inside one GPC), so the main path's 16
// candidates ran as two waves and took twice the time (PERF.md).  A
// cooperative grid has no such packing rule, and no limit of 8 blocks an
// image either:
//   * the grid is persistent: as many groups of HW/128 blocks as the card
//     keeps resident (16 at 32x32: 128 of 132 SMs), each group taking
//     images g, g + groups, ... in rounds, so a larger batch is further
//     rounds of the same launch and never a launch that cannot start;
//   * a round is three phases with a grid barrier between them (it orders
//     the blocks' global-memory writes):
//       phase 0  concat_elu(og) of the block's tile -> bf16 scratch `ue`
//       phase 1  conv1 from `ue` (cp.async ring + wmma, lmconv_layer.cuh),
//                PONO, + nin skip (its operand concat_elu(a) is staged from
//                the f32 `a`), concat_elu -> bf16 scratch `xe`
//       phase 2  conv2 from `xe`, split, PONO, gate, residual -> out (f32)
//     and the intermediates never leave L2.
// The wrapper allocates both scratches.  Elementwise maths is f32; only
// the matmul operands are bf16.  PONO is the two-pass form of the TPU
// kernel's _pono (:40-44).  The skip is a launch-time flag (a == null: no
// skip term at all, no zero weights).  The masks are the raw (B, HW, 9)
// ones with {0, 1} entries; the load zero-pads at the image border.
//
// Bound on this card (pop 16, 32x32, F=80): 2 * 9 * 16384 * (160*80 +
// 160*160) + 2 * 16384 * 160 * 80 = 11.7 GFLOP dense on bf16 tensor cores
// (11.9 us at 989 TFLOP/s) against ~16 MB of og, a, out and masks (4.8 us
// at 3.35 TB/s): operations bound it.  What the launch takes is one
// block's latency through both convs of its 128 positions (the same time
// at 4 images as at 16), far above either.

#include <cooperative_groups.h>

#include "lmconv_layer.cuh"

namespace cg = cooperative_groups;
using namespace lmk;

namespace {

// A group of HW / TP consecutive blocks owns one image at a time; the grid
// holds `gridDim.x / tiles` groups, and group g takes images g, g + groups,
// ...  Every block passes the same number of grid barriers, with or without
// an image left to do.
template <int F>
__global__ void __launch_bounds__(NTHREADS, 1)
gated_resnet_kernel(Layer c1, Layer c2, const float* og, bf16* ue, int HW,
                    int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int tiles = HW / TP;
  const int groups = gridDim.x / tiles;
  const int grp = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - grp * tiles) * TP;

  for (int b0 = 0; b0 < B; b0 += groups) {
    const int b = b0 + grp;
    const bool active = b < B;
    if (active) {
      const size_t base = ((size_t)b * HW + p0) * F;
      for (int idx = threadIdx.x; idx < TP * F; idx += NTHREADS) {
        const int r = idx / F;
        const int c = idx - r * F;
        float pos, neg;
        elu_halves(og[base + idx], pos, neg);
        ue[2 * (base + (size_t)r * F) + c] = __float2bfloat16(pos);
        ue[2 * (base + (size_t)r * F) + F + c] = __float2bfloat16(neg);
      }
    }
    grid.sync();
    if (active) layer_body<F, false>(c1, HW, b, p0, smem);
    grid.sync();
    if (active) layer_body<F, true>(c2, HW, b, p0, smem);
    // the next round writes other images' rows of `ue` and `xe`, and its
    // first use of shared memory comes after a barrier
  }
}

// Blocks of this kernel the card keeps resident at once (one an SM at the
// trunk's width); cached per device.
template <int F>
cudaError_t resident_blocks(int* out) {
  static int cached_dev = -1, cached = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != cached_dev) {
    constexpr size_t smem = smem_bytes(F);
    e = cudaFuncSetAttribute(gated_resnet_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gated_resnet_kernel<F>, NTHREADS, smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cached = per_sm * sms;
    cached_dev = dev;
  }
  *out = cached;
  return cudaSuccess;
}

template <int F>
cudaError_t launch(Layer c1, Layer c2, const float* og, bf16* ue, int B,
                   int HW, cudaStream_t st) {
  int resident = 0;
  cudaError_t e = resident_blocks<F>(&resident);
  if (e != cudaSuccess) return e;
  const int tiles = HW / TP;
  int groups = resident / tiles;
  if (groups > B) groups = B;
  if (groups < 1) return cudaErrorInvalidValue;  // one image exceeds the card
  void* args[] = {&c1, &c2, &og, &ue, &HW, &B};
  e = cudaLaunchCooperativeKernel((const void*)gated_resnet_kernel<F>,
                                  dim3(groups * tiles), dim3(NTHREADS), args,
                                  smem_bytes(F), st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// og (B, HW, F) f32; a (B, HW, F) f32 or null (no skip); mask (B, HW, 9)
// f32 with {0, 1} entries, not boundary-folded; w1 (9, 2F, F) bf16, b1 (F);
// ws (2F, F) bf16 and bs (F), read only with a; w2 (9, 2F, 2F) bf16,
// b2 (2F); out (B, HW, F) f32; scratch ue, xe (B, HW, 2F) bf16.
// HW must be a multiple of 128, and one image's HW / 128 blocks must be
// resident on the card together.
int gated_resnet(const void* og, const void* a, const void* mask,
                 const void* w1, const void* b1, const void* ws,
                 const void* bs, const void* w2, const void* b2, void* out,
                 void* ue, void* xe, int B, int H, int W, int F,
                 void* stream) {
  const int HW = H * W;
  if (!width_ok(F) || HW % TP != 0) return (int)cudaErrorInvalidValue;
  const long long n2 = (long long)HW * 2 * F;
  int sh[9];
  make_shifts(sh, W, 1);
  Layer c1 = conv_layer((const bf16*)ue, n2, 2 * F, (const float*)mask,
                        (const bf16*)w1, (const float*)b1, F, sh);
  guard_image(c1, H, W, 1);
  c1.pono_two_pass = 1;
  if (a != nullptr) {
    c1.skip32 = (const float*)a;
    c1.ws = (const bf16*)ws;
    c1.bs = (const float*)bs;
  }
  c1.out_elu = (bf16*)xe;
  Layer c2 = conv_layer((const bf16*)xe, n2, 2 * F, (const float*)mask,
                        (const bf16*)w2, (const float*)b2, 2 * F, sh);
  guard_image(c2, H, W, 1);
  c2.pono_two_pass = 1;
  c2.og = (const float*)og;
  c2.out = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ogp = (const float*)og;
  bf16* uep = (bf16*)ue;
  switch (F) {
    case 16: return (int)launch<16>(c1, c2, ogp, uep, B, HW, st);
    case 32: return (int)launch<32>(c1, c2, ogp, uep, B, HW, st);
    case 48: return (int)launch<48>(c1, c2, ogp, uep, B, HW, st);
    case 64: return (int)launch<64>(c1, c2, ogp, uep, B, HW, st);
    case 80: return (int)launch<80>(c1, c2, ogp, uep, B, HW, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
