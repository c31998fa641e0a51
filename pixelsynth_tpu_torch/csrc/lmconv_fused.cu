// K1: the fused locally-masked PixelCNN trunk (up and down passes), for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of pixelsynth_tpu/ops/lmconv_fused.py:
//   _up_kernel   (:151)  embed-normed input -> 9-entry bf16 skip stack
//   _down_kernel (:178)  skip stack -> (B, HW, F) f32 pre-nin features
// with the same contracts (lmconv_fused_up / lmconv_fused_down below).
//
// Design.  The TPU kernel keeps one candidate's whole activation in VMEM;
// here a candidate's (HW=1024, F=80) f32 activation is 320 KB, more than a
// block's shared memory, so activations stay in device memory (a few MB,
// resident in the 50 MB L2) and each masked conv layer is one launch of
// the layer body in lmconv_layer.cuh (128 positions and all output
// channels a block; cp.async ring over (tap, K slice) steps; wmma; PONO,
// nin skip and gate in the epilogue).  Every conv input is written once,
// by the producing layer's epilogue, as the bf16 operand the next matmul
// reads: concat_elu halves (K = 2F), or bf16(x) (K = F) for the dilated
// convs (the skip stack entry itself in the up pass).  The masks are
// boundary-folded, so the guarded load checks [0, HW) only.
// A gated resnet is two launches (its two convs), a dilated conv one.
//
// Bound on this card (pop 16, 32x32 grid, F=80): ~10.6 GFLOP per
// candidate per forward (dense taps) on bf16 tensor cores against ~70 MB
// of traffic, so compute bounds it (0.17 ms at 989 TFLOP/s); this simple
// version issues wmma from a two-stage ring, without TMA, wgmma or warp
// specialisation, and sits well above that bound (PERF.md).

#include "lmconv_layer.cuh"

using namespace lmk;

namespace {

// From a (B, HW, F) source (f32 u0, or a bf16 stack entry): the f32
// activation u, its elu halves ue, and optionally its bf16 stack entry.
template <typename T>
__global__ void init_kernel(const T* src, long long src_bstride, float* u,
                            bf16* ue, bf16* stack0, long long stack_bstride,
                            int HW, int F, int B) {
  const long long n_per = (long long)HW * F;
  const long long n = n_per * B;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / n_per;
    const long long j = i - b * n_per;
    float v;
    if constexpr (sizeof(T) == 4) v = src[b * src_bstride + j];
    else v = __bfloat162float(src[b * src_bstride + j]);
    u[i] = v;
    if (stack0 != nullptr) stack0[b * stack_bstride + j] = __float2bfloat16(v);
    const long long row = i / F;
    const long long c = i - row * F;
    float pos, neg;
    elu_halves(v, pos, neg);
    ue[row * 2 * F + c] = __float2bfloat16(pos);
    ue[row * 2 * F + F + c] = __float2bfloat16(neg);
  }
}

bool shapes_ok(int H, int W, int F) {
  return (H * W) % TP == 0 && width_ok(F);
}

}  // namespace

extern "C" {

// Up pass (lmconv_fused.py _up_kernel).  Weights of the n_up = 3*nr gated
// resnets: w1 (n_up, 9, 2F, F) bf16, b1 (n_up, F); w2 (n_up, 9, 2F, 2F)
// bf16, b2 (n_up, 2F); dilated convs dw (2, 9, F, F) bf16, db (2, F).
// u0 (B, HW, F) f32; mu/md (B, HW, 9) f32; stack out (B, 3nr+3, HW, F)
// bf16; scratch u_a, u_b (B, HW, F) f32 and ue, xe (B, HW, 2F) bf16.
int lmconv_fused_up(const void* u0, const void* mu, const void* md,
                    const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* dw, const void* db,
                    void* stack, void* u_a, void* u_b, void* ue, void* xe,
                    int B, int H, int W, int F, int nr, int dilation,
                    void* stream) {
  if (!shapes_ok(H, W, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int HW = H * W;
  const long long n_per = (long long)HW * F;
  const long long sb = (long long)(3 * nr + 3) * n_per;
  int s1[9], sd[9];
  make_shifts(s1, W, 1);
  make_shifts(sd, W, dilation);
  float* u[2] = {(float*)u_a, (float*)u_b};
  bf16* uel = (bf16*)ue;
  bf16* xel = (bf16*)xe;
  bf16* stk = (bf16*)stack;
  init_kernel<float><<<264, 256, 0, st>>>((const float*)u0, n_per, u[0], uel,
                                          stk, sb, HW, F, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  int cur = 0, g = 0, s = 1;
  for (int blk = 0; blk < 3; ++blk) {
    for (int r = 0; r < nr; ++r) {
      Layer c1 = conv_layer(uel, 2 * n_per, 2 * F, (const float*)mu,
                            (const bf16*)w1 + (size_t)g * 9 * 2 * F * F,
                            (const float*)b1 + (size_t)g * F, F, s1);
      c1.out_elu = xel;
      if ((e = launch_layer(c1, B, HW, F, st)) != cudaSuccess) return e;
      Layer c2 = conv_layer(xel, 2 * n_per, 2 * F, (const float*)mu,
                            (const bf16*)w2 + (size_t)g * 9 * 4 * F * F,
                            (const float*)b2 + (size_t)g * 2 * F, 2 * F, s1);
      c2.og = u[cur];
      c2.out = u[cur];
      c2.out_elu = uel;
      c2.out_bf = stk + (size_t)s * n_per;
      c2.out_bf_bstride = sb;
      if ((e = launch_layer(c2, B, HW, F, st)) != cudaSuccess) return e;
      ++g;
      ++s;
    }
    if (blk < 2) {
      // the dilated conv reads bf16(u): the stack entry just written
      Layer d = conv_layer(stk + (size_t)(s - 1) * n_per, sb, F,
                           (const float*)md,
                           (const bf16*)dw + (size_t)blk * 9 * F * F,
                           (const float*)db + (size_t)blk * F, F, sd);
      d.out = u[1 - cur];
      d.out_elu = uel;
      d.out_bf = stk + (size_t)s * n_per;
      d.out_bf_bstride = sb;
      if ((e = launch_layer(d, B, HW, F, st)) != cudaSuccess) return e;
      cur = 1 - cur;
      ++s;
    }
  }
  return cudaSuccess;
}

// Down pass (lmconv_fused.py _down_kernel).  n_dn = 3*nr+2 gated resnets:
// w1 (n_dn, 9, 2F, F), b1 (n_dn, F), ws (n_dn, 2F, F), bs (n_dn, F),
// w2 (n_dn, 9, 2F, 2F), b2 (n_dn, 2F); dilated dw (2, 9, F, F), db (2, F).
// The stack is popped top-first from entry 3nr+2.  out (B, HW, F) f32;
// scratch u_b (B, HW, F) f32, ue, xe (B, HW, 2F) bf16, ubf (B, HW, F) bf16.
int lmconv_fused_down(const void* stack, const void* mu, const void* md,
                      const void* w1, const void* b1, const void* ws,
                      const void* bs, const void* w2, const void* b2,
                      const void* dw, const void* db, void* out, void* u_b,
                      void* ue, void* xe, void* ubf, int B, int H, int W,
                      int F, int nr, int dilation, void* stream) {
  if (!shapes_ok(H, W, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int HW = H * W;
  const long long n_per = (long long)HW * F;
  const long long sb = (long long)(3 * nr + 3) * n_per;
  int s1[9], sd[9];
  make_shifts(s1, W, 1);
  make_shifts(sd, W, dilation);
  float* u[2] = {(float*)out, (float*)u_b};
  bf16* uel = (bf16*)ue;
  bf16* xel = (bf16*)xe;
  bf16* ub = (bf16*)ubf;
  const bf16* stk = (const bf16*)stack;
  init_kernel<bf16><<<264, 256, 0, st>>>(stk + (size_t)(3 * nr + 2) * n_per, sb,
                                         u[0], uel, nullptr, 0, HW, F, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int down_nr[3] = {nr, nr + 1, nr + 1};
  int cur = 0, g = 0, top = 3 * nr + 1;
  for (int i = 0; i < 3; ++i) {
    for (int r = 0; r < down_nr[i]; ++r) {
      Layer c1 = conv_layer(uel, 2 * n_per, 2 * F, (const float*)mu,
                            (const bf16*)w1 + (size_t)g * 9 * 2 * F * F,
                            (const float*)b1 + (size_t)g * F, F, s1);
      c1.skip = stk + (size_t)top * n_per;
      c1.skip_bstride = sb;
      c1.ws = (const bf16*)ws + (size_t)g * 2 * F * F;
      c1.bs = (const float*)bs + (size_t)g * F;
      c1.out_elu = xel;
      if ((e = launch_layer(c1, B, HW, F, st)) != cudaSuccess) return e;
      Layer c2 = conv_layer(xel, 2 * n_per, 2 * F, (const float*)mu,
                            (const bf16*)w2 + (size_t)g * 9 * 4 * F * F,
                            (const float*)b2 + (size_t)g * 2 * F, 2 * F, s1);
      c2.og = u[cur];
      c2.out = u[cur];
      c2.out_elu = uel;
      c2.out_bf = ub;  // the dilated conv's operand
      c2.out_bf_bstride = n_per;
      if ((e = launch_layer(c2, B, HW, F, st)) != cudaSuccess) return e;
      ++g;
      --top;
    }
    if (i < 2) {
      Layer d = conv_layer(ub, n_per, F, (const float*)md,
                           (const bf16*)dw + (size_t)i * 9 * F * F,
                           (const float*)db + (size_t)i * F, F, sd);
      d.out = u[1 - cur];
      d.out_elu = uel;
      if ((e = launch_layer(d, B, HW, F, st)) != cudaSuccess) return e;
      cur = 1 - cur;
    }
  }
  return cudaSuccess;
}

}  // extern "C"
