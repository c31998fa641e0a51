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
// block's shared memory.  A pass is ONE persistent launch
// (lmconv_pass.cuh): a block owns 128 positions of one candidate, keeps
// their f32 activation in its shared memory and runs every layer of the
// pass in order, waiting only for the counters of the tiles its operand
// rows come from; a layer's operand rows come into shared memory once and
// each tap reads them at its row offset (built with LMK_MULTICAST, the two
// blocks of a cluster share every weight copy).  Every conv input
// is written once, by the producing layer's epilogue, as the bf16 operand
// the next matmul reads: concat_elu halves (K = 2F), or bf16(x) (K = F)
// for the dilated convs (the skip stack entry itself in the up pass).  The
// masks are boundary-folded, so a row is read where its mask is on and its
// source lies in [0, HW).
//
// Bound on this card (pop 16, 32x32 grid, F=80): the products the masks
// leave on (0.039 / 0.054 ms up / down at 989 TFLOP/s bf16) against a few
// tens of MB of device memory; inside the card, the weights and operand
// rows that move from L2 to the SMs (PERF.md): ~0.16 ms a forward at
// ~5.5 TB/s with multicast and rows once a tile (~0.24 ms without).

#include "lmconv_pass.cuh"

using namespace lmk;

namespace {

pass::Args common(const void* mu, const void* md, const void* tu, const void* td,
                  void* ue, void* xe, void* flags, void* stamps, int B, int H, int W,
                  int F, int nr, int dilation, int win, unsigned long long epoch) {
  pass::Args a = {};
  a.B = B;
  a.HW = H * W;
  a.F = F;
  a.nr = nr;
  a.win = win;
  a.epoch = epoch;
  a.mu = (const float*)mu;
  a.md = (const float*)md;
  a.tu = (const int*)tu;
  a.td = (const int*)td;
  a.ue = (bf16*)ue;
  a.xe = (bf16*)xe;
  a.flags = (unsigned long long*)flags;
  a.stamps = (unsigned long long*)stamps;
  make_shifts(a.s1, W, 1);
  make_shifts(a.sd, W, dilation);
  return a;
}

}  // namespace

extern "C" {

// Up pass (lmconv_fused.py _up_kernel).  Weights of the n_up = 3*nr gated
// resnets: w1 (n_up, 9, 2F, F) bf16, b1 (n_up, F); w2 (n_up, 9, 2F, 2F)
// bf16, b2 (n_up, 2F); dilated convs dw (2, 9, F, F) bf16, db (2, F);
// every conv weight as its packed image (ops/conv_pack.py).
// u0 (B, HW, F) f32; mu/md (B, HW, 9) f32 and their tile tables tu/td
// (B, HW/128, 9) int32; stack out (B, 3nr+3, HW, F) bf16; scratch ue, xe
// (B, HW, 2F) bf16; flags (B * HW/128 + 1) uint64 counters, zero once when
// made; epoch one more than the last call's on these flags; win the tiles
// each side a layer reads (ops/lmconv_fused.py dependency_window); stamps
// null, or (grid, 256) uint64 in an LMK_STAMPS build.
int lmconv_fused_up(const void* u0, const void* mu, const void* md, const void* tu,
                    const void* td, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* dw, const void* db, void* stack,
                    void* ue, void* xe, void* flags, void* stamps,
                    int B, int H, int W, int F, int nr, int dilation, int win,
                    unsigned long long epoch, void* stream) {
  pass::Args a = common(mu, md, tu, td, ue, xe, flags, stamps, B, H, W, F, nr, dilation,
                        win, epoch);
  a.up = 1;
  a.u0 = (const float*)u0;
  a.stack = (bf16*)stack;
  a.w1 = (const bf16*)w1;
  a.b1 = (const float*)b1;
  a.w2 = (const bf16*)w2;
  a.b2 = (const float*)b2;
  a.dw = (const bf16*)dw;
  a.db = (const float*)db;
  return (int)pass::run_pass(a, (cudaStream_t)stream);
}

// Down pass (lmconv_fused.py _down_kernel).  n_dn = 3*nr+2 gated resnets:
// w1 (n_dn, 9, 2F, F), b1 (n_dn, F), ws (n_dn, 2F, F), bs (n_dn, F),
// w2 (n_dn, 9, 2F, 2F), b2 (n_dn, 2F); dilated dw (2, 9, F, F), db (2, F).
// The stack is popped top-first from entry 3nr+2.  out (B, HW, F) f32;
// scratch ue, xe (B, HW, 2F) bf16, ubf (B, HW, F) bf16; flags, stamps,
// win, epoch as for the up pass.
int lmconv_fused_down(const void* stack, const void* mu, const void* md, const void* tu,
                      const void* td, const void* w1, const void* b1, const void* ws,
                      const void* bs, const void* w2, const void* b2, const void* dw,
                      const void* db, void* out, void* ue, void* xe, void* ubf,
                      void* flags, void* stamps, int B, int H, int W, int F, int nr,
                      int dilation, int win, unsigned long long epoch, void* stream) {
  pass::Args a = common(mu, md, tu, td, ue, xe, flags, stamps, B, H, W, F, nr, dilation,
                        win, epoch);
  a.up = 0;
  a.stack = (bf16*)stack;   // read only
  a.w1 = (const bf16*)w1;
  a.b1 = (const float*)b1;
  a.ws = (const bf16*)ws;
  a.bs = (const float*)bs;
  a.w2 = (const bf16*)w2;
  a.b2 = (const float*)b2;
  a.dw = (const bf16*)dw;
  a.db = (const float*)db;
  a.out = (float*)out;
  a.ubf = (bf16*)ubf;
  return (int)pass::run_pass(a, (cudaStream_t)stream);
}

// Candidates a pass runs at once at width F on HW positions (groups of
// HW/128 blocks the card keeps resident), or minus a CUDA error.
int lmconv_fused_groups(int F, int HW) {
  int groups = 0;
  const cudaError_t e = pass::query_groups(F, HW, &groups);
  return e == cudaSuccess ? groups : -(int)e;
}

// Blocks of one cluster (1; 2 in an LMK_MULTICAST build, whose blocks
// share the weights' copies).
int lmconv_fused_cluster() { return pass::CLUSTER; }

}  // extern "C"
