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
// resident in the 50 MB L2) and each masked conv layer is one launch.  A
// block owns TP=128 flat positions of one candidate and ALL output
// channels, so PONO (a reduction over channels) and the gate fuse into the
// epilogue:
//   * every conv input is kept in device memory as the bf16 operand the
//     matmul reads: concat_elu halves [elu(x) | elu(-x)] (K = 2F) written
//     once by the producing layer's epilogue, or bf16(x) (K = F) for the
//     dilated convs (the skip stack entry itself in the up pass);
//   * the reduction runs over steps of (tap t, F-wide slice of K): a step
//     is the block's 128 source rows p+s_t of that slice and the matching
//     (F x N) weight rows.  Steps go through a two-stage ring in shared
//     memory, copied with cp.async (16 bytes a thread) so that step i+1's
//     copy overlaps step i's products; rows whose folded mask is 0 are
//     zero-filled.  The shifted load is guarded: a source row outside
//     [0, HW) is never read (it would be another candidate's rows, and
//     0 * NaN = NaN).  With 128 positions a block, every weight row copied
//     serves twice the rows it served at 64 (~140 KB of shared memory at
//     F=80: one block on an SM);
//   * the steps accumulate in f32 on the tensor cores (wmma 16x16x16,
//     bf16 operands from shared memory).  F and the output width are
//     template parameters, so each step's fragment loads are unrolled; on
//     the N=2F convs a warp's B fragment serves two row tiles (WarpTile);
//   * the epilogue adds the bias and applies PONO (E[x^2] - mean^2 with
//     ddof=1, as _pono_dot at :54-63), the nin skip, or the gate
//     og + pono(a) * sigmoid(g), and writes what the next layers read:
//     the f32 activation, its elu halves, its bf16 copy / stack entry.
// A gated resnet is two launches (its two convs), a dilated conv one.
//
// Bound on this card (pop 16, 32x32 grid, F=80): ~10.6 GFLOP per
// candidate per forward (dense taps) on bf16 tensor cores against ~70 MB
// of traffic, so compute bounds it (0.17 ms at 989 TFLOP/s); this simple
// version issues wmma from a two-stage ring, without TMA, wgmma or warp
// specialisation, and sits well above that bound (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TP = 128;        // flat positions per block
constexpr int NTHREADS = 256;  // 8 warps
constexpr int MAXFRAG = 10;    // accumulator tiles per warp (F <= 80)
constexpr float PONO_EPS = 1e-5f;

struct Layer {
  const bf16* a;           // conv operand rows (B, HW, K) bf16
  long long a_bstride;     // elements between candidates
  int K;                   // 2F (elu halves) or F (bf16 copy)
  const float* mask;       // (B, HW, 9) boundary-folded masks
  const bf16* w;           // (9, K, nout)
  const float* bias;       // (nout)
  int nout;                // F (PONO), or 2F for the gated second conv
  const bf16* skip;        // nin skip input (bf16 stack entry) or null
  long long skip_bstride;
  const bf16* ws;          // (2F, F)
  const float* bs;         // (F)
  const float* og;         // gate residual (may alias out)
  float* out;              // (B, HW, F) f32, or null
  bf16* out_elu;           // (B, HW, 2F) elu halves, or null
  bf16* out_bf;            // bf16 copy of out (stack entry / buffer), or null
  long long out_bf_bstride;
  int shifts[9];
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;

// Shared memory: a two-stage ring of (A slice TP x F, W slice F x nout)
// steps, then the nin skip's result Ss (TP x F f32).  Before the ring runs
// its space holds the skip's operands (TP x 2F and 2F x F); after, the
// conv's result Cs (TP x nout f32).
__host__ __device__ constexpr size_t a_step_bytes(int F) {
  return (size_t)TP * (F + 8) * sizeof(bf16);
}
__host__ __device__ constexpr size_t step_bytes(int F) {
  return a_step_bytes(F) + (size_t)F * (2 * F + 8) * sizeof(bf16);
}
__host__ __device__ constexpr size_t skip_a_bytes(int F) {
  return (size_t)TP * (2 * F + 8) * sizeof(bf16);
}
__host__ __device__ constexpr size_t max3(size_t a, size_t b, size_t c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}
__host__ __device__ constexpr size_t ring_bytes(int F) {
  return max3(2 * step_bytes(F),
              skip_a_bytes(F) + (size_t)(2 * F) * (F + 8) * sizeof(bf16),
              (size_t)TP * (2 * F + 4) * sizeof(float));
}
__host__ __device__ constexpr size_t smem_bytes(int F) {
  return ring_bytes(F) + (size_t)TP * (F + 4) * sizeof(float);
}

// 16-byte global -> shared copy; with pred false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void elu_halves(float v, float& pos, float& neg) {
  const float e = __expf(-fabsf(v)) - 1.f;
  pos = v > 0.f ? v : e;
  neg = v < 0.f ? -v : e;
}

// Start the copy of ring step `step` = (tap t, K slice kc): TP operand rows
// (p0 + r + shift_t) of columns [kc*F, kc*F + F) of a (HW, K) bf16 matrix
// into As (zero-filled where the row leaves [0, HW) or its mask is 0), and
// the weight rows t*K + kc*F + [0, F) of the (9, K, NOUT) taps into Ws.
template <int F, int NOUT>
__device__ void issue_step(bf16* As, bf16* Ws, const Layer& L,
                           const bf16* src, const float* mbase, int HW,
                           int p0, int step) {
  const int nk = L.K / F;
  const int t = step / nk;
  const int kc = step - t * nk;
  constexpr int vpr = F / 8;
  const int shift = L.shifts[t];
  for (int idx = threadIdx.x; idx < TP * vpr; idx += NTHREADS) {
    const int r = idx / vpr;
    const int v = idx - r * vpr;
    const int p = p0 + r;
    const int s = p + shift;
    const bool ok = s >= 0 && s < HW && mbase[(size_t)p * 9 + t] != 0.f;
    const bf16* g = ok ? src + (size_t)s * L.K + kc * F + v * 8 : src;
    cp_async16(As + r * (F + 8) + v * 8, g, ok);
  }
  constexpr int vw = NOUT / 8;
  const bf16* W = L.w + ((size_t)t * L.K + kc * F) * NOUT;
  for (int idx = threadIdx.x; idx < F * vw; idx += NTHREADS) {
    const int k = idx / vw;
    const int v = idx - k * vw;
    cp_async16(Ws + k * (NOUT + 8) + v * 8, W + (size_t)k * NOUT + v * 8, true);
  }
}

// Stage the elu halves of TP unshifted rows of a (HW, F) bf16 matrix.
template <int F>
__device__ void stage_elu_rows(bf16* As, const bf16* src, int p0) {
  constexpr int lda = 2 * F + 8;
  for (int idx = threadIdx.x; idx < TP * F; idx += NTHREADS) {
    const int r = idx / F;
    const int c = idx - r * F;
    float pos, neg;
    elu_halves(__bfloat162float(src[(size_t)(p0 + r) * F + c]), pos, neg);
    As[r * lda + c] = __float2bfloat16(pos);
    As[r * lda + F + c] = __float2bfloat16(neg);
  }
}

// Copy a (K, N) bf16 weight matrix into Ws (row stride N + 8).
template <int K, int N>
__device__ void stage_w(bf16* Ws, const bf16* W) {
  constexpr int vpr = N / 8;
  for (int idx = threadIdx.x; idx < K * vpr; idx += NTHREADS) {
    const int k = idx / vpr;
    const int v = idx - k * vpr;
    *reinterpret_cast<uint4*>(Ws + k * (N + 8) + v * 8) =
        *reinterpret_cast<const uint4*>(W + (size_t)k * N + v * 8);
  }
}

// Warp tiles of a (TP x N) product of layer width F, for 8 warps.  N = 2F:
// warp w owns the 32 rows 32(w % 4) + [0, 32) and the F columns
// F(w / 4) + [0, F), so each B fragment it loads serves two row tiles.
// N = F: warp w owns the 16 rows 16w + [0, 16) and all F columns.  Either
// way a warp holds RT * F/16 accumulator tiles, acc[r * F/16 + c].
template <int N, int F>
struct WarpTile {
  static constexpr bool WIDE = N == 2 * F;
  static constexpr int RT = WIDE ? 2 : 1;
  static constexpr int CT = F / 16;
  __device__ static int row0() {
    const int w = threadIdx.x >> 5;
    return WIDE ? (w & 3) * 32 : w * 16;
  }
  __device__ static int col0() { return WIDE ? (threadIdx.x >> 7) * F : 0; }
};

// acc += As(this warp's rows, K) @ Ws(K, N)[:, this warp's columns].
template <int K, int N, int F>
__device__ __forceinline__ void mma_step(Acc (&acc)[MAXFRAG], const bf16* As,
                                         const bf16* Ws) {
  typedef WarpTile<N, F> T;
  constexpr int lda = K + 8;
  constexpr int ldw = N + 8;
  const int row0 = T::row0();
  const int col0 = T::col0();
  FragA a[T::RT];
  FragB bf;
#pragma unroll
  for (int kt = 0; kt < K / 16; ++kt) {
#pragma unroll
    for (int r = 0; r < T::RT; ++r)
      wmma::load_matrix_sync(a[r], As + (row0 + 16 * r) * lda + kt * 16, lda);
#pragma unroll
    for (int c = 0; c < T::CT; ++c) {
      wmma::load_matrix_sync(bf, Ws + kt * 16 * ldw + col0 + 16 * c, ldw);
#pragma unroll
      for (int r = 0; r < T::RT; ++r)
        wmma::mma_sync(acc[r * T::CT + c], a[r], bf, acc[r * T::CT + c]);
    }
  }
}

template <int N, int F>
__device__ void store_acc(Acc (&acc)[MAXFRAG], float* Cs, int ldc) {
  typedef WarpTile<N, F> T;
  const int row0 = T::row0();
  const int col0 = T::col0();
#pragma unroll
  for (int r = 0; r < T::RT; ++r)
#pragma unroll
    for (int c = 0; c < T::CT; ++c)
      wmma::store_matrix_sync(Cs + (row0 + 16 * r) * ldc + col0 + 16 * c,
                              acc[r * T::CT + c], ldc, wmma::mem_row_major);
}

__device__ void zero_acc(Acc (&acc)[MAXFRAG]) {
#pragma unroll
  for (int i = 0; i < MAXFRAG; ++i) wmma::fill_fragment(acc[i], 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One masked conv layer of width F; GATE: the gated resnet's second conv
// (nout = 2F, output og + pono(a) * sigmoid(g)), else nout = F with PONO.
template <int F, bool GATE>
__global__ void __launch_bounds__(NTHREADS, 1)
lmconv_layer_kernel(Layer L, int HW) {
  constexpr int NOUT = GATE ? 2 * F : F;
  constexpr int ldc = NOUT + 4;
  constexpr int lds = F + 4;
  constexpr int EPC = (F + 31) / 32;  // channels a lane takes in the epilogue
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ss = reinterpret_cast<float*>(smem + ring_bytes(F));
  float* Cs = reinterpret_cast<float*>(smem);  // reuses the ring after the taps

  const int tiles = HW / TP;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - b * tiles) * TP;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Acc acc[MAXFRAG];

  if (L.skip != nullptr) {
    // nin skip: elu-halves(a) @ ws, kept apart because it is added AFTER
    // the conv's PONO (lmconv_fused.py:140-145)
    bf16* As = reinterpret_cast<bf16*>(smem);
    bf16* Ws = reinterpret_cast<bf16*>(smem + skip_a_bytes(F));
    stage_elu_rows<F>(As, L.skip + b * L.skip_bstride, p0);
    stage_w<2 * F, F>(Ws, L.ws);
    __syncthreads();
    zero_acc(acc);
    mma_step<2 * F, F, F>(acc, As, Ws);
    store_acc<F, F>(acc, Ss, lds);
    __syncthreads();
  }

  bf16* ring_a[2];
  bf16* ring_w[2];
  for (int i = 0; i < 2; ++i) {
    ring_a[i] = reinterpret_cast<bf16*>(smem + i * step_bytes(F));
    ring_w[i] = reinterpret_cast<bf16*>(smem + i * step_bytes(F) + a_step_bytes(F));
  }
  const bf16* src = L.a + b * L.a_bstride;
  const float* mbase = L.mask + (size_t)b * HW * 9;
  const int n_steps = 9 * (L.K / F);
  issue_step<F, NOUT>(ring_a[0], ring_w[0], L, src, mbase, HW, p0, 0);
  cp_async_commit();
  zero_acc(acc);
  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) {
      // the stage being refilled was last read by step i-1, whose trailing
      // barrier every thread has passed
      issue_step<F, NOUT>(ring_a[(i + 1) & 1], ring_w[(i + 1) & 1], L, src,
                          mbase, HW, p0, i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_step<F, NOUT, F>(acc, ring_a[i & 1], ring_w[i & 1]);
    __syncthreads();
  }
  store_acc<NOUT, F>(acc, Cs, ldc);
  __syncthreads();

  // epilogue: one warp per position, lane l takes channels l + 32j
  for (int r = warp; r < TP; r += NTHREADS / 32) {
    const int p = p0 + r;
    const size_t o = ((size_t)b * HW + p) * F;
    const float* crow = Cs + r * ldc;
    float x[EPC], g[EPC], og[EPC], sk[EPC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < EPC; ++j) {
      const int c = lane + 32 * j;
      x[j] = g[j] = og[j] = sk[j] = 0.f;
      if (c < F) {
        x[j] = crow[c] + L.bias[c];
        if (GATE) {
          g[j] = crow[F + c] + L.bias[F + c];
          og[j] = L.og[o + c];
        }
        if (L.skip != nullptr) sk[j] = Ss[r * lds + c] + L.bs[c];
        s1 += x[j];
        s2 += x[j] * x[j];
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mean = s1 / F;
    const float var = (s2 - F * mean * mean) / (F - 1);
    const float rsd = rsqrtf(var + PONO_EPS);
#pragma unroll
    for (int j = 0; j < EPC; ++j) {
      const int c = lane + 32 * j;
      if (c >= F) continue;
      float y = (x[j] - mean) * rsd;
      if (L.skip != nullptr) y = y + sk[j];
      if (GATE) y = og[j] + y * __frcp_rn(1.f + __expf(-g[j]));
      if (L.out != nullptr) L.out[o + c] = y;
      if (L.out_bf != nullptr)
        L.out_bf[b * L.out_bf_bstride + (size_t)p * F + c] = __float2bfloat16(y);
      if (L.out_elu != nullptr) {
        float pos, neg;
        elu_halves(y, pos, neg);
        L.out_elu[2 * o + c] = __float2bfloat16(pos);
        L.out_elu[2 * o + F + c] = __float2bfloat16(neg);
      }
    }
  }
}

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

void make_shifts(int* s, int W, int d) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) s[i * 3 + j] = (i - 1) * d * W + (j - 1) * d;
}

template <int F, bool GATE>
cudaError_t launch_width(const Layer& L, int B, int HW, cudaStream_t st) {
  constexpr size_t smem = smem_bytes(F);
  cudaError_t e = cudaFuncSetAttribute(
      lmconv_layer_kernel<F, GATE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  lmconv_layer_kernel<F, GATE><<<B * HW / TP, NTHREADS, smem, st>>>(L, HW);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_gate(const Layer& L, int B, int HW, cudaStream_t st) {
  return L.nout == 2 * F ? launch_width<F, true>(L, B, HW, st)
                         : launch_width<F, false>(L, B, HW, st);
}

cudaError_t launch_layer(const Layer& L, int B, int HW, int F,
                         cudaStream_t st) {
  switch (F) {
    case 16: return launch_gate<16>(L, B, HW, st);
    case 32: return launch_gate<32>(L, B, HW, st);
    case 48: return launch_gate<48>(L, B, HW, st);
    case 64: return launch_gate<64>(L, B, HW, st);
    case 80: return launch_gate<80>(L, B, HW, st);
    default: return cudaErrorInvalidValue;
  }
}

bool shapes_ok(int H, int W, int F) {
  return (H * W) % TP == 0 && F % 16 == 0 && F >= 16 && F <= 80;
}

Layer conv_layer(const bf16* a, long long a_bstride, int K, const float* mask,
                 const bf16* w, const float* bias, int nout,
                 const int* shifts) {
  Layer L = {};
  L.a = a;
  L.a_bstride = a_bstride;
  L.K = K;
  L.mask = mask;
  L.w = w;
  L.bias = bias;
  L.nout = nout;
  for (int t = 0; t < 9; ++t) L.shifts[t] = shifts[t];
  return L;
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
