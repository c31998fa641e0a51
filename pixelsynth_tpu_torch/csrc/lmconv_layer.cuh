// One locally-masked conv layer on a 128-position tile, for Hopper
// (sm_90a): the body shared by K1 (lmconv_fused.cu: one launch per conv of
// the fused trunk), K3 (masked_conv.cu: the stand-alone masked conv) and K4
// (gated_resnet.cu: both convs of a gated resnet in one cluster launch).
//
// A block owns TP=128 flat positions of one candidate and ALL output
// channels, so PONO (a reduction over channels) and the gate fuse into the
// epilogue:
//   * every conv input lies in device memory as the bf16 operand the
//     matmul reads: concat_elu halves [elu(x) | elu(-x)] (K = 2F) or
//     bf16(x) (K = F);
//   * the reduction runs over steps of (tap t, F-wide slice of K): a step
//     is the block's 128 source rows p+s_t of that slice and the matching
//     (F x N) weight rows.  Steps go through a two-stage ring in shared
//     memory, copied with cp.async (16 bytes a thread) so that step i+1's
//     copy overlaps step i's products; rows whose mask is 0 are
//     zero-filled.  The shifted load is guarded: a source row outside
//     [0, HW) -- or, when the layer carries the image's width, outside the
//     image's rows and columns -- is never read (it would be another row's
//     or another candidate's data, and 0 * NaN = NaN);
//   * the steps accumulate in f32 on the tensor cores (wmma 16x16x16,
//     bf16 operands from shared memory).  F and the output width are
//     template parameters, so each step's fragment loads are unrolled; on
//     the N=2F convs a warp's B fragment serves two row tiles (WarpTile);
//   * the epilogue adds the bias and either stores the f32 result as it is
//     (`linear`, K3), or applies PONO (ddof=1; E[x^2] - mean^2, or the
//     two-pass form when `pono_two_pass`), the nin skip, or the gate
//     og + pono(a) * sigmoid(g), and writes what the next layers read: the
//     f32 activation, its elu halves, its bf16 copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace lmk {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int TP = 128;        // flat positions per block
constexpr int NTHREADS = 256;  // 8 warps
constexpr int MAXFRAG = 10;    // accumulator tiles per warp (F <= 80)
constexpr float PONO_EPS = 1e-5f;

struct Layer {
  const bf16* a;           // conv operand rows (B, HW, K) bf16
  long long a_bstride;     // elements between candidates
  int K;                   // 2F (elu halves) or F (bf16 copy)
  const float* mask;       // (B, HW, 9) masks
  const bf16* w;           // (9, K, nout)
  const float* bias;       // (nout)
  int nout;                // F, or 2F (the gated second conv; a wide linear conv)
  const bf16* skip;        // nin skip input as a bf16 (B, HW, F) entry, or null
  long long skip_bstride;
  const float* skip32;     // nin skip input as f32 (B, HW, F), or null
  const bf16* ws;          // (2F, F)
  const float* bs;         // (F)
  const float* og;         // gate residual (may alias out)
  float* out;              // (B, HW, F) f32 ((B, HW, nout) when linear), or null
  bf16* out_elu;           // (B, HW, 2F) elu halves, or null
  bf16* out_bf;            // bf16 copy of out (stack entry / buffer), or null
  long long out_bf_bstride;
  int shifts[9];
  // Image geometry for the guarded load.  img_w == 0: the masks are
  // boundary-folded, only [0, HW) is checked.  img_w > 0: tap t moves by
  // (dr[t], dc[t]) rows and columns and a source outside the img_h x img_w
  // image is zero (the raw masks know nothing of the border).
  int img_w, img_h;
  int dr[9], dc[9];
  int linear;              // epilogue: out = conv + bias, nothing else
  int pono_two_pass;       // PONO variance as sum((x - mean)^2), not E[x^2] - mean^2
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// Start the copy of ring step `step` = (tap t, K slice kc): TP operand rows
// (p0 + r + shift_t) of columns [kc*F, kc*F + F) of a (HW, K) bf16 matrix
// into As (zero-filled where the row leaves [0, HW) or the image, or its
// mask is 0), and the weight rows t*K + kc*F + [0, F) of the (9, K, NOUT)
// taps into Ws.
template <int F, int NOUT>
__device__ void copy_step(bf16* As, bf16* Ws, const Layer& L,
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
    bool ok = s >= 0 && s < HW && mbase[(size_t)p * 9 + t] != 0.f;
    if (L.img_w > 0) {
      const int row = p / L.img_w;
      const int rr = row + L.dr[t];
      const int cc = p - row * L.img_w + L.dc[t];
      ok = ok && rr >= 0 && rr < L.img_h && cc >= 0 && cc < L.img_w;
    }
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

// Stage the elu halves of TP unshifted rows of a (HW, F) matrix (bf16 or
// f32 in device memory).
template <int F, typename T>
__device__ void stage_elu_rows(bf16* As, const T* src, int p0) {
  constexpr int lda = 2 * F + 8;
  for (int idx = threadIdx.x; idx < TP * F; idx += NTHREADS) {
    const int r = idx / F;
    const int c = idx - r * F;
    float pos, neg;
    elu_halves(to_float(src[(size_t)(p0 + r) * F + c]), pos, neg);
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

__device__ inline void zero_acc(Acc (&acc)[MAXFRAG]) {
#pragma unroll
  for (int i = 0; i < MAXFRAG; ++i) wmma::fill_fragment(acc[i], 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One masked conv layer of width F on the TP positions from p0 of
// candidate b.  WIDE: nout = 2F (the gated resnet's second conv, output
// og + pono(a) * sigmoid(g), or a wide linear conv), else nout = F (PONO,
// or linear).  `smem` is the block's smem_bytes(F) of dynamic shared
// memory; every thread of the block calls this, and the last thing it
// does with `smem` is read it.
template <int F, bool WIDE>
__device__ void layer_body(const Layer& L, int HW, int b, int p0,
                           unsigned char* smem) {
  constexpr int NOUT = WIDE ? 2 * F : F;
  constexpr int ldc = NOUT + 4;
  constexpr int lds = F + 4;
  constexpr int EPC = (F + 31) / 32;  // channels a lane takes in the epilogue
  float* Ss = reinterpret_cast<float*>(smem + ring_bytes(F));
  float* Cs = reinterpret_cast<float*>(smem);  // reuses the ring after the taps

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool has_skip = L.skip != nullptr || L.skip32 != nullptr;
  Acc acc[MAXFRAG];

  if (has_skip) {
    // nin skip: elu-halves(a) @ ws, kept apart because it is added AFTER
    // the conv's PONO
    bf16* As = reinterpret_cast<bf16*>(smem);
    bf16* Ws = reinterpret_cast<bf16*>(smem + skip_a_bytes(F));
    if (L.skip != nullptr)
      stage_elu_rows<F>(As, L.skip + b * L.skip_bstride, p0);
    else
      stage_elu_rows<F>(As, L.skip32 + (size_t)b * HW * F, p0);
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
  copy_step<F, NOUT>(ring_a[0], ring_w[0], L, src, mbase, HW, p0, 0);
  cp_async_commit();
  zero_acc(acc);
  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) {
      // the stage being refilled was last read by step i-1, whose trailing
      // barrier every thread has passed
      copy_step<F, NOUT>(ring_a[(i + 1) & 1], ring_w[(i + 1) & 1], L, src,
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

  if (L.linear) {
    // conv + bias, stored as f32 rows of NOUT
    for (int idx = threadIdx.x; idx < TP * NOUT; idx += NTHREADS) {
      const int r = idx / NOUT;
      const int c = idx - r * NOUT;
      L.out[((size_t)b * HW + p0 + r) * NOUT + c] = Cs[r * ldc + c] + L.bias[c];
    }
    return;
  }

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
        if (WIDE) {
          g[j] = crow[F + c] + L.bias[F + c];
          og[j] = L.og[o + c];
        }
        if (has_skip) sk[j] = Ss[r * lds + c] + L.bs[c];
        s1 += x[j];
        s2 += x[j] * x[j];
      }
    }
    s1 = warp_sum(s1);
    const float mean = s1 / F;
    float var;
    if (L.pono_two_pass) {
      float d2 = 0.f;
#pragma unroll
      for (int j = 0; j < EPC; ++j) {
        const float d = x[j] - mean;
        if (lane + 32 * j < F) d2 += d * d;
      }
      var = warp_sum(d2) / (F - 1);
    } else {
      s2 = warp_sum(s2);
      var = (s2 - F * mean * mean) / (F - 1);
    }
    const float rsd = rsqrtf(var + PONO_EPS);
#pragma unroll
    for (int j = 0; j < EPC; ++j) {
      const int c = lane + 32 * j;
      if (c >= F) continue;
      float y = (x[j] - mean) * rsd;
      if (has_skip) y = y + sk[j];
      if (WIDE) y = og[j] + y * __frcp_rn(1.f + __expf(-g[j]));
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

// One launch of a layer: a block per TP positions of one candidate.
template <int F, bool WIDE>
__global__ void __launch_bounds__(NTHREADS, 1)
layer_kernel(Layer L, int HW) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles = HW / TP;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - b * tiles) * TP;
  layer_body<F, WIDE>(L, HW, b, p0, smem);
}

// `static`: each library that includes this header has its own copy of the
// kernel, so it needs its own flag too (a local static of a function with
// external linkage is one object across every library loaded).
template <int F, bool WIDE>
static cudaError_t launch_layer_as(const Layer& L, int B, int HW,
                                   cudaStream_t st) {
  constexpr size_t smem = smem_bytes(F);
  // the shared-memory attribute is set once per instantiation and device
  static int attr_dev = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != attr_dev) {
    e = cudaFuncSetAttribute(
        layer_kernel<F, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    attr_dev = dev;
  }
  layer_kernel<F, WIDE><<<B * HW / TP, NTHREADS, smem, st>>>(L, HW);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_layer_of(const Layer& L, int B, int HW, cudaStream_t st) {
  return L.nout == 2 * F ? launch_layer_as<F, true>(L, B, HW, st)
                         : launch_layer_as<F, false>(L, B, HW, st);
}

// Launch layer L of width F (a multiple of 16 up to 80; L.nout is F or 2F)
// on B candidates of HW positions, HW a multiple of TP.
inline cudaError_t launch_layer(const Layer& L, int B, int HW, int F,
                                cudaStream_t st) {
  if (HW % TP != 0 || (L.nout != F && L.nout != 2 * F))
    return cudaErrorInvalidValue;
  switch (F) {
    case 16: return launch_layer_of<16>(L, B, HW, st);
    case 32: return launch_layer_of<32>(L, B, HW, st);
    case 48: return launch_layer_of<48>(L, B, HW, st);
    case 64: return launch_layer_of<64>(L, B, HW, st);
    case 80: return launch_layer_of<80>(L, B, HW, st);
    default: return cudaErrorInvalidValue;
  }
}

// Flat shift of tap (i, j) of a 3x3 kernel with dilation d on a width-W grid.
inline void make_shifts(int* s, int W, int d) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) s[i * 3 + j] = (i - 1) * d * W + (j - 1) * d;
}

inline Layer conv_layer(const bf16* a, long long a_bstride, int K,
                        const float* mask, const bf16* w, const float* bias,
                        int nout, const int* shifts) {
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

// Make the layer zero-pad at the border of an H x W image itself (raw,
// unfolded masks).
inline void guard_image(Layer& L, int H, int W, int d) {
  L.img_w = W;
  L.img_h = H;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      L.dr[i * 3 + j] = (i - 1) * d;
      L.dc[i * 3 + j] = (j - 1) * d;
    }
}

inline bool width_ok(int F) { return F % 16 == 0 && F >= 16 && F <= 80; }

}  // namespace lmk
