// One locally-masked conv layer on a 128-position tile, for Hopper
// (sm_90a): the body of K4 (gated_resnet.cu: both convs of a gated resnet
// in one cooperative launch) and of K3's streamed route (masked_conv.cu:
// the stand-alone masked conv on grids whose rows and halo exceed the
// resident region).  K1's persistent pass (lmconv_pass.cuh) and K3's
// resident route have a body of their own (resident_rows.cuh) and share
// the helpers, `Layer` and the epilogue.
//
// A block owns TP=128 flat positions of one candidate and ALL output
// channels, so PONO (a reduction over channels) and the gate fuse into the
// epilogue.  Operations bound the layer on this card (the .cu files give
// the numbers); what it took before was the sum of its parts, since the
// warps that multiplied also copied, one step ahead, between two block-wide
// barriers a step.  Now the parts overlap:
//   * the reduction runs over steps of (tap t, F-wide slice of K): a step
//     is the block's 128 source rows p+s_t of that slice and the matching
//     (F x N) weights.  A (tile, tap) whose mask is 0 at all 128 positions
//     is no step at all (`tile_taps`, a table made with the mask, outside
//     the sampling loop): nobody copies it, nobody waits for it;
//   * three warpgroups.  The PRODUCER (128 threads) only copies: it fills
//     a ring of STAGES=4 stages in shared memory and never multiplies.  The
//     operand rows come by cp.async, 16 bytes a thread, zero-filled where
//     the row's on/off bit for the tap is 0 -- mask 0, or a source outside
//     [0, HW) or (raw masks, `guard_image`) outside the image; such a row
//     is never read, since 0 * NaN = NaN.  With f32 operand rows (A32, K3)
//     the producer loads them and rounds them to bf16 (round to nearest
//     even) into the stage itself.  The bit of every (row, tap) is
//     computed once a layer, one row a producer thread.  The step's
//     weights arrive by ONE bulk copy (cp.async.bulk, no tensor map): the
//     host lays them out once as the exact shared-memory image of each
//     (tap, K slice) (ops/conv_pack.py).  Stages are handed over through
//     mbarriers: `full` counts the producer's 128 cp.async completions
//     (cp.async.mbarrier.arrive.noinc) and the bulk copy's bytes; `empty`
//     one arrival per consumer warp.  There is no __syncthreads() in the
//     tap loop;
//   * the two CONSUMER warpgroups each own 64 of the 128 positions by all
//     N outputs and multiply with wgmma (m64nNk16, bf16 from shared
//     memory, f32 sums in registers: N/2 a thread), keeping one step's
//     products in flight while the next step is started;
//   * shared-memory layout: wgmma's no-swizzle K-major core matrices (8
//     rows x 16 bytes, 128 contiguous bytes each).  An operand row of F=80
//     is 160 bytes, no swizzle width, and a core-matrix row is exactly the
//     16-byte cp.async vector and half of a k16 slice.  A: core matrices of
//     one 8-channel chunk lie row group after row group (SBO 128), chunks
//     A_LBO = 2048 + 16 bytes apart; the 16 spare bytes rotate the banks so
//     that the chunks of one row, copied by neighbouring threads, do not
//     collide.  B (weights, stored (N, K), K contiguous): SBO 128, LBO
//     (N/8) * 128;
//   * the nin skip (elu-halves(a) @ ws, added AFTER the conv's PONO) is two
//     more steps through the same ring into a second, narrow accumulator:
//     the producer computes the elu halves from the bf16 or f32 source and
//     stores them as the step's operand rows;
//   * the epilogue works from the accumulator registers: a row's channels
//     lie in the four lanes of a quad, so PONO's sums are a thread's own
//     values and two shuffles; before the stores, neighbouring lanes trade
//     halves so that each writes 4 consecutive channels.  It adds the bias and either stores the f32
//     result as it is (`linear`, K3), or applies PONO (ddof=1; E[x^2] -
//     mean^2, or the two-pass form when `pono_two_pass`), the nin skip, or
//     the gate og + pono(a) * sigmoid(g), and writes what the next layers
//     read: the f32 activation, its elu halves, its bf16 copy.

//
// Macros, for builds beside the plain one (ops/_cuda.py load_variant):
// LMK_NO_COPY, LMK_NO_MMA, LMK_NO_EPILOGUE compile a part out so that
// tools/profile_k1.py can time what is left (the values are then wrong);
// LMK_SPIN_LIMIT=n makes a barrier wait that polls more than n times trap,
// for bringing up a change to the ring without hanging the card.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace lmk {

typedef __nv_bfloat16 bf16;

constexpr int TP = 128;        // flat positions per block
constexpr int NCONS = 256;     // two consumer warpgroups
constexpr int NPROD = 128;     // one producer warpgroup
constexpr int NTHREADS = NCONS + NPROD;
static_assert(NPROD == TP, "one producer thread a row");
constexpr int STAGES = 4;
constexpr float PONO_EPS = 1e-5f;
constexpr int A_LBO = TP * 16 + 16;  // bytes between 8-channel chunks of A

struct Layer {
  const bf16* a;           // conv operand rows (B, HW, K) bf16
  long long a_bstride;     // elements between candidates
  int K;                   // 2F (elu halves) or F (bf16 copy)
  const float* mask;       // (B, HW, 9) masks
  const int* tile_taps;    // (B, HW / TP, 9): any position of the tile on; or null
  const bf16* w;           // packed image of the (9, K, nout) taps
  const float* bias;       // (nout)
  int nout;                // F, or 2F (the gated second conv; a wide linear conv)
  const bf16* skip;        // nin skip input as a bf16 (B, HW, F) entry, or null
  long long skip_bstride;
  const float* skip32;     // nin skip input as f32 (B, HW, F), or null
  const bf16* ws;          // packed image of the (2F, F) skip weights
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

// Shared memory: STAGES stages of (A slice TP x F, W slice F x nout <= 2F),
// then the barriers and the rows' on/off bits.
__host__ __device__ constexpr size_t a_bytes(int F) {
  return ((size_t)(F / 8) * A_LBO + 127) / 128 * 128;
}
__host__ __device__ constexpr size_t stage_bytes(int F) {
  return a_bytes(F) + (size_t)F * 2 * F * sizeof(bf16);
}
__host__ __device__ constexpr size_t smem_bytes(int F) {
  return STAGES * stage_bytes(F) + 2 * STAGES * sizeof(uint64_t) +
         TP * sizeof(uint32_t);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with pred false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
// One arrival on `bar` when all of this thread's earlier cp.async are done.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}
// Bulk global -> shared copy of `bytes` (a multiple of 16), counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
#ifdef LMK_SPIN_LIMIT   // debugging: a barrier that never completes traps
  long long spins = 0;
#endif
  do {
#ifdef LMK_SPIN_LIMIT
    if (++spins > (long long)LMK_SPIN_LIMIT) __trap();
#endif
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// Orders this thread's generic-proxy view of shared memory with the async
// proxy's (wgmma and the bulk copy read and write through the latter).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor, no swizzle, K-major: `lbo` bytes
// between the two core matrices of a k16 slice, `sbo` between 8-row groups.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void elu_halves(float v, float& pos, float& neg) {
  const float e = __expf(-fabsf(v)) - 1.f;
  pos = v > 0.f ? v : e;
  neg = v < 0.f ? -v : e;
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// v holds this lane's two columns of column block j (v[0], v[1]) and of
// block j + 1 (v[2], v[3]).  Lanes q and q ^ 1 of a quad trade halves: the
// even lane ends with 4 consecutive columns of block j (from 2q on), the
// odd lane with 4 of block j + 1 (from 2(q - 1) on).
__device__ __forceinline__ void quad_pair(float (&v)[4], bool odd) {
  const float s0 = odd ? v[0] : v[2];
  const float s1 = odd ? v[1] : v[3];
  const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (odd) {
    v[0] = r0;
    v[1] = r1;
  } else {
    v[2] = r0;
    v[3] = r1;
  }
}

// The block's ring: where stage s lies and its two barriers.
struct Ring {
  uint32_t base;       // shared address of stage 0
  uint32_t full;       // shared address of full[0]; empty[0] follows full[STAGES-1]
  uint32_t* row_on;    // TP words: bit t = tap t of the row is read
};

template <int F>
__device__ __forceinline__ Ring ring_of(unsigned char* smem) {
  Ring r;
  r.base = smem_u32(smem);
  r.full = r.base + (uint32_t)(STAGES * stage_bytes(F));
  r.row_on = reinterpret_cast<uint32_t*>(smem + STAGES * stage_bytes(F) +
                                         2 * STAGES * sizeof(uint64_t));
  return r;
}

// Once a kernel, by every thread of the block, before the first layer.
template <int F>
__device__ void ring_init(unsigned char* smem) {
  const Ring r = ring_of<F>(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full + 8 * s, NPROD + 1);              // copies + the bulk copy's thread
      mbar_init(r.full + 8 * (STAGES + s), NCONS / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_shared();
  }
  __syncthreads();
}

// acc (64 x NN) += A stage (this warpgroup's 64 rows, F deep) @ W stage.
template <int F, int NN>
__device__ __forceinline__ void mma_step(float (&acc)[NN / 2], uint32_t a_addr,
                                         uint32_t w_addr) {
  constexpr uint32_t w_lbo = (NN / 8) * 128;
  const uint64_t da = make_desc(a_addr, A_LBO, 128);
  const uint64_t db = make_desc(w_addr, w_lbo, 128);
#pragma unroll
  for (int kk = 0; kk < F / 16; ++kk)
    Wgmma<NN>::mma(acc, da + (uint64_t)((kk * 2 * A_LBO) >> 4),
                   db + (uint64_t)((kk * 2 * w_lbo) >> 4));
}

// Where K1's pass wants the block's own rows of the next layer's operand
// in shared memory (lmconv_pass.cuh): the elu halves (K = 2F) or the bf16
// copy (K = F), row r of the tile at rows + r * pitch.
struct NextRows {
  enum Mode { NONE, ELU, BF };
  int mode;
  uint32_t rows;
  int pitch;
};

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x), "r"(v.y)
               : "memory");
}

// The layer's epilogue, by each consumer thread from its accumulators (the
// 64 x NOUT sums of its warpgroup, `Wgmma` layout; sacc: the nin skip's).
// RESIDENT_U (K1's pass, lmconv_pass.cuh): the f32 activation of the
// block's 128 rows lives in shared memory at `us` (row pitch F + 4
// floats): the gate residual is read from there, all of it before any
// store, and a layer given `us` writes its result there (L.out, when set,
// gets it too); the biases are added before anything is stored; the
// gate's sigmoid takes the fast reciprocal; and the next layer's operand
// rows of the tile go to shared memory as well (`next`) as to device
// memory.
template <int F, bool WIDE, bool RESIDENT_U = false>
__device__ __forceinline__ void epilogue(const Layer& L, int HW, int b, int p0,
                                         bool has_skip,
                                         float (&acc)[WIDE ? F : F / 2],
                                         float (&sacc)[WIDE ? 1 : F / 2],
                                         float* us = nullptr, NextRows next = {}) {
  constexpr int NOUT = WIDE ? 2 * F : F;
  constexpr int UP = F + 4;   // shared row pitch of the resident activation
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  float2 og_first[RESIDENT_U && WIDE ? 2 : 1][RESIDENT_U && WIDE ? F / 8 : 1];
  if constexpr (RESIDENT_U && WIDE) {
    const int r = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < F / 8; ++j)
        og_first[h][j] = *reinterpret_cast<const float2*>(
            us + (r + 8 * h) * UP + 8 * j + 2 * (lane & 3));
    __syncwarp();   // a lane writes what its neighbour read
  }
  if constexpr (RESIDENT_U) {
    // the biases (and the skip's) go in first, all loads issued together
    // and none of them after a store
#pragma unroll
    for (int j = 0; j < NOUT / 8; ++j) {
      const float2 bi = *reinterpret_cast<const float2*>(L.bias + 8 * j + 2 * (lane & 3));
      acc[4 * j] += bi.x;
      acc[4 * j + 1] += bi.y;
      acc[4 * j + 2] += bi.x;
      acc[4 * j + 3] += bi.y;
    }
    if constexpr (!WIDE) {
      if (has_skip) {
#pragma unroll
        for (int j = 0; j < F / 8; ++j) {
          const float2 bi = *reinterpret_cast<const float2*>(L.bs + 8 * j + 2 * (lane & 3));
          sacc[4 * j] += bi.x;
          sacc[4 * j + 1] += bi.y;
          sacc[4 * j + 2] += bi.x;
          sacc[4 * j + 3] += bi.y;
        }
      }
    }
  }
  // epilogue from the registers: this thread holds, of rows r0 and
  // r0 + 8, the columns 8j + 2q + {0, 1} for every j.  Before a store
  // the lanes q and q ^ 1 trade halves of the column blocks j, j + 1
  // (`quad_pair`), so each holds 4 consecutive columns from `c4` on and
  // the stores are 16 bytes of f32 (8 of bf16) a lane, whole 32-byte
  // sectors a row.
  const int q = lane & 3;
  const bool odd = q & 1;
  const int c4 = odd ? 8 + 2 * (q - 1) : 2 * q;   // + 8j: first of the 4 columns
  const int r0 = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + r0 + 8 * h;
    if (L.linear) {
      float* orow = L.out + ((size_t)b * HW + p) * NOUT;
#pragma unroll
      for (int j = 0; j < NOUT / 8; j += 2) {
        float v[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float2 bi =
              *reinterpret_cast<const float2*>(L.bias + 8 * (j + jj) + 2 * q);
          v[2 * jj] = acc[4 * (j + jj) + 2 * h] + bi.x;
          v[2 * jj + 1] = acc[4 * (j + jj) + 2 * h + 1] + bi.y;
        }
        quad_pair(v, odd);
        *reinterpret_cast<float4*>(orow + 8 * j + c4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      continue;
    }
    const size_t o = ((size_t)b * HW + p) * F;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < F / 8; ++j) {
      float2 bi = make_float2(0.f, 0.f);
      if constexpr (!RESIDENT_U) bi = *reinterpret_cast<const float2*>(L.bias + 8 * j + 2 * q);
      const float x0 = acc[4 * j + 2 * h] + bi.x;
      const float x1 = acc[4 * j + 2 * h + 1] + bi.y;
      acc[4 * j + 2 * h] = x0;
      acc[4 * j + 2 * h + 1] = x1;
      s1 += x0 + x1;
      s2 += x0 * x0 + x1 * x1;
    }
    const float mean = quad_sum(s1) / F;
    float var;
    if (L.pono_two_pass) {
      float d2 = 0.f;
#pragma unroll
      for (int j = 0; j < F / 8; ++j) {
        const float d0 = acc[4 * j + 2 * h] - mean;
        const float d1 = acc[4 * j + 2 * h + 1] - mean;
        d2 += d0 * d0 + d1 * d1;
      }
      var = quad_sum(d2) / (F - 1);
    } else {
      var = (quad_sum(s2) - F * mean * mean) / (F - 1);
    }
    const float rsd = rsqrtf(var + PONO_EPS);
#pragma unroll
    for (int j = 0; j < F / 8; j += 2) {
      float y[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int jb = j + jj;
        const int c = 8 * jb + 2 * q;
        float y0 = (acc[4 * jb + 2 * h] - mean) * rsd;
        float y1 = (acc[4 * jb + 2 * h + 1] - mean) * rsd;
        if constexpr (!WIDE) {
          if (has_skip) {
            float2 bsk = make_float2(0.f, 0.f);
            if constexpr (!RESIDENT_U) bsk = *reinterpret_cast<const float2*>(L.bs + c);
            y0 += sacc[4 * jb + 2 * h] + bsk.x;
            y1 += sacc[4 * jb + 2 * h + 1] + bsk.y;
          }
        } else {
          float2 bg = make_float2(0.f, 0.f);
          if constexpr (!RESIDENT_U) bg = *reinterpret_cast<const float2*>(L.bias + F + c);
          const float g0 = acc[4 * (jb + F / 8) + 2 * h] + bg.x;
          const float g1 = acc[4 * (jb + F / 8) + 2 * h + 1] + bg.y;
          if constexpr (RESIDENT_U) {
            // eight warps run this epilogue while the tensor cores wait:
            // the sigmoid's reciprocal is the fast one here
            y0 = og_first[h][jb].x + y0 * __fdividef(1.f, 1.f + __expf(-g0));
            y1 = og_first[h][jb].y + y1 * __fdividef(1.f, 1.f + __expf(-g1));
          } else {
            const float2 og = *reinterpret_cast<const float2*>(L.og + o + c);
            y0 = og.x + y0 * __frcp_rn(1.f + __expf(-g0));
            y1 = og.y + y1 * __frcp_rn(1.f + __expf(-g1));
          }
        }
        y[2 * jj] = y0;
        y[2 * jj + 1] = y1;
      }
      quad_pair(y, odd);
      const int c = 8 * j + c4;
      if constexpr (RESIDENT_U) {
        if (us != nullptr)
          *reinterpret_cast<float4*>(us + (p - p0) * UP + c) =
              make_float4(y[0], y[1], y[2], y[3]);
      }
      if (L.out != nullptr)
        *reinterpret_cast<float4*>(L.out + o + c) =
            make_float4(y[0], y[1], y[2], y[3]);
      if (L.out_bf != nullptr) {
        const uint2 v = make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
        *reinterpret_cast<uint2*>(L.out_bf + b * L.out_bf_bstride + (size_t)p * F + c) = v;
        if constexpr (RESIDENT_U) {
          if (next.mode == NextRows::BF)
            st_shared_v2(next.rows + (p - p0) * next.pitch + c * 2, v);
        }
      }
      if (L.out_elu != nullptr) {
        float pos[4], neg[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) elu_halves(y[i], pos[i], neg[i]);
        const uint2 vp = make_uint2(pack_bf16(pos[0], pos[1]), pack_bf16(pos[2], pos[3]));
        const uint2 vn = make_uint2(pack_bf16(neg[0], neg[1]), pack_bf16(neg[2], neg[3]));
        *reinterpret_cast<uint2*>(L.out_elu + 2 * o + c) = vp;
        *reinterpret_cast<uint2*>(L.out_elu + 2 * o + F + c) = vn;
        if constexpr (RESIDENT_U) {
          if (next.mode == NextRows::ELU) {
            const uint32_t r = next.rows + (p - p0) * next.pitch;
            st_shared_v2(r + c * 2, vp);
            st_shared_v2(r + (F + c) * 2, vn);
          }
        }
      }
    }
  }
}

// One masked conv layer of width F on the TP positions from p0 of
// candidate b.  WIDE: nout = 2F (the gated resnet's second conv, output
// og + pono(a) * sigmoid(g), or a wide linear conv), else nout = F (PONO,
// or linear).  `smem` is the block's smem_bytes(F) of dynamic shared
// memory, set up by ring_init; every thread of the block calls this with
// its own count `it` of the ring steps taken so far (0 at the start, kept
// across the layers of one kernel).  SETREG: move registers from the
// producer to the consumers (only where the roles never reconverge).
// A32: the operand rows are a32 (B, HW, L.K) f32, rounded to bf16 by the
// producer, instead of L.a (K3's streamed route; `Layer` stays as K1 and
// K4 compile it).
template <int F, bool WIDE, bool SETREG, bool A32 = false>
__device__ void layer_body(const Layer& L, int HW, int b, int p0,
                           unsigned char* smem, uint32_t& it,
                           const float* a32 = nullptr) {
  constexpr int NOUT = WIDE ? 2 * F : F;
  constexpr int VPR = F / 8;                      // 16-byte vectors a row
  constexpr uint32_t A_BYTES = (uint32_t)a_bytes(F);
  constexpr uint32_t STAGE = (uint32_t)stage_bytes(F);
  const Ring ring = ring_of<F>(smem);
  const bool has_skip = !WIDE && (L.skip != nullptr || L.skip32 != nullptr);
  const int nk = L.K / F;

  // taps of this tile that have any position on
  uint32_t taps = 0x1ffu;
  if (L.tile_taps != nullptr) {
    const int* tt = L.tile_taps + ((size_t)b * (HW / TP) + p0 / TP) * 9;
    taps = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t) taps |= (tt[t] != 0 ? 1u : 0u) << t;
  }

  if (threadIdx.x >= NCONS) {
    // ---------------- producer ----------------
    if constexpr (SETREG) asm volatile("setmaxnreg.dec.sync.aligned.u32 64;\n");
    const int tid = threadIdx.x - NCONS;
    {
      const int p = p0 + tid;
      const float* m = L.mask + ((size_t)b * HW + p) * 9;
      int row = 0, col = 0;
      if (L.img_w > 0) {
        row = p / L.img_w;
        col = p - row * L.img_w;
      }
      uint32_t bits = 0;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int s = p + L.shifts[t];
        bool ok = s >= 0 && s < HW && m[t] != 0.f;
        if (L.img_w > 0) {
          const int rr = row + L.dr[t];
          const int cc = col + L.dc[t];
          ok = ok && rr >= 0 && rr < L.img_h && cc >= 0 && cc < L.img_w;
        }
        bits |= (ok ? 1u : 0u) << t;
      }
      ring.row_on[tid] = bits;
    }
    // the producer's own barrier: every row's bits are written
    asm volatile("bar.sync 1, %0;\n" ::"n"(NPROD) : "memory");

    const bf16* src = A32 ? nullptr : L.a + b * L.a_bstride;
    for (int t = 0; t < 9; ++t) {
      if (!((taps >> t) & 1u)) continue;
      const int shift = L.shifts[t];
      for (int kc = 0; kc < nk; ++kc) {
        const uint32_t s = it % STAGES;
        const uint32_t full = ring.full + 8 * s;
        mbar_wait(ring.full + 8 * (STAGES + s), ((it / STAGES) & 1u) ^ 1u);
        const uint32_t a_addr = ring.base + s * STAGE;
        if (tid == 0) {
          constexpr uint32_t wb = F * NOUT * sizeof(bf16);
          mbar_arrive_expect(full, wb);
          bulk_copy(a_addr + A_BYTES, L.w + (size_t)(t * nk + kc) * F * NOUT, wb,
                    full);
        }
#ifndef LMK_NO_COPY
        if constexpr (A32) {
          const float* src32 = a32 + (size_t)b * HW * L.K;
          unsigned char* a_ptr = smem + s * STAGE;
#pragma unroll
          for (int i = 0; i < VPR; ++i) {
            const int idx = tid + NPROD * i;
            const int r = idx / VPR;
            const int v = idx - r * VPR;
            float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if ((ring.row_on[r] >> t) & 1u)
              load8(src32 + (size_t)(p0 + r + shift) * L.K + kc * F + v * 8, x);
            *reinterpret_cast<uint4*>(a_ptr + (r >> 3) * 128 + (r & 7) * 16 + v * A_LBO) =
                make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                           pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
          }
          fence_async_shared();
        } else {
#pragma unroll
          for (int i = 0; i < VPR; ++i) {   // TP * VPR vectors on NPROD = TP threads
            const int idx = tid + NPROD * i;
            const int r = idx / VPR;
            const int v = idx - r * VPR;
            const bool ok = (ring.row_on[r] >> t) & 1u;
            const bf16* g =
                ok ? src + (size_t)(p0 + r + shift) * L.K + kc * F + v * 8 : src;
            cp_async16(a_addr + (r >> 3) * 128 + (r & 7) * 16 + v * A_LBO, g, ok);
          }
        }
#endif
        if constexpr (A32) mbar_arrive(full);
        else cp_async_arrive(full);
        ++it;
      }
    }
    if (has_skip) {
      // the nin skip's two steps: elu halves of TP unshifted rows
      for (int half = 0; half < 2; ++half) {
        const uint32_t s = it % STAGES;
        const uint32_t full = ring.full + 8 * s;
        mbar_wait(ring.full + 8 * (STAGES + s), ((it / STAGES) & 1u) ^ 1u);
        unsigned char* a_ptr = smem + s * STAGE;
        if (tid == 0) {
          constexpr uint32_t wb = F * F * sizeof(bf16);
          mbar_arrive_expect(full, wb);
          bulk_copy(ring.base + s * STAGE + A_BYTES, L.ws + (size_t)half * F * F,
                    wb, full);
        }
#ifndef LMK_NO_COPY
        for (int idx = tid; idx < TP * VPR; idx += NPROD) {
          const int r = idx / VPR;
          const int v = idx - r * VPR;
          float x[8];
          if (L.skip != nullptr)
            load8(L.skip + b * L.skip_bstride + (size_t)(p0 + r) * F + v * 8, x);
          else
            load8(L.skip32 + ((size_t)b * HW + p0 + r) * F + v * 8, x);
          float h[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float pos, neg;
            elu_halves(x[i], pos, neg);
            h[i] = half == 0 ? pos : neg;
          }
          uint4 o;
          o.x = pack_bf16(h[0], h[1]);
          o.y = pack_bf16(h[2], h[3]);
          o.z = pack_bf16(h[4], h[5]);
          o.w = pack_bf16(h[6], h[7]);
          *reinterpret_cast<uint4*>(a_ptr + (r >> 3) * 128 + (r & 7) * 16 +
                                    v * A_LBO) = o;
        }
        fence_async_shared();
#endif
        mbar_arrive(full);
        ++it;
      }
    }
  } else {
    // ---------------- consumers ----------------
    if constexpr (SETREG) asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    const int wg = threadIdx.x >> 7;
    const int lane = threadIdx.x & 31;
    float acc[NOUT / 2];
    float sacc[WIDE ? 1 : F / 2];   // the skip's sums (narrow layers only)
#pragma unroll
    for (int i = 0; i < NOUT / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (WIDE ? 1 : F / 2); ++i) sacc[i] = 0.f;

    int n_main = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t) n_main += (taps >> t) & 1u;
    n_main *= nk;
    const int n_steps = n_main + (has_skip ? 2 : 0);
    int prev = -1;   // the stage whose products are still in flight
    for (int i = 0; i < n_steps; ++i) {
      const uint32_t s = it % STAGES;
      mbar_wait(ring.full + 8 * s, (it / STAGES) & 1u);
      fence_async_shared();
      const uint32_t a_addr = ring.base + s * STAGE + wg * (8 * 128);
      const uint32_t w_addr = ring.base + s * STAGE + A_BYTES;
      wgmma_fence();
#ifndef LMK_NO_MMA
      if (i < n_main) {
        mma_step<F, NOUT>(acc, a_addr, w_addr);
      } else {
        if constexpr (!WIDE) mma_step<F, F>(sacc, a_addr, w_addr);
      }
#endif
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(ring.full + 8 * (STAGES + prev));
      }
      prev = (int)s;
      ++it;
    }
    wgmma_wait<0>();
    if (prev >= 0 && lane == 0) mbar_arrive(ring.full + 8 * (STAGES + prev));
#pragma unroll
    for (int i = 0; i < NOUT / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
#pragma unroll
    for (int i = 0; i < (WIDE ? 1 : F / 2); ++i)
      asm volatile("" : "+f"(sacc[i])::"memory");

#ifndef LMK_NO_EPILOGUE
    epilogue<F, WIDE>(L, HW, b, p0, has_skip, acc, sacc);
#endif
  }
}

// Flat shift of tap (i, j) of a 3x3 kernel with dilation d on a width-W grid.
inline void make_shifts(int* s, int W, int d) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) s[i * 3 + j] = (i - 1) * d * W + (j - 1) * d;
}

__host__ __device__ inline Layer conv_layer(const bf16* a, long long a_bstride, int K,
                        const float* mask, const int* tile_taps, const bf16* w,
                        const float* bias, int nout, const int* shifts) {
  Layer L = {};
  L.a = a;
  L.a_bstride = a_bstride;
  L.K = K;
  L.mask = mask;
  L.tile_taps = tile_taps;
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
