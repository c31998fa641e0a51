// Operand rows resident in shared memory, read tap by tap into wgmma's
// register operand, with a ring that carries weights only: the part of the
// layer body that K1's persistent pass (lmconv_pass.cuh) and K3's resident
// route (masked_conv.cu) share.
//
//   * the resident region.  A layer's operand rows of a 128-position tile
//     and the halo each side (max|s_t| rows, `halo_of`) lie in one region
//     of A_REGION bytes, row r at r * pitch(K) bytes.  The 16 spare bytes a
//     row put the 8 rows of an ldmatrix phase on 8 different bank quads at
//     every width.  Who writes the rows is the caller's business (K1: the
//     layer before and the neighbours' halo; K3: every thread of the block,
//     rounding f32 to bf16 on the way);
//   * the row bits.  Bit t of a row is on when its tap t is read: mask on,
//     the source inside [0, HW) and, for raw masks (`Layer::img_w` > 0,
//     `guard_image`), inside the image.  A row whose bit is off is zeroed in
//     registers after the ldmatrix, never multiplied by 0 (0 * NaN = NaN);
//   * the weight ring.  NST stages of wstage_bytes(F), one step a stage: one
//     K slice of a tap, or a tap's two where both fit (the narrow K = 2F
//     conv).  The producer brings a step by one bulk copy (the host laid the
//     weights out as the stage's exact image, ops/conv_pack.py) counted on
//     the stage's `full` barrier; with clusters of CL = 2 each block copies
//     half of every step into both blocks (multicast) and a stage's `empty`
//     barrier counts the consumer warps of both;
//   * the tap loop (`tap_products`): a consumer warp builds each step's A
//     fragments with ldmatrix at the tap's row offset, zeroes the rows whose
//     bit is off, and multiplies with A from registers (WgmmaRS).  A step's
//     products are waited for only once the next step's are issued.
// The cluster walks the union of its blocks' tiles' active taps; a block
// whose own tile has the tap off multiplies zeros (a branch around wgmma
// makes ptxas serialise the products).

#pragma once

#include "lmconv_layer.cuh"

namespace lmk {
namespace rr {

constexpr size_t A_REGION = 72 * 1024;   // resident operand rows (ops/conv_pack.py)

__host__ __device__ constexpr int pitch(int K) { return 2 * K + 16; }
__host__ __device__ constexpr int rows_cap(int K) { return (int)(A_REGION / pitch(K)); }
// a ring stage: the weights of one (tap, K slice) step of the widest conv
__host__ __device__ constexpr size_t wstage_bytes(int F) {
  return (size_t)F * 2 * F * sizeof(bf16);
}

__host__ __device__ inline int halo_of(const int* shifts) {
  int h = 0;
  for (int t = 0; t < 9; ++t) {
    const int s = shifts[t] < 0 ? -shifts[t] : shifts[t];
    if (s > h) h = s;
  }
  return h;
}

// d += A @ the (16 KK x N) weights of one K slice at shared address w
// (packed image, ops/conv_pack.py), A given as KK k16 fragments.
template <int N, int KK>
__device__ __forceinline__ void mma_slice(float (&d)[N / 2], uint32_t (&fr)[KK][4],
                                          uint32_t w) {
  constexpr uint32_t lbo = (N / 8) * 128;
  const uint64_t db = make_desc(w, lbo, 128);
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
    WgmmaRS<N>::mma(d, fr[kk], db + (uint64_t)((kk * 2 * lbo) >> 4));
}

// K slices of F that one ring step carries: two where both fit a stage
// (the narrow K = 2F conv: a tap's whole weights), else one.
__device__ __forceinline__ int slices_per_step(const Layer& L, int F) {
  return L.nout == F && L.K == 2 * F ? 2 : 1;
}

// ------------------------------------------------------------------ cluster

template <int CL>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (CL > 1)
    asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::
                     : "memory");
}
// The shared::cluster address of `addr` (a shared::cta address of this
// block) in the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t cluster_addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_addr)
               : "memory");
}
// `bytes` from src into this block's and its peer's shared memory at `dst`
// (the same offset in both), counted on each block's barrier at `bar`.
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst, const void* src,
                                                    uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"((uint16_t)0x3)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ------------------------------------------------------------------ taps

// Taps with any position on in tile `tile` of candidate b (all if no table).
__device__ __forceinline__ uint32_t tile_taps(const Layer& L, int b, int tile, int tiles) {
  if (L.tile_taps == nullptr) return 0x1ffu;
  const int* tt = L.tile_taps + ((size_t)b * tiles + tile) * 9;
  uint32_t m = 0;
#pragma unroll
  for (int t = 0; t < 9; ++t) m |= (tt[t] != 0 ? 1u : 0u) << t;
  return m;
}
// The steps the cluster walks: the union of its blocks' tiles' taps.
template <int CL>
__device__ __forceinline__ uint32_t cluster_taps(const Layer& L, int b, int tile,
                                                 int tiles) {
  uint32_t m = tile_taps(L, b, tile, tiles);
  if constexpr (CL > 1) m |= tile_taps(L, b, tile ^ 1, tiles);
  return m;
}

// Row p's tap bits for layer L: the tap is read (mask on, source inside
// [0, HW) and, with raw masks (GUARD, `guard_image`), inside the image).
template <bool GUARD>
__device__ __forceinline__ uint32_t row_bits(const Layer& L, int HW, int b, int p) {
  const float* m = L.mask + ((size_t)b * HW + p) * 9;
  int row = 0, col = 0;
  if (GUARD) {
    row = p / L.img_w;
    col = p - row * L.img_w;
  }
  uint32_t bits = 0;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int s = p + L.shifts[t];
    bool ok = s >= 0 && s < HW && m[t] != 0.f;
    if (GUARD) {
      const int sr = row + L.dr[t];
      const int sc = col + L.dc[t];
      ok = ok && sr >= 0 && sr < L.img_h && sc >= 0 && sc < L.img_w;
    }
    bits |= (ok ? 1u : 0u) << t;
  }
  return bits;
}

// ------------------------------------------------------------------ ring

// The weight ring: stage s at base + s * wstage_bytes(F); full[s] at
// full + 8 s, empty[s] at full + 8 (NST + s).
struct WRing {
  uint32_t base;
  uint32_t full;
};

// Where step i of layer L's taps (walked in tap order, K slices inner)
// takes its weights from, and how many bytes (nout = L.nout).
template <int F>
__device__ __forceinline__ void step_weights(const Layer& L, int nout, uint32_t taps,
                                             int nk, int kps, int i, const bf16*& src,
                                             uint32_t& bytes) {
  int j = i / (nk / kps), t = 0;
  const int kc = (i - j * (nk / kps)) * kps;
  for (; t < 9; ++t)
    if ((taps >> t) & 1u) {
      if (j == 0) break;
      --j;
    }
  src = L.w + (size_t)(t * nk + kc) * F * nout;
  bytes = kps * F * nout * sizeof(bf16);
}

// By the producer's issuing thread: step `it` of the ring gets `bytes`
// from src once its stage is free (with CL = 2, half from each block).
template <int F, int NST, int CL>
__device__ __forceinline__ void put_step(const WRing& ring, uint32_t& it, const bf16* src,
                                         uint32_t bytes, uint32_t rank) {
  const uint32_t s = it % NST;
  const uint32_t full = ring.full + 8 * s;
  mbar_wait(ring.full + 8 * (NST + s), ((it / NST) & 1u) ^ 1u);
  const uint32_t dst = ring.base + s * (uint32_t)wstage_bytes(F);
  mbar_arrive_expect(full, bytes);
  if constexpr (CL > 1) {
    const uint32_t half = bytes / 2;
    bulk_copy_multicast(dst + rank * half,
                        reinterpret_cast<const unsigned char*>(src) + rank * half, half,
                        full);
  } else {
    bulk_copy(dst, src, bytes, full);
  }
  ++it;
}

// By a consumer warp: it is done with stage s (with CL = 2 the peer's
// producer writes into this block's stage too, so both are told).
template <int NST, int CL>
__device__ __forceinline__ void release_stage(const WRing& ring, uint32_t s) {
  if ((threadIdx.x & 31) == 0) {
    const uint32_t e = ring.full + 8 * (NST + s);
    mbar_arrive(e);
    if constexpr (CL > 1) {
      uint32_t rank;
      asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
      mbar_arrive_cluster(peer_addr(e, rank ^ 1u));
    }
  }
}

// The products of a layer's taps, by each consumer thread (two consumer
// warpgroups, 64 rows each): acc (64 x NOUT) += sum over the steps of the
// resident rows of tap t, K slice kc, @ the step's weights.  `lane_row` is
// this lane's ldmatrix row at tap offset 0 (lanes 0-15: rows 0-15 of the
// warp, k 0-7; 16-31: k 8-15), `pt` the row pitch; bits_a / bits_b the
// row bits of the thread's rows ra and ra + 8; `own` the taps of this
// block's tile, `taps` the cluster's.  fr0 / fr1 are the two fragment
// buffers (the caller may reuse them after).  `it` counts ring steps.
template <int F, int NOUT, int NST, int CL>
__device__ __forceinline__ void tap_products(float (&acc)[NOUT / 2], uint32_t (&fr0)[F / 16][4],
                                             uint32_t (&fr1)[F / 16][4], const WRing& ring,
                                             uint32_t lane_row, uint32_t pt,
                                             const int* shifts, uint32_t bits_a,
                                             uint32_t bits_b, uint32_t own, uint32_t taps,
                                             int nk, int kps, uint32_t& it) {
  constexpr int KK = F / 16;                      // k16 slices of a step
  constexpr uint32_t WSTAGE = (uint32_t)wstage_bytes(F);
  // fr = the A fragments of K slice kc of tap t, rows off in registers
  auto load = [&](uint32_t (&fr)[KK][4], int t, int kc) {
    const bool on_a = (bits_a >> t) & 1u;
    const bool on_b = (bits_b >> t) & 1u;
    const uint32_t row = lane_row + shifts[t] * (int)pt + kc * F * 2;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      ldmatrix_x4(fr[kk], row + kk * 32);
      if (!on_a) fr[kk][0] = fr[kk][2] = 0u;
      if (!on_b) fr[kk][1] = fr[kk][3] = 0u;
    }
  };
  // a tap of the peer's tile only: zeros, so that the products stay on one
  // path (a branch around wgmma makes ptxas serialise them)
  auto zero = [](uint32_t (&fr)[KK][4]) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) fr[kk][0] = fr[kk][1] = fr[kk][2] = fr[kk][3] = 0u;
  };
  const int n_main = __popc(taps) * (nk / kps);
  if (kps == 2) {
    // a tap's two slices a step (the narrow K = 2F conv): one buffer each,
    // the products waited for at the step's end
    for (int t = 0; t < 9; ++t) {
      if (!((taps >> t) & 1u)) continue;
      const uint32_t s = it % NST;
      mbar_wait(ring.full + 8 * s, (it / NST) & 1u);
      if ((own >> t) & 1u) {
        load(fr0, t, 0);
        load(fr1, t, 1);
      } else {
        zero(fr0);
        zero(fr1);
      }
#ifndef LMK_NO_MMA
      const uint32_t w = ring.base + s * WSTAGE;
      wgmma_fence();
      mma_slice<NOUT>(acc, fr0, w);
      mma_slice<NOUT>(acc, fr1, w + F * NOUT * 2);
      wgmma_commit();
      wgmma_wait<0>();
#endif
      release_stage<NST, CL>(ring, s);
      ++it;
    }
  } else {
    // one slice a step.  A step's products are waited for (wgmma_wait<1>)
    // only once the next step's are issued, so a step's ldmatrix and the
    // wait for its weights overlap the products before it; its stage is
    // released then.  The two fragment buffers alternate (the loop is
    // unrolled by two so that each buffer stays in registers).
    int prev = -1;   // the stage whose products are in flight
    auto step = [&](uint32_t (&fr)[KK][4], int t, int kc) {
      const uint32_t s = it % NST;
      mbar_wait(ring.full + 8 * s, (it / NST) & 1u);
      if ((own >> t) & 1u) load(fr, t, kc);
      else zero(fr);
#ifndef LMK_NO_MMA
      wgmma_fence();
      mma_slice<NOUT>(acc, fr, ring.base + s * WSTAGE);
#endif
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) release_stage<NST, CL>(ring, (uint32_t)prev);
      prev = (int)s;
      ++it;
    };
    int t = -1, kc = nk - 1;   // the step before the first
    auto next = [&]() {
      if (++kc == nk) {
        kc = 0;
        do ++t; while (!((taps >> t) & 1u));
      }
    };
    for (int i = 0; i < n_main; i += 2) {
      next();
      step(fr0, t, kc);
      if (i + 1 < n_main) {
        next();
        step(fr1, t, kc);
      }
    }
    wgmma_wait<0>();
    if (prev >= 0) release_stage<NST, CL>(ring, (uint32_t)prev);
  }
}

}  // namespace rr
}  // namespace lmk
