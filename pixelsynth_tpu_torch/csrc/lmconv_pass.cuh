// The persistent pass of K1 (csrc/lmconv_fused.cu) for Hopper (sm_90a):
// every masked conv layer of the fused PixelCNN trunk's up or down pass in
// ONE launch.  K4 keeps the per-layer body of lmconv_layer.cuh; this path
// shares its helpers, its `Layer` description and its epilogue, and shares
// with K3's resident route (masked_conv.cu) the resident operand rows, the
// row bits, the weight ring and the register-operand tap loop
// (resident_rows.cuh).
//
// What it changes, and why (PERF.md has the numbers):
//   * one launch a pass.  The grid holds as many groups of HW/128 blocks as
//     the card keeps resident (a cooperative launch guarantees it); group g
//     takes candidates g, g + groups, ... in rounds.  A block owns 128
//     positions of one candidate and runs phase 0 (the pass input -> the
//     f32 activation, its elu halves and, up, stack entry 0) and then every
//     layer in order;
//   * no grid-wide barrier between layers.  A conv at tile (b, p) reads
//     only rows p + s_t of candidate b, within `win` tiles of p (the host
//     computes win from the shifts).  After its epilogue's stores a block
//     publishes a per-(candidate, tile) counter (release); before it copies
//     a layer's operand rows the producer waits (acquire) until every tile
//     of its window has published the layer before.  A counter holds
//     (epoch << 8) + stages done, the epoch a number the launch is given
//     (one more each call), so no launch has to reset the counters.
//     Built with LMK_GRID_SYNC, the waits are on one grid-wide count
//     instead (every block, every stage): the barrier the flags replace;
//   * weights multicast over a cluster of 2, built with LMK_MULTICAST.  The
//     two blocks of a cluster are neighbouring tiles of one candidate; the
//     cluster walks the union of their tiles' active taps, and each block's
//     producer copies half of every weight step with cp.async.bulk
//     .multicast::cluster into both blocks' ring.  A stage's `empty`
//     barrier counts the consumer warps of both blocks (a warp arrives on
//     its peer's barrier too).  A block whose own tile has the tap off
//     multiplies zeros for it.  It halves the weights' L2 -> SM bytes, but
//     each stage then waits for both blocks' consumers and producers, and
//     on the H100 the pass ran 20% slower so (PERF.md); the plain build
//     has clusters of 1, each block copying all of every step;
//   * operand rows once a tile (resident_rows.cuh).  A layer's operand
//     rows, the tile's 128 and the halo each side, lie in the resident
//     region.  The tile's own rows are written there by the layer before
//     (its epilogue, or phase 0), beside its stores to device memory; the
//     producer copies only the halo, once the neighbours' counters allow.
//     The ring carries weights only, and the consumers take each tap's
//     rows with ldmatrix into wgmma's register operand (`rr::tap_products`);
//   * the nin skip's operand (elu halves of the popped stack entry, the
//     block's own rows) goes from device memory straight into A fragments:
//     it needs no shared memory and no producer work;
//   * the f32 activation u of the block's 128 rows stays in shared memory
//     for the whole pass (the gate's residual is read by the thread that
//     writes it); only the down pass's last layer stores it (the output).
//     The bf16 operands go through device memory, and each is written only
//     where the next layer reads it (no elu halves before a dilated conv,
//     no down-pass bf16 copy before a gated resnet).
// Write-after-read, for every scratch buffer (ue, xe, ubf): a layer
// writes only its own tile's rows, and no layer writes the buffer it reads
// (c1: ue -> xe; c2: xe -> ue, stack entry or ubf; dilated: stack entry or
// ubf -> ue).  A block starts layer m only when
// every tile of its window has published layer m - 1, so while it writes
// the outputs of layer m each neighbour that reads its rows is in layer m
// (reading the inputs of m, another buffer) or waits for this block's
// counter: a block is never more than one layer ahead of a neighbour, and
// each buffer's readers and writer alternate with period 2.
//
// Macros: LMK_GRID_SYNC, LMK_MULTICAST (above); LMK_STAMPS: one
// thread a block writes %globaltimer, in its first round, at the start and
// at four points of every stage (`stamp`), for tools/profile_k1.py;
// LMK_NO_COPY, LMK_NO_MMA,
// LMK_NO_EPILOGUE and LMK_SPIN_LIMIT as in lmconv_layer.cuh.

#pragma once

#include "resident_rows.cuh"

namespace lmk {
namespace pass {

constexpr int NR_MAX = 4;
constexpr int MAXL = 6 * NR_MAX + 6;          // the down pass's layers at nr = NR_MAX
constexpr int STAMPS = 256;                   // stamp slots a block (LMK_STAMPS)
using rr::A_REGION;
using rr::halo_of;
using rr::pitch;
using rr::rows_cap;
using rr::wstage_bytes;
#ifdef LMK_MULTICAST
constexpr int CLUSTER = 2;
#else
constexpr int CLUSTER = 1;
#endif

__host__ __device__ constexpr size_t ring_bytes(int F) { return STAGES * wstage_bytes(F); }
// the block's f32 activation, 128 rows of F + 4 floats
__host__ __device__ constexpr size_t u_bytes(int F) { return (size_t)TP * (F + 4) * 4; }
__host__ __device__ constexpr size_t u_off(int F) { return ring_bytes(F) + A_REGION; }
__host__ __device__ constexpr size_t table_off(int F) { return u_off(F) + u_bytes(F); }
__host__ __device__ constexpr size_t bar_off(int F) {
  return table_off(F) + ((MAXL * sizeof(Layer) + 15) / 16) * 16;
}
// full[STAGES], empty[STAGES], a_full, a_empty
__host__ __device__ constexpr size_t smem_bytes(int F) {
  return bar_off(F) + (2 * STAGES + 2) * sizeof(uint64_t);
}
static_assert(smem_bytes(80) <= 232448, "the pass fits a block's shared memory");

struct Args {
  int up;                  // 1: up pass (u0 -> stack), 0: down (stack -> out)
  int B, HW, F, nr;
  int win;                 // tiles each side of a tile that a layer reads
  unsigned long long epoch;
  const float* u0;         // up: (B, HW, F) f32
  bf16* stack;             // (B, 3nr+3, HW, F) bf16
  const float* mu;         // (B, HW, 9) folded masks, dilation 1 and max
  const float* md;
  const int* tu;           // (B, HW/TP, 9) tile tables of mu, md
  const int* td;
  const bf16* w1;          // packed images (ops/conv_pack.py)
  const float* b1;
  const bf16* ws;
  const float* bs;
  const bf16* w2;
  const float* b2;
  const bf16* dw;
  const float* db;
  float* out;              // down: (B, HW, F) f32, the pass's output
  bf16* ue;                // (B, HW, 2F) elu halves
  bf16* xe;                // (B, HW, 2F) the gated first conv's elu halves
  bf16* ubf;               // down: (B, HW, F) bf16 operand of the dilated convs
  unsigned long long* flags;   // (B * HW/TP) counters, then the LMK_GRID_SYNC count
  unsigned long long* stamps;  // LMK_STAMPS: (grid, STAMPS) globaltimer ns, or null
  int s1[9], sd[9];
};

__host__ __device__ inline int n_layers(int up, int nr) {
  return up ? 6 * nr + 2 : 6 * nr + 6;
}

// The pass's layers in order, as lmconv_fused.cu's entry points describe
// them; written once a launch into shared memory by one thread.
__device__ inline int build_layers(const Args& a, Layer* out) {
  const int F = a.F;
  const long long n_per = (long long)a.HW * F;
  const long long sb = (long long)(3 * a.nr + 3) * n_per;
  int n = 0, g = 0;
  if (a.up) {
    int s = 1;
    for (int blk = 0; blk < 3; ++blk) {
      for (int r = 0; r < a.nr; ++r) {
        Layer c1 = conv_layer(a.ue, 2 * n_per, 2 * F, a.mu, a.tu,
                              a.w1 + (size_t)g * 9 * 2 * F * F, a.b1 + (size_t)g * F,
                              F, a.s1);
        c1.out_elu = a.xe;
        out[n++] = c1;
        Layer c2 = conv_layer(a.xe, 2 * n_per, 2 * F, a.mu, a.tu,
                              a.w2 + (size_t)g * 9 * 4 * F * F,
                              a.b2 + (size_t)g * 2 * F, 2 * F, a.s1);
        c2.out_elu = a.ue;
        c2.out_bf = a.stack + (size_t)s * n_per;
        c2.out_bf_bstride = sb;
        out[n++] = c2;
        ++g;
        ++s;
      }
      if (blk < 2) {   // reads bf16(u): the stack entry just written
        Layer d = conv_layer(a.stack + (size_t)(s - 1) * n_per, sb, F, a.md, a.td,
                             a.dw + (size_t)blk * 9 * F * F, a.db + (size_t)blk * F,
                             F, a.sd);
        d.out_elu = a.ue;
        d.out_bf = a.stack + (size_t)s * n_per;
        d.out_bf_bstride = sb;
        out[n++] = d;
        ++s;
      }
    }
  } else {
    int top = 3 * a.nr + 1;
    for (int i = 0; i < 3; ++i) {
      for (int r = 0; r < (i == 0 ? a.nr : a.nr + 1); ++r) {
        Layer c1 = conv_layer(a.ue, 2 * n_per, 2 * F, a.mu, a.tu,
                              a.w1 + (size_t)g * 9 * 2 * F * F, a.b1 + (size_t)g * F,
                              F, a.s1);
        c1.skip = a.stack + (size_t)top * n_per;
        c1.skip_bstride = sb;
        c1.ws = a.ws + (size_t)g * 2 * F * F;
        c1.bs = a.bs + (size_t)g * F;
        c1.out_elu = a.xe;
        out[n++] = c1;
        Layer c2 = conv_layer(a.xe, 2 * n_per, 2 * F, a.mu, a.tu,
                              a.w2 + (size_t)g * 9 * 4 * F * F,
                              a.b2 + (size_t)g * 2 * F, 2 * F, a.s1);
        c2.out_elu = a.ue;
        c2.out_bf = a.ubf;     // the dilated conv's operand
        c2.out_bf_bstride = n_per;
        out[n++] = c2;
        ++g;
        --top;
      }
      if (i < 2) {
        Layer d = conv_layer(a.ubf, n_per, F, a.md, a.td,
                             a.dw + (size_t)i * 9 * F * F, a.db + (size_t)i * F, F,
                             a.sd);
        d.out_elu = a.ue;
        out[n++] = d;
      }
    }
    out[n - 1].out = a.out;
  }
  // an operand nobody reads next is not written: the elu halves when the
  // next layer is a dilated conv (it writes its own) or there is none; the
  // down pass's bf16 copy unless the next layer reads it (the up pass's
  // are the stack, read by the down pass)
  for (int i = 0; i < n; ++i) {
    const bf16* next = i + 1 < n ? out[i + 1].a : nullptr;
    if (out[i].out_elu != next) out[i].out_elu = nullptr;
    if (!a.up && out[i].out_bf != next) out[i].out_bf = nullptr;
  }
  return n;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ void spin_until(const unsigned long long* p,
                                           unsigned long long target) {
#ifdef LMK_SPIN_LIMIT
  long long spins = 0;
#endif
  while (ld_acquire(p) < target) {
#ifdef LMK_SPIN_LIMIT
    if (++spins > (long long)LMK_SPIN_LIMIT) __trap();
#endif
    __nanosleep(64);
  }
}

// ------------------------------------------------------------------ shared

struct Shared {
  uint32_t ring;       // stage s at ring + s * wstage_bytes(F)
  uint32_t rows;       // the resident operand rows
  uint32_t full;       // full[s] at full + 8 s; empty[s] at full + 8 (STAGES + s)
  uint32_t a_full;     // the rows are in (NPROD cp.async arrivals)
  uint32_t a_empty;    // every consumer warp is done with them
  float* u;            // the block's f32 activation, rows of F + 4
  const Layer* layers;
};

template <int F>
__device__ __forceinline__ Shared shared_of(unsigned char* smem) {
  Shared s;
  s.ring = smem_u32(smem);
  s.rows = s.ring + (uint32_t)ring_bytes(F);
  s.full = s.ring + (uint32_t)bar_off(F);
  s.a_full = s.full + 16 * STAGES;
  s.a_empty = s.a_full + 8;
  s.u = reinterpret_cast<float*>(smem + u_off(F));
  s.layers = reinterpret_cast<const Layer*>(smem + table_off(F));
  return s;
}

__device__ __forceinline__ rr::WRing wring(const Shared& sh) { return rr::WRing{sh.ring, sh.full}; }

// ------------------------------------------------------------------ stages
// Stage j of a round: 0 is phase 0, l + 1 is layer l.

// Slot 8 j + k of stage j: k = 0 its counter published (consumer thread
// 0), 1 its window ready (producer thread 0), 2 its rows in (consumer
// thread 0), 3 / 4 its products done (the first thread of consumer
// warpgroup 0 / 1), 5 / 6 their epilogues done; slot STAMPS - 1 the
// consumers' start.  Only in the block's first round (b < groups).
__device__ __forceinline__ void stamp(const Args& a, int b, int tiles, int slot) {
#ifdef LMK_STAMPS
  if (a.stamps != nullptr && b < (int)gridDim.x / tiles) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    a.stamps[(size_t)blockIdx.x * STAMPS + slot] = t;
  }
#endif
}

// By one consumer thread, after every consumer's stores of stage j of
// round `round` (the named barrier before it orders them).
__device__ __forceinline__ void publish(const Args& a, int b, int tile, int tiles,
                                        int round, int j, int nl) {
  __threadfence();
#ifdef LMK_GRID_SYNC
  // the (k+1)-th arrival of every block: the barrier the flags replace.  A
  // block arrives k + 1 only once every block has arrived k, so the count
  // reads "all blocks done stage k" at k * blocks; the last arrival of the
  // launch resets it.
  unsigned long long* count = a.flags + (size_t)a.B * tiles;
  const unsigned long long k = (unsigned long long)round * (nl + 1) + j;
  spin_until(count, k * gridDim.x);
  const unsigned long long rounds = (a.B + gridDim.x / tiles - 1) / (gridDim.x / tiles);
  const unsigned long long total = rounds * (nl + 1) * gridDim.x;
  if (atomicAdd(count, 1ull) + 1 == total) atomicExch(count, 0ull);
#else
  st_release(a.flags + (size_t)b * tiles + tile, (a.epoch << 8) + j + 1);
#endif
  stamp(a, b, tiles, 8 * j);
}

// By the producer warpgroup: wait until every tile of the window has done
// stage j (the operand rows of stage j + 1 are written).
__device__ __forceinline__ void wait_window(const Args& a, int b, int tile, int tiles,
                                            int round, int j, int nl) {
  const int tid = threadIdx.x - NCONS;
#ifdef LMK_GRID_SYNC
  if (tid == 0) {
    const unsigned long long k = (unsigned long long)round * (nl + 1) + j;
    spin_until(a.flags + (size_t)a.B * tiles, (k + 1) * gridDim.x);
    __threadfence();
  }
#else
  const int nb = tile - a.win + tid;
  if (tid <= 2 * a.win && nb >= 0 && nb < tiles) {
    spin_until(a.flags + (size_t)b * tiles + nb, (a.epoch << 8) + j + 1);
    __threadfence();
  }
#endif
  asm volatile("bar.sync 1, %0;\n" ::"n"(NPROD) : "memory");
}

// ------------------------------------------------------------------ producer

template <int F>
__device__ void produce(const Args& a, const Shared& sh, int groups, int grp, int tile,
                        int tiles, int nl) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
  const int tid = threadIdx.x - NCONS;
  const int p0 = tile * TP;
  const uint32_t rank = CLUSTER > 1 ? (uint32_t)(tile & 1) : 0u;
  uint32_t it = 0;   // ring steps issued (thread 0)
  uint32_t lc = 0;   // layers taken
  for (int round = 0, b = grp; b - grp < a.B; ++round, b += groups) {
    if (b >= a.B) break;
    for (int l = 0; l < nl; ++l, ++lc) {
      const Layer& L = sh.layers[l];
      const uint32_t taps = rr::cluster_taps<CLUSTER>(L, b, tile, tiles);
      const int nk = L.K / F;
      const int nout = L.nout;
      const int kps = rr::slices_per_step(L, F);
      const int n_main = __popc(taps) * (nk / kps);
      const int n_steps = n_main + (L.skip != nullptr ? 1 : 0);
      // step i's weights: (tap, K slices) steps in tap order, then the skip's
      auto issue = [&](int i) {
        const bf16* src;
        uint32_t bytes;
        if (i < n_main) {
          rr::step_weights<F>(L, nout, taps, nk, kps, i, src, bytes);
        } else {
          src = L.ws;
          bytes = 2 * F * F * sizeof(bf16);
        }
        rr::put_step<F, STAGES, CLUSTER>(wring(sh), it, src, bytes, rank);
      };
      // 1. the first STAGES weight steps depend on no activation: their
      //    copies overlap the neighbours' epilogues
      int issued = 0;
      if (tid == 0)
        for (; issued < n_steps && issued < STAGES; ++issued) issue(issued);
      // 2. every consumer warp is done with the last layer's rows
      mbar_wait(sh.a_empty, (lc & 1u) ^ 1u);
      // 3. the window has written this layer's operand rows
      wait_window(a, b, tile, tiles, round, l, nl);
      if (tid == 0) stamp(a, b, tiles, 8 * (l + 1) + 1);
      // 4. the rows, once: the halo each side (the tile's own 128 rows the
      //    consumers' epilogue, or phase 0, wrote here already)
      {
        const int halo = halo_of(L.shifts);
        const int vpr = L.K / 8;
        const int n = 2 * halo * vpr;
        const uint32_t pt = pitch(L.K);
        const bf16* src = L.a + b * L.a_bstride;
#ifndef LMK_NO_COPY
        for (int idx = tid; idx < n; idx += NPROD) {
          int r = idx / vpr;
          const int v = idx - r * vpr;
          if (r >= halo) r += TP;
          const int g = p0 - halo + r;
          const bool ok = g >= 0 && g < a.HW;
          cp_async16(sh.rows + r * pt + v * 16, ok ? src + (size_t)g * L.K + v * 8 : src,
                     ok);
        }
#endif
        cp_async_arrive(sh.a_full);
      }
      // 5. the rest of the layer's weights
      if (tid == 0)
        for (; issued < n_steps; ++issued) issue(issued);
    }
  }
  rr::cluster_sync<CLUSTER>();   // the peer's last arrivals on this block's barriers are in
}

// ------------------------------------------------------------------ consumers

template <int F, bool WIDE>
__device__ void consume_layer(const Args& a, const Shared& sh, const Layer& L, int b,
                              int tile, int tiles, int j, NextRows next, uint32_t& it,
                              uint32_t lc) {
  constexpr int NOUT = WIDE ? 2 * F : F;
  constexpr int KK = F / 16;                      // k16 slices of a step
  constexpr uint32_t WSTAGE = (uint32_t)wstage_bytes(F);
  const int p0 = tile * TP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ra = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);   // rows ra, ra + 8
  const uint32_t bits_a = rr::row_bits<false>(L, a.HW, b, p0 + ra);   // folded masks
  const uint32_t bits_b = rr::row_bits<false>(L, a.HW, b, p0 + ra + 8);
  const uint32_t own = rr::tile_taps(L, b, tile, tiles);
  const uint32_t taps = rr::cluster_taps<CLUSTER>(L, b, tile, tiles);
  const int nk = L.K / F;
  const bool has_skip = !WIDE && L.skip != nullptr;

  // the skip's rows: bf16 pairs of rows ra, ra + 8 as A fragments want them
  uint32_t sk[WIDE ? 1 : KK][4];
  if constexpr (!WIDE) {
    if (has_skip) {
      const bf16* s0 = L.skip + b * L.skip_bstride + (size_t)(p0 + ra) * F + 2 * (lane & 3);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        sk[kk][0] = *reinterpret_cast<const uint32_t*>(s0 + kk * 16);
        sk[kk][1] = *reinterpret_cast<const uint32_t*>(s0 + 8 * F + kk * 16);
        sk[kk][2] = *reinterpret_cast<const uint32_t*>(s0 + kk * 16 + 8);
        sk[kk][3] = *reinterpret_cast<const uint32_t*>(s0 + 8 * F + kk * 16 + 8);
      }
    }
  }
  float acc[NOUT / 2];
  float sacc[WIDE ? 1 : F / 2];
#pragma unroll
  for (int i = 0; i < NOUT / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (WIDE ? 1 : F / 2); ++i) sacc[i] = 0.f;

  const uint32_t pt = pitch(L.K);
  const int halo = halo_of(L.shifts);
  // this lane's ldmatrix row (lanes 0-15: rows 0-15, k 0-7; 16-31: k 8-15)
  const uint32_t lane_row =
      sh.rows + (uint32_t)(ra - (lane >> 2) + (lane & 15) + halo) * pt + (lane >> 4) * 16;
  uint32_t fr0[KK][4], fr1[KK][4];
  // read before the wait: read after it (the wait clobbers memory), ptxas
  // spilled more of the pass and K1 ran slower on the H100
  const int kps = rr::slices_per_step(L, F);
  mbar_wait(sh.a_full, lc & 1u);
  if (threadIdx.x == 0) stamp(a, b, tiles, 8 * j + 2);
  rr::tap_products<F, NOUT, STAGES, CLUSTER>(acc, fr0, fr1, wring(sh), lane_row, pt,
                                             L.shifts, bits_a, bits_b, own, taps, nk,
                                             kps, it);
  if (lane == 0) mbar_arrive(sh.a_empty);   // this warp's last read of the rows
  if constexpr (!WIDE) {
    if (has_skip) {
      // one step: the elu halves' two slices, made in registers
      const uint32_t s = it % STAGES;
      mbar_wait(sh.full + 8 * s, (it / STAGES) & 1u);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sk[kk][i]));
          float px, nx, py, ny;
          elu_halves(v.x, px, nx);
          elu_halves(v.y, py, ny);
          fr0[kk][i] = pack_bf16(px, py);
          fr1[kk][i] = pack_bf16(nx, ny);
        }
#ifndef LMK_NO_MMA
      const uint32_t w = sh.ring + s * WSTAGE;
      wgmma_fence();
      rr::mma_slice<F>(sacc, fr0, w);
      rr::mma_slice<F>(sacc, fr1, w + F * F * 2);
      wgmma_commit();
      wgmma_wait<0>();
#endif
      rr::release_stage<STAGES, CLUSTER>(wring(sh), s);
      ++it;
    }
  }
#pragma unroll
  for (int i = 0; i < NOUT / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
#pragma unroll
  for (int i = 0; i < (WIDE ? 1 : F / 2); ++i) asm volatile("" : "+f"(sacc[i])::"memory");
  if (threadIdx.x % 128 == 0) stamp(a, b, tiles, 8 * j + 3 + threadIdx.x / 128);
#ifndef LMK_NO_EPILOGUE
  // The epilogue reads the layer's fields from a copy in registers: through
  // the shared table every store to device memory would make the compiler
  // load them again (a generic pointer may alias).  The gated conv and the
  // dilated conv carry the activation; the first conv of a gated resnet
  // makes its inner x.
  // The next layer's own rows are written over this layer's: every
  // consumer warp is done reading them first.
  const Layer Le = L;
  if (next.mode != NextRows::NONE) asm volatile("bar.sync 2, %0;\n" ::"n"(NCONS) : "memory");
  epilogue<F, WIDE, true>(Le, a.HW, b, p0, has_skip, acc, sacc,
                          WIDE || L.K == F ? sh.u : nullptr, next);
#endif
  if (threadIdx.x % 128 == 0) stamp(a, b, tiles, 8 * j + 5 + threadIdx.x / 128);
}

// Which of layer L's outputs layer N reads, and where N's own rows lie.
__device__ __forceinline__ NextRows next_rows(const Shared& sh, const Layer& L,
                                              const Layer& N) {
  const int pt = pitch(N.K);
  const uint32_t rows = sh.rows + (uint32_t)(halo_of(N.shifts) * pt);
  if (L.out_elu != nullptr && N.a == L.out_elu) return NextRows{NextRows::ELU, rows, pt};
  if (L.out_bf != nullptr && N.a == L.out_bf) return NextRows{NextRows::BF, rows, pt};
  return NextRows{NextRows::NONE, 0u, 0};
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Phase 0 of candidate b's tile: the pass input -> the resident f32
// activation, ue (elu halves; also layer 0's own rows in shared memory)
// and, up, stack entry 0 (bf16).  8 channels a thread.
template <int F>
__device__ void phase0(const Args& a, const Shared& sh, int b, int p0) {
  constexpr int VPR = F / 8;
  float* us = sh.u;
  const uint32_t pt0 = pitch(2 * F);
  const uint32_t rows0 = sh.rows + (uint32_t)halo_of(sh.layers[0].shifts) * pt0;
  const size_t n_per = (size_t)a.HW * F;
  const size_t sb = (size_t)(3 * a.nr + 3) * n_per;
  const size_t base = ((size_t)b * a.HW + p0) * F;
  for (int idx = threadIdx.x; idx < TP * VPR; idx += NCONS) {
    const int r = idx / VPR;
    const int c = (idx - r * VPR) * 8;
    const size_t o = (size_t)r * F + c;
    float x[8];
    if (a.up) load8(a.u0 + base + o, x);
    else load8(a.stack + b * sb + (size_t)(3 * a.nr + 2) * n_per + (size_t)p0 * F + o, x);
    float* ur = us + r * (F + 4) + c;
    *reinterpret_cast<float4*>(ur) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(ur + 4) = make_float4(x[4], x[5], x[6], x[7]);
    uint32_t pos[4], neg[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p0v, n0v, p1v, n1v;
      elu_halves(x[2 * i], p0v, n0v);
      elu_halves(x[2 * i + 1], p1v, n1v);
      pos[i] = pack_bf16(p0v, p1v);
      neg[i] = pack_bf16(n0v, n1v);
    }
    bf16* row = a.ue + 2 * (base + (size_t)r * F);
    const uint4 vp = make_uint4(pos[0], pos[1], pos[2], pos[3]);
    const uint4 vn = make_uint4(neg[0], neg[1], neg[2], neg[3]);
    *reinterpret_cast<uint4*>(row + c) = vp;
    *reinterpret_cast<uint4*>(row + F + c) = vn;
    // layer 0 (a gated resnet's first conv) reads ue: its own rows
    st_shared_v4(rows0 + r * pt0 + c * 2, vp);
    st_shared_v4(rows0 + r * pt0 + (F + c) * 2, vn);
    if (a.up)
      *reinterpret_cast<uint4*>(a.stack + b * sb + (size_t)p0 * F + o) =
          make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                     pack_bf16(x[6], x[7]));
  }
}

template <int F>
__device__ void consume(const Args& a, const Shared& sh, int groups, int grp, int tile,
                        int tiles, int nl) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  if (threadIdx.x == 0) stamp(a, grp, tiles, STAMPS - 1);
  uint32_t it = 0, lc = 0;
  for (int round = 0, b = grp; b - grp < a.B; ++round, b += groups) {
    if (b >= a.B) {
#ifdef LMK_GRID_SYNC
      // an idle block still arrives at every stage of the grid-wide count
      if (threadIdx.x == 0)
        for (int j = 0; j <= nl; ++j) publish(a, b, tile, tiles, round, j, nl);
#endif
      continue;
    }
    phase0<F>(a, sh, b, tile * TP);
    asm volatile("bar.sync 2, %0;\n" ::"n"(NCONS) : "memory");
    if (threadIdx.x == 0) publish(a, b, tile, tiles, round, 0, nl);
    for (int l = 0; l < nl; ++l, ++lc) {
      const Layer& L = sh.layers[l];
      const NextRows next = l + 1 < nl ? next_rows(sh, L, sh.layers[l + 1])
                                       : NextRows{NextRows::NONE, 0u, 0};
      if (L.nout == 2 * F) consume_layer<F, true>(a, sh, L, b, tile, tiles, l + 1, next, it, lc);
      else consume_layer<F, false>(a, sh, L, b, tile, tiles, l + 1, next, it, lc);
      asm volatile("bar.sync 2, %0;\n" ::"n"(NCONS) : "memory");
      if (threadIdx.x == 0) publish(a, b, tile, tiles, round, l + 1, nl);
    }
  }
  rr::cluster_sync<CLUSTER>();
}

template <int F>
__global__ void __launch_bounds__(NTHREADS, 1) pass_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Shared sh = shared_of<F>(smem);
  const int tiles = a.HW / TP;
  const int groups = gridDim.x / tiles;
  const int grp = blockIdx.x / tiles;
  const int tile = blockIdx.x - grp * tiles;
  const int nl = n_layers(a.up, a.nr);
  if (threadIdx.x == 0) {
    build_layers(a, reinterpret_cast<Layer*>(smem + table_off(F)));
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sh.full + 8 * s, 1);                                 // the bulk copies' issuer
      mbar_init(sh.full + 8 * (STAGES + s), CLUSTER * NCONS / 32);   // both blocks' consumer warps
    }
    mbar_init(sh.a_full, NPROD);
    mbar_init(sh.a_empty, NCONS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  rr::cluster_sync<CLUSTER>();   // the peer's barriers exist before anything reaches them
  if (threadIdx.x >= NCONS) produce<F>(a, sh, groups, grp, tile, tiles, nl);
  else consume<F>(a, sh, groups, grp, tile, tiles, nl);
}

// ------------------------------------------------------------------ host

// Candidates the card runs at once (groups of HW / TP blocks), cached per
// instantiation and device.
template <int F>
static cudaError_t resident_groups(int HW, int* out) {
  static int cached_dev = -1, cached_blocks = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != cached_dev) {
    e = cudaFuncSetAttribute(pass_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(F));
    if (e != cudaSuccess) return e;
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if constexpr (CLUSTER > 1) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(2 * sms);
      cfg.blockDim = dim3(NTHREADS);
      cfg.dynamicSmemBytes = smem_bytes(F);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = CLUSTER;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int clusters = 0;
      e = cudaOccupancyMaxActiveClusters(&clusters, pass_kernel<F>, &cfg);
      if (e != cudaSuccess) return e;
      cached_blocks = clusters * CLUSTER;
    } else {
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pass_kernel<F>, NTHREADS,
                                                        smem_bytes(F));
      if (e != cudaSuccess) return e;
      cached_blocks = per_sm * sms;
    }
    cached_dev = dev;
  }
  *out = cached_blocks / (HW / TP);
  return cudaSuccess;
}

template <int F>
static cudaError_t launch_pass(const Args& a, cudaStream_t st) {
  int groups = 0;
  cudaError_t e = resident_groups<F>(a.HW, &groups);
  if (e != cudaSuccess) return e;
  if (groups > a.B) groups = a.B;
  if (groups < 1) return cudaErrorInvalidValue;   // one candidate exceeds the card
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * (a.HW / TP));
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem_bytes(F);
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;   // every block resident: the waits end
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = CLUSTER;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER > 1 ? 2 : 1;
  e = cudaLaunchKernelEx(&cfg, pass_kernel<F>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The checks the pass needs of a shape; `win` must cover every layer's
// reach.  A candidate's tiles pair into clusters, so HW / TP is even.
inline bool pass_shape_ok(const Args& a) {
  if (!width_ok(a.F) || a.HW % (TP * CLUSTER) != 0 || a.nr < 1 || a.nr > NR_MAX)
    return false;
  const int h1 = halo_of(a.s1), hd = halo_of(a.sd);
  if (TP + 2 * h1 > rows_cap(2 * a.F) || TP + 2 * hd > rows_cap(a.F)) return false;
  const int need = ((h1 > hd ? h1 : hd) + TP - 1) / TP;
  return a.win >= need;
}

inline cudaError_t run_pass(const Args& a, cudaStream_t st) {
  if (!pass_shape_ok(a)) return cudaErrorInvalidValue;
  switch (a.F) {
    case 16: return launch_pass<16>(a, st);
    case 32: return launch_pass<32>(a, st);
    case 48: return launch_pass<48>(a, st);
    case 64: return launch_pass<64>(a, st);
    case 80: return launch_pass<80>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

inline cudaError_t query_groups(int F, int HW, int* groups) {
  switch (F) {
    case 16: return resident_groups<16>(HW, groups);
    case 32: return resident_groups<32>(HW, groups);
    case 48: return resident_groups<48>(HW, groups);
    case 64: return resident_groups<64>(HW, groups);
    case 80: return resident_groups<80>(HW, groups);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pass
}  // namespace lmk
