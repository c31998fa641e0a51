// K3: the locally masked convolution, for Hopper (sm_90a).
//
// Replaces the TPU kernel of pixelsynth_tpu/ops/masked_conv_pallas.py
// (_kernel, :26):
//   out[p] = sum_t m_t[p] * (x[p + o_t] @ W_t) + b
// over the 9 taps of a 3x3 kernel with dilation d, zero outside the image.
//
// Design (bf16 operands, f32 sums).  The TPU kernel keeps G whole images
// in VMEM and runs nine big matmuls; a candidate's (1024 x 160) bf16
// activation is 320 KB, more than a block's shared memory.  So a block
// owns 128 positions of one candidate and all Cout, and the host picks one
// of two routes by the shape alone (`route_of`; ops/
// masked_conv_kernel.py `k3_route` is its twin, and a call whose route
// differs is refused):
//   * RESIDENT (every shape the port runs: 32x32 and 16x16 grids).  Every
//     thread of the block reads the tile's 128 rows and the halo each side
//     (d * W + d rows) of x once, as f32, rounds them to bf16 (round to
//     nearest even, as the plain version's cast) and stores them in the
//     resident region of resident_rows.cuh.  A call is then one kernel: no
//     cast launch, no bf16 copy of x in device memory.  The ring carries
//     weights only, as deep as the shared memory left beside the rows
//     allows (k3_stages: 6 stages of 25.6 KB at F = 80), and the two
//     consumer warpgroups take each tap's rows with ldmatrix into wgmma's
//     register operand (`rr::tap_products`, K1's pass has the same loop).
//     The rows are 194 x 336 B at (Cin, W, d) = (160, 32, 1), 260 x 176 B
//     at (80, 32, 2); the region holds 72 KB (W <= 44 at Cin = 160).
//     Built with K3_CLUSTER=2, the two blocks of a cluster (neighbouring
//     tiles of one candidate) share the weights' copies (multicast: each
//     producer copies half of every step into both blocks);
//   * STREAMED (grids whose rows and halo exceed the region): K4's per-tap
//     body of lmconv_layer.cuh, whose producer loads the f32 rows of each
//     (tap, K slice) step and rounds them into the stage.
// The masks are the raw (B, HW, 9) ones ({0, 1} entries), so the kernel
// zero-pads itself: a tap whose source row or column leaves the image is
// not read (guard_image), and a tap whose mask is 0 is not read either --
// never multiplied by 0, since 0 * NaN = NaN.  A (tile, tap) that is off on
// the whole tile is no ring step.  The resident route's epilogue adds the
// bias and writes the f32 tile into shared memory over the ring, then one
// bulk copy a row stores it (the block's 128 output rows are contiguous);
// the streamed route's stores from the accumulator registers, 16 bytes a
// lane.
// (Cin, Cout) are arguments: each must be F or 2F for one width F, a
// multiple of 16 up to 80 (the trunk's shapes: (2F, F), (2F, 2F), (F, F),
// and (F, 2F)); anything else is refused.
//
// compute_dtype float32 has its own kernel on the CUDA cores
// (masked_conv_f32_kernel): a block stages 8 positions' shifted rows per
// tap in shared memory, each thread owns output channels, and the f32 FMAs
// follow the plain version's order (per tap: the product, scaled by the
// mask value, then accumulated); a tap whose mask is 0 at all 8 positions
// is skipped (a 1x1 product run as a centre-tap conv pays for one tap).
// It serves the f32 and out-of-shape routes of K1 and K4 and holds the
// indexing to 1e-4 against the plain version; it is not built for speed.
//
// Bound on this card (pop 16, 32x32, Cin = Cout = 160): 2 * 9 * 16384 *
// 160 * 160 = 7.5 GFLOP dense on bf16 tensor cores (7.6 us at 989
// TFLOP/s) against 10.5 MB of f32 x, 10.5 MB of output and 0.6 MB of masks
// (6.4 us at 3.35 TB/s).  The resident route's own floor is the L2 -> SM
// bytes: each block reads its rows once (124 KB of f32 at (160, 160)) and
// every active step's weights (25.6 KB a step, 18 steps dense), 75 MB
// over 128 blocks dense, half the weights' part with multicast.

#include "resident_rows.cuh"

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
    float mt[PT];
    bool on = false;
#pragma unroll
    for (int r = 0; r < PT; ++r) {
      mt[r] = mask[((size_t)b * HW + p0 + r) * 9 + t];
      on |= mt[r] != 0.f;
    }
    // a tap whose mask is 0 at all PT positions adds nothing: every thread
    // reads the same values, so the whole block skips it together
    if (!on) continue;
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


// ------------------------------------------------------------ streamed route

// One launch of a layer with f32 operand rows x (K3's streamed route): a
// block per TP positions of one candidate.
template <int F, bool WIDE>
__global__ void __launch_bounds__(NTHREADS, 1)
layer_kernel(const __grid_constant__ Layer L, int HW, const float* x) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles = HW / TP;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - b * tiles) * TP;
  ring_init<F>(smem);
  uint32_t it = 0;
  layer_body<F, WIDE, true, true>(L, HW, b, p0, smem, it, x);
}

// `static`: each library that includes this header has its own copy of the
// kernel, so it needs its own flag too (a local static of a function with
// external linkage is one object across every library loaded).
template <int F, bool WIDE>
static cudaError_t launch_layer_as(const Layer& L, int B, int HW, const float* x,
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
  layer_kernel<F, WIDE><<<B * HW / TP, NTHREADS, smem, st>>>(L, HW, x);
  return cudaGetLastError();
}

template <int F>
static cudaError_t launch_layer_of(const Layer& L, int B, int HW, const float* x,
                                   cudaStream_t st) {
  return L.nout == 2 * F ? launch_layer_as<F, true>(L, B, HW, x, st)
                         : launch_layer_as<F, false>(L, B, HW, x, st);
}

// Launch layer L of width F (a multiple of 16 up to 80; L.nout is F or 2F)
// on B candidates of HW positions, HW a multiple of TP, operand rows x.
static cudaError_t launch_layer(const Layer& L, int B, int HW, int F, const float* x,
                                cudaStream_t st) {
  if (HW % TP != 0 || (L.nout != F && L.nout != 2 * F))
    return cudaErrorInvalidValue;
  switch (F) {
    case 16: return launch_layer_of<16>(L, B, HW, x, st);
    case 32: return launch_layer_of<32>(L, B, HW, x, st);
    case 48: return launch_layer_of<48>(L, B, HW, x, st);
    case 64: return launch_layer_of<64>(L, B, HW, x, st);
    case 80: return launch_layer_of<80>(L, B, HW, x, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ resident route

#ifndef K3_CLUSTER
#define K3_CLUSTER 1
#endif
constexpr int CL = K3_CLUSTER;
static_assert(CL == 1 || CL == 2, "K3_CLUSTER is 1 or 2");

// The ring as deep as the shared memory beside the rows allows, at most 8.
__host__ __device__ constexpr int k3_stages(int F) {
  constexpr size_t room = 232448 - rr::A_REGION - 2 * 8 * sizeof(uint64_t);
  return room / rr::wstage_bytes(F) < 8 ? (int)(room / rr::wstage_bytes(F)) : 8;
}
// ring | resident rows | full[NST], empty[NST]
__host__ __device__ constexpr size_t k3_smem(int F) {
  return k3_stages(F) * rr::wstage_bytes(F) + rr::A_REGION +
         2 * k3_stages(F) * sizeof(uint64_t);
}
static_assert(k3_smem(80) <= 232448, "K3's resident route fits a block");

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The region's rows: positions p0 - halo + r of candidate b of x (B, HW,
// L.K) f32 -> bf16, 8 channels a thread and vector; zeros outside [0, HW).
// Four vectors' loads are in flight before their stores.
__device__ __forceinline__ void load_rows(const Layer& L, const float* x, int HW, int b,
                                          int p0, int halo, uint32_t rows) {
  constexpr int U = 4;
  const int vpr = L.K / 8;
  const int n = (TP + 2 * halo) * vpr;
  const uint32_t pt = rr::pitch(L.K);
  const float* src = x + (size_t)b * HW * L.K;
  for (int base = threadIdx.x; base < n; base += U * NTHREADS) {
    float4 lo[U], hi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * NTHREADS;
      const int r = idx / vpr;
      const int g = p0 - halo + r;
      lo[u] = hi[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < n && g >= 0 && g < HW) {
        const float4* q = reinterpret_cast<const float4*>(
            src + (size_t)g * L.K + (idx - r * vpr) * 8);
        lo[u] = __ldg(q);
        hi[u] = __ldg(q + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * NTHREADS;
      if (idx < n) {
        const int r = idx / vpr;
        st_shared_v4(rows + r * pt + (idx - r * vpr) * 16,
                     make_uint4(pack_bf16(lo[u].x, lo[u].y), pack_bf16(lo[u].z, lo[u].w),
                                pack_bf16(hi[u].x, hi[u].y), pack_bf16(hi[u].z, hi[u].w)));
      }
    }
  }
}

// The epilogue through shared memory: once both consumer warpgroups are
// done with the ring, the block's (128, NOUT) f32 result (bias added) is
// written over it, rows NOUT + 8 floats apart (two wavefronts a float2
// store), and each row, contiguous in `out`, leaves by one bulk copy (one
// thread a row).  The bias loads come before any store.  Stored from the
// registers instead (the `epilogue` of lmconv_layer.cuh, which the streamed
// route keeps), the same tile took longer on the H100.
template <int NOUT>
__device__ __forceinline__ void store_tile(const Layer& L, int HW, int b, int p0,
                                           float (&acc)[NOUT / 2], uint32_t tile) {
  constexpr int PITCH = NOUT + 8;   // floats
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int r0 = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  float2 bi[NOUT / 8];
#pragma unroll
  for (int j = 0; j < NOUT / 8; ++j)
    bi[j] = *reinterpret_cast<const float2*>(L.bias + 8 * j + 2 * q);
  asm volatile("bar.sync 2, %0;\n" ::"n"(NCONS) : "memory");   // the ring is free
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NOUT / 8; ++j) {
      const uint32_t a = tile + ((r0 + 8 * h) * PITCH + 8 * j + 2 * q) * 4;
      const float x = acc[4 * j + 2 * h] + bi[j].x;
      const float y = acc[4 * j + 2 * h + 1] + bi[j].y;
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(x), "f"(y) : "memory");
    }
  fence_async_shared();
  asm volatile("bar.sync 2, %0;\n" ::"n"(NCONS) : "memory");
  if (threadIdx.x < TP) {
    float* dst = L.out + ((size_t)b * HW + p0 + threadIdx.x) * NOUT;
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
        "r"(tile + threadIdx.x * PITCH * 4), "r"(NOUT * 4)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// One block per 128 positions of one candidate (clusters of CL
// neighbouring tiles); the operand rows are x (B, HW, L.K) f32, L.linear is
// set; `halo` = max|s_t|.
template <int F, bool WIDE>
__global__ void __launch_bounds__(NTHREADS, 1)
resident_kernel(const __grid_constant__ Layer L, int HW, int halo, const float* x) {
  constexpr int NOUT = WIDE ? 2 * F : F;
  constexpr int NST = k3_stages(F);
  constexpr int KK = F / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles = HW / TP;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int p0 = tile * TP;
  const uint32_t base = smem_u32(smem);
  const rr::WRing ring{base, base + (uint32_t)(NST * rr::wstage_bytes(F) + rr::A_REGION)};
  const uint32_t rows = base + (uint32_t)(NST * rr::wstage_bytes(F));
  const uint32_t taps = rr::cluster_taps<CL>(L, b, tile, tiles);
  const int nk = L.K / F;
  const int kps = rr::slices_per_step(L, F);
  const int n_steps = __popc(taps) * (nk / kps);
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(ring.full + 8 * s, 1);                        // the bulk copies' issuer
      mbar_init(ring.full + 8 * (NST + s), CL * NCONS / 32);  // the cluster's consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  rr::cluster_sync<CL>();   // the peer's barriers exist before anything reaches them
  // the first NST weight steps depend on nothing: in flight while the rows
  // come in
  const uint32_t rank = CL > 1 ? (uint32_t)(tile & 1) : 0u;
  uint32_t it = 0;
  int issued = 0;
  auto issue = [&]() {
    const bf16* src;
    uint32_t bytes;
    rr::step_weights<F>(L, NOUT, taps, nk, kps, issued, src, bytes);
    rr::put_step<F, NST, CL>(ring, it, src, bytes, rank);
    ++issued;
  };
  if (threadIdx.x == NCONS)
    while (issued < n_steps && issued < NST) issue();
#ifndef LMK_NO_COPY
  load_rows(L, x, HW, b, p0, halo, rows);
#endif
  __syncthreads();   // the rows are in (generic stores, read by ldmatrix)
  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NCONS)
      while (issued < n_steps) issue();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int ra = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);   // rows ra, ra + 8
    const uint32_t bits_a = rr::row_bits<true>(L, HW, b, p0 + ra);   // raw masks
    const uint32_t bits_b = rr::row_bits<true>(L, HW, b, p0 + ra + 8);
    const uint32_t own = rr::tile_taps(L, b, tile, tiles);
    const uint32_t pt = rr::pitch(L.K);
    // this lane's ldmatrix row (lanes 0-15: rows 0-15, k 0-7; 16-31: k 8-15)
    const uint32_t lane_row =
        rows + (uint32_t)(ra - (lane >> 2) + (lane & 15) + halo) * pt + (lane >> 4) * 16;
    float acc[NOUT / 2];
#pragma unroll
    for (int i = 0; i < NOUT / 2; ++i) acc[i] = 0.f;
    uint32_t fr0[KK][4], fr1[KK][4];
    uint32_t cit = 0;
    rr::tap_products<F, NOUT, NST, CL>(acc, fr0, fr1, ring, lane_row, pt, L.shifts, bits_a,
                                       bits_b, own, taps, nk, kps, cit);
#pragma unroll
    for (int i = 0; i < NOUT / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
#ifndef LMK_NO_EPILOGUE
    static_assert((size_t)TP * (NOUT + 8) * 4 <= NST * rr::wstage_bytes(F) + rr::A_REGION,
                  "the result tile fits the ring and the rows");
    store_tile<NOUT>(L, HW, b, p0, acc, base);
#endif
  }
  rr::cluster_sync<CL>();   // the peer's last arrivals on this block's barriers are in
}

template <int F, bool WIDE>
static cudaError_t launch_resident_as(const Layer& L, int B, int HW, int halo,
                                      const float* x, cudaStream_t st) {
  constexpr size_t smem = k3_smem(F);
  static int attr_dev = -1;   // the attribute is set once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != attr_dev) {
    e = cudaFuncSetAttribute(resident_kernel<F, WIDE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_dev = dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * (HW / TP));
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, resident_kernel<F, WIDE>, L, HW, halo, x);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int F>
static cudaError_t launch_resident_of(const Layer& L, int B, int HW, int halo,
                                      const float* x, cudaStream_t st) {
  return L.nout == 2 * F ? launch_resident_as<F, true>(L, B, HW, halo, x, st)
                         : launch_resident_as<F, false>(L, B, HW, halo, x, st);
}

static cudaError_t launch_resident(const Layer& L, int B, int HW, int F, int halo,
                                   const float* x, cudaStream_t st) {
  switch (F) {
    case 16: return launch_resident_of<16>(L, B, HW, halo, x, st);
    case 32: return launch_resident_of<32>(L, B, HW, halo, x, st);
    case 48: return launch_resident_of<48>(L, B, HW, halo, x, st);
    case 64: return launch_resident_of<64>(L, B, HW, halo, x, st);
    case 80: return launch_resident_of<80>(L, B, HW, halo, x, st);
    default: return cudaErrorInvalidValue;
  }
}

// The layer width F of (Cin, Cout), 0 when the bf16 kernels take neither.
int width_of(int Cin, int Cout) {
  if (width_ok(Cin) && (Cout == Cin || Cout == 2 * Cin)) return Cin;
  if (Cin % 2 == 0 && width_ok(Cin / 2) && (Cout == Cin || Cout == Cin / 2)) return Cin / 2;
  return 0;
}

// 1: the resident route takes the shape (a tile's rows and halo fit the
// region, and the candidate's tiles pair into clusters); 0: the streamed
// route.  The shape alone decides.
int route_of(int H, int W, int Cin, int d) {
  const int halo = d * W + d;
  return (TP + 2 * halo) * rr::pitch(Cin) <= (int)rr::A_REGION && (H * W / TP) % CL == 0;
}

}  // namespace

extern "C" {

// bf16 operands, f32 accumulation.  x (B, HW, Cin) f32, rounded to bf16
// by the kernel; mask (B, HW, 9) f32 with {0, 1} entries, NOT
// boundary-folded; tile_taps (B, HW/128, 9) int32 (or null: every tap is
// copied); w the packed image of the (9, Cin, Cout) bf16 taps at width F
// (ops/conv_pack.py); bias (Cout) f32; out (B, HW, Cout) f32.  `route`:
// 1 resident, 0 streamed; it must be route_of's for the shape.
int masked_conv_bf16(const void* x, const void* mask, const void* tile_taps,
                     const void* w, const void* bias, void* out, int B, int H, int W,
                     int Cin, int Cout, int dilation, int route, void* stream) {
  const int HW = H * W;
  const int F = width_of(Cin, Cout);
  if (F == 0 || HW % TP != 0 || route != route_of(H, W, Cin, dilation))
    return (int)cudaErrorInvalidValue;
  int sh[9];
  make_shifts(sh, W, dilation);
  Layer L = conv_layer(nullptr, 0, Cin, (const float*)mask, (const int*)tile_taps,
                       (const bf16*)w, (const float*)bias, Cout, sh);
  guard_image(L, H, W, dilation);
  L.linear = 1;
  L.out = (float*)out;
  const float* x32 = (const float*)x;
  if (route)
    return (int)launch_resident(L, B, HW, F, rr::halo_of(sh), x32, (cudaStream_t)stream);
  return (int)launch_layer(L, B, HW, F, x32, (cudaStream_t)stream);
}

int masked_conv_cluster() { return CL; }

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
