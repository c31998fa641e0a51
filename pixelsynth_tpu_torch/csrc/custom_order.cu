// The greedy generation order of the locally-masked PixelCNN, on the card,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the counterpart of an XLA loop,
// pixelsynth_tpu/ops/orders_jax.py custom_order_jax (:33), a lax.fori_loop
// of HW masked-argmax steps.  It was added because the order is the one
// stage of the view step left on the host (a heap in Python, after a
// device -> host copy of the distances), and a plain torch loop launches
// about six ops for each of the HW - 1 = 1023 dependent steps of a 32x32
// grid: thousands of launches a view.
//
// What it computes, bit for bit the JAX loop and the reference's heap
// (get_custom_order.pyx:50-82): score[p] = d[p] * 10000 - p, unique per
// pixel for HW < 10000, so "largest distance, then smallest flat index"
// is one integer maximum with no ties.  Start at the maximum score; then
// HW - 1 times push the unvisited 4-neighbours of the last pixel taken
// into the frontier, and take the frontier's maximum.  A score decodes to
// its pixel: p = (-score) mod 10000.  Overflow: |d| is at most the grid's
// diagonal, below 14143 for HW < 10000, so |d| * 10000 < 2^31 (at 32x32,
// |d| <= 45).
//
// Design.  The steps depend on each other, so a step's latency is the
// cost, and a block barrier a step (~1 us) would make an image ~1 ms.  So
// one WARP takes one image, no step has a barrier, a reduction, a rescan
// or a shared store, and the loop reads only tables fixed before it starts:
//   * rank once: the warp orders the pixels by descending score (unique,
//     so the order is total) in shared memory: where the distances' span
//     fits the table (every distance grid of a view: |d| is at most the
//     diagonal), a stable counting sort by d, descending (a histogram, a
//     scan, then 32 pixels at a time in index order, __match_any_sync
//     ranking equal values), which is the scores' order; otherwise a
//     bitonic network over the scores themselves (a third of the kernel's
//     time at 32x32, PERF.md).  It keeps pixel_of_rank[r] and, for each
//     rank, the ranks of its four in-grid neighbours (-1 off the grid) as
//     one 8-byte row: "the frontier's largest score" becomes "the
//     frontier's lowest rank";
//   * the frontier and the visited set are bitmasks over ranks, in
//     registers: rank r is bit r & 31 of word r >> 5, and lane l holds
//     words l * K .. l * K + K - 1 (K = 1 up to 1024 pixels, a template
//     parameter up to 10 words a lane for HW < 10000; smaller grids leave
//     lanes empty);
//   * push: one 8-byte shared load gives the popped rank's neighbours'
//     ranks; the lane that owns a neighbour's word sets its frontier bit
//     unless its visited bit is set (no shared store, so no __syncwarp);
//   * pop: each lane takes its lowest set rank beforehand (its first
//     non-empty word's lowest bit); one __ballot_sync of "my words are not
//     empty", __ffs for the lowest such lane, one __shfl_sync of that
//     lane's rank; the owner clears the bit.  A pop by one
//     __reduce_min_sync of the lanes' ranks has the faster links alone
//     (`order_chain_floor`) but made the whole kernel no faster (PERF.md);
//   * the order: lane t % 32 keeps the pixel of step t, and every 32
//     steps the warp writes 32 entries at once, off the chain.
// A step's chain is a shared load, a few integer operations, a ballot, an
// __ffs and a shuffle.  B images go in one launch, one warp (block) each.
//
// Bound on this card: neither bytes nor operations.  It reads 4 bytes and
// writes 4 bytes a pixel (8 KB an image at 32x32), and the arithmetic is
// a few thousand integer operations an image; the 1023 dependent steps,
// each at least a shared load, a ballot and a shuffle deep, are what it
// takes.  `order_chain_floor` times such links alone, for comparison.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int KEY_SCALE = 10000;
constexpr int MAX_D = 214000;   // |d| below it: d * KEY_SCALE - p fits in an int
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int pixel_of(int score) {
  int r = (-score) % KEY_SCALE;
  return r < 0 ? r + KEY_SCALE : r;
}

// bytes of the sort keys, later the neighbour rows, then rank and
// pixel_of_rank (int16 each)
__host__ __device__ inline size_t table_bytes(int HW, int n) {
  const size_t keys = (size_t)4 * n, rows = (size_t)8 * HW;
  return keys > rows ? keys : rows;
}

template <int K>
__global__ void __launch_bounds__(32)
custom_order_kernel(const int* __restrict__ dist, int* __restrict__ out, int H,
                    int W, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = H * W;
  const int lane = threadIdx.x;
  int* keys = reinterpret_cast<int*>(smem);               // n: scores, sorted
  short4* nbr = reinterpret_cast<short4*>(smem);          // HW: after the sort
  short* rank = reinterpret_cast<short*>(smem + table_bytes(HW, n));   // HW
  short* pix = rank + HW;                                 // HW: pixel_of_rank
  const int* d = dist + (size_t)blockIdx.x * HW;

  // rank once
  int lo = INT_MAX, hi = INT_MIN;
  for (int p = lane; p < HW; p += 32) {
    lo = min(lo, d[p]);
    hi = max(hi, d[p]);
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  const long long span = (long long)hi - lo + 1;
  if (span <= (long long)(table_bytes(HW, n) / 4) && lo > -MAX_D && hi < MAX_D) {
    // a stable counting sort by d, descending, p ascending within a value
    int* start = keys;   // span: the first rank of each value, largest first
    for (int i = lane; i < span; i += 32) start[i] = 0;
    __syncwarp();
    for (int p = lane; p < HW; p += 32) atomicAdd(&start[hi - d[p]], 1);
    __syncwarp();
    const int per = (int)((span + 31) / 32);
    const int b0 = min(lane * per, (int)span), b1 = min(b0 + per, (int)span);
    int sum = 0;
    for (int i = b0; i < b1; ++i) sum += start[i];
    int incl = sum;   // the lanes' inclusive scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    for (int i = b0, run = incl - sum; i < b1; ++i) {
      const int c = start[i];
      start[i] = run;
      run += c;
    }
    __syncwarp();
    const unsigned below = (1u << lane) - 1u;
    for (int p0 = 0; p0 < HW; p0 += 32) {   // 32 pixels at a time, in order
      const int p = p0 + lane;
      const int v = p < HW ? hi - d[p] : -1;
      const unsigned peers = __match_any_sync(FULL, v);
      const int r = start[max(v, 0)] + __popc(peers & below);
      __syncwarp();
      if (p < HW && !(peers & below)) start[v] += __popc(peers);
      __syncwarp();
      if (p < HW) {
        pix[r] = (short)p;
        rank[p] = (short)r;
      }
    }
  } else {
    // a bitonic network over n = 2^k >= HW scores, descending
    for (int i = lane; i < n; i += 32) keys[i] = i < HW ? d[i] * KEY_SCALE - i : INT_MIN;
    __syncwarp();
    for (int k = 2; k <= n; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll 4
        for (int q = lane; q < n / 2; q += 32) {   // independent compare-swaps
          const int i = 2 * q - (q & (j - 1));
          const int a = keys[i], b = keys[i + j];
          if ((i & k) == 0 ? a < b : a > b) {
            keys[i] = b;
            keys[i + j] = a;
          }
        }
        __syncwarp();
      }
    }
    for (int r = lane; r < HW; r += 32) {
      const int p = pixel_of(keys[r]);
      pix[r] = (short)p;
      rank[p] = (short)r;
    }
  }
  __syncwarp();
  for (int r = lane; r < HW; r += 32) {   // the rows overwrite the keys
    const int p = pix[r];
    const int row = p / W, c = p - row * W;
    nbr[r] = make_short4(row > 0 ? rank[p - W] : -1, row < H - 1 ? rank[p + W] : -1,
                         c > 0 ? rank[p - 1] : -1, c < W - 1 ? rank[p + 1] : -1);
  }
  __syncwarp();

  uint32_t F[K], V[K];   // this lane's words of the frontier and visited masks
#pragma unroll
  for (int i = 0; i < K; ++i) F[i] = V[i] = 0u;
  if (lane == 0) V[0] = 1u;   // rank 0, the maximum score, is the start
  int cur = 0;
  int mine = lane == 0 ? pix[0] : 0;   // the order's entry of step t = lane (mod 32)
  int* o = out + (size_t)blockIdx.x * HW;
  for (int t = 1; t < HW; ++t) {
    // push: the owner of each neighbour's word sets its bit, if unvisited
    const short4 nb = nbr[cur];
    const int q[4] = {nb.x, nb.y, nb.z, nb.w};
#pragma unroll
    for (int i = 0; i < K; ++i) {
      uint32_t add = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e)   // -1 >> 5 is -1: no lane owns it
        if ((q[e] >> 5) == lane * K + i) add |= 1u << (q[e] & 31);
      add &= ~V[i];
      V[i] |= add;
      F[i] |= add;
    }
    // pop: each lane's lowest set rank (or none), then the warp's lowest
    int fi = 0;
    uint32_t fw = 0u;
#pragma unroll
    for (int i = K - 1; i >= 0; --i)
      if (F[i]) {
        fi = i;
        fw = F[i];
      }
    const unsigned mr = fw ? ((unsigned)(lane * K + fi) << 5) | (__ffs(fw) - 1) : ~0u;
    const int L = __ffs(__ballot_sync(FULL, fw != 0u)) - 1;
    const int r = (int)__shfl_sync(FULL, mr, L);
    if (lane == L) {
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (i == fi) F[i] &= F[i] - 1u;   // clears the lowest set bit, r's
    }
    cur = r;
    // the order, off the chain
    if (lane == (t & 31)) mine = pix[r];
    if ((t & 31) == 31) o[t - 31 + lane] = mine;
  }
  const int g0 = (HW - 1) & ~31;
  if (g0 + lane < HW) o[g0 + lane] = mine;
}

template <int K>
int launch(const int* dist, int* out, int B, int H, int W, int n, size_t smem,
           cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        custom_order_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  custom_order_kernel<K><<<B, 32, smem, stream>>>(dist, out, H, W, n);
  return (int)cudaGetLastError();
}

// The links of a step's chain alone, for one warp: `steps` dependent
// iterations of (mode 0) one shared load and one __reduce_max_sync, as
// the first design's step had twice, or (mode 1) one __ballot_sync, one
// __ffs and one __shfl_sync, as this design's pop.  out[0] keeps the
// value live, out[1] is the loop's clock64 cycles.
__global__ void __launch_bounds__(32) chain_floor_kernel(int mode, int steps, int* out) {
  __shared__ int s[1024];
  const int lane = threadIdx.x;
  for (int i = lane; i < 1024; i += 32) s[i] = (i * 37 + 11) & 1023;
  __syncwarp();
  int x = lane;
  const long long t0 = clock64();
  if (mode == 0) {
    for (int t = 0; t < steps; ++t) x = __reduce_max_sync(FULL, s[x] + lane) & 1023;
  } else {
    for (int t = 0; t < steps; ++t) {
      const int L = __ffs(__ballot_sync(FULL, (x + lane) & 1)) - 1;
      x = __shfl_sync(FULL, x + lane, L & 31) & 1023;
    }
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = x;
    out[1] = (int)(t1 - t0);
  }
}

}  // namespace

extern "C" {

// dist (B, H, W) int32 signed distances -> out (B, H*W) int32 flat order.
// H * W < 10000.  One launch.
int custom_order(const void* dist, void* out, int B, int H, int W,
                 void* stream) {
  const int HW = H * W;
  if (B < 1 || H < 1 || W < 1 || HW >= KEY_SCALE)
    return (int)cudaErrorInvalidValue;
  int n = 1;
  while (n < HW) n <<= 1;
  const size_t smem = table_bytes(HW, n) + (size_t)4 * HW;
  const int words = (HW + 31) / 32;
  const int K = (words + 31) / 32;   // words a lane
  const int* d = (const int*)dist;
  int* o = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 1) return launch<1>(d, o, B, H, W, n, smem, s);
  if (K <= 2) return launch<2>(d, o, B, H, W, n, smem, s);
  if (K <= 4) return launch<4>(d, o, B, H, W, n, smem, s);
  return launch<10>(d, o, B, H, W, n, smem, s);
}

// The chain-floor probe: one warp, `steps` iterations of `mode` (see
// chain_floor_kernel); out (2,) int32 on the card.
int order_chain_floor(int mode, int steps, void* out, void* stream) {
  if (mode < 0 || mode > 1 || steps < 1) return (int)cudaErrorInvalidValue;
  chain_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(mode, steps, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
