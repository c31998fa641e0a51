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
// one WARP takes one image and no step has a block barrier:
//   * shared memory holds the scores, the frontier's keys (the score where
//     the pixel is in the frontier, else EMPTY), a used byte and a byte of
//     in-grid neighbour bits a pixel, and the order;
//   * lane l owns the pixels q with q % 32 == l, their keys stored side by
//     side at l * chunk + q / 32 (chunk = ceil(HW / 32)), and keeps their
//     maximum in a register: owners and slots are a mask and a shift, and
//     the step has no integer division (the neighbour bits are made once);
//   * a push is done by the owner of the neighbour, which raises its
//     maximum (no rescan);
//   * a pop is one __reduce_max_sync over the lanes' maxima (redux.sync);
//     the popped pixel's owner's keys are then rescanned by all 32 lanes
//     together, one conflict-free shared load each (chunk <= 32 at 32x32)
//     and one more redux, and only the owner's maximum changes;
//   * __syncwarp orders the pushes' shared stores before the rescan's
//     loads, and each step's stores before the next step.
// B images go in one launch, one warp (block) each.
//
// Bound on this card: neither bytes nor operations.  It reads 4 bytes and
// writes 4 bytes a pixel (8 KB an image at 32x32), and the arithmetic is
// a few thousand integer operations an image; the 1023 dependent steps,
// each at least a shared load and a warp reduction deep, are what it takes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int KEY_SCALE = 10000;
constexpr int EMPTY = INT_MIN;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int pixel_of(int score) {
  int r = (-score) % KEY_SCALE;
  return r < 0 ? r + KEY_SCALE : r;
}

__global__ void __launch_bounds__(32)
custom_order_kernel(const int* __restrict__ dist, int* __restrict__ out, int H,
                    int W, int chunk) {
  extern __shared__ int smem[];
  const int HW = H * W;
  const int lane = threadIdx.x;
  int* score = smem;                                   // HW
  int* key = score + HW;                               // 32 * chunk
  int* ord = key + 32 * chunk;                         // HW
  unsigned char* used = reinterpret_cast<unsigned char*>(ord + HW);  // HW
  unsigned char* nbok = used + HW;                     // HW: up, down, left, right
  const int* d = dist + (size_t)blockIdx.x * HW;

  int m = EMPTY;
  for (int p = lane; p < HW; p += 32) {
    const int s = d[p] * KEY_SCALE - p;
    const int r = p / W, c = p - r * W;
    score[p] = s;
    used[p] = 0;
    nbok[p] = (r > 0) | (r < H - 1) << 1 | (c > 0) << 2 | (c < W - 1) << 3;
    m = max(m, s);
  }
  for (int i = lane; i < 32 * chunk; i += 32) key[i] = EMPTY;
  int cur = pixel_of(__reduce_max_sync(FULL, m));
  __syncwarp();
  if (lane == 0) {
    used[cur] = 1;
    ord[0] = cur;
  }
  __syncwarp();

  int best = EMPTY;  // the maximum key of this lane's pixels
  for (int t = 1; t < HW; ++t) {
    // push: the owner of each unvisited in-grid neighbour of cur
    const int ok = nbok[cur];
    const int nb[4] = {cur - W, cur + W, cur - 1, cur + 1};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = nb[j];
      if ((ok >> j & 1) && (q & 31) == lane && !used[q]) {
        used[q] = 1;
        const int s = score[q];
        key[lane * chunk + (q >> 5)] = s;
        best = max(best, s);
      }
    }
    __syncwarp();
    // pop: the frontier's maximum, then its owner's keys rescanned
    const int p = pixel_of(__reduce_max_sync(FULL, best));
    const int owner = p & 31;
    const int* keys = key + owner * chunk;
    int lm = EMPTY;
    for (int i = lane; i < chunk; i += 32)
      if (i != p >> 5) lm = max(lm, keys[i]);
    const int rest = __reduce_max_sync(FULL, lm);
    if (lane == owner) {
      best = rest;
      key[owner * chunk + (p >> 5)] = EMPTY;
    }
    if (lane == 0) ord[t] = p;
    cur = p;
    __syncwarp();
  }
  int* o = out + (size_t)blockIdx.x * HW;
  for (int i = lane; i < HW; i += 32) o[i] = ord[i];
}

size_t smem_bytes(int HW, int chunk) {
  return (size_t)4 * (2 * HW + 32 * chunk) + 2 * HW;
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
  const int chunk = (HW + 31) / 32;
  const size_t smem = smem_bytes(HW, chunk);
  static size_t allowed = 48 * 1024;
  cudaError_t e;
  if (smem > allowed) {
    e = cudaFuncSetAttribute(custom_order_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  custom_order_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      (const int*)dist, (int*)out, H, W, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
