// K5: per-row stable ascending sort of int32 keys, returning the sorted
// keys and each one's original index, for Hopper (sm_90a).
//
// Replaces the TPU kernel of pixelsynth_tpu/ops/sort_pallas.py
// (_sort_kernel, :158; the network is _sort_network, :89).
//
// Design.  The same bitonic network on lexicographic (key, original
// index) pairs: every pair is distinct, so the network's output is THE
// stable ascending order, bit-equal to a stable sort, with no floats and
// no tolerance.  The TPU kernel keeps a row's E <= 2^19 pairs (4 MB) in
// VMEM inside one program; a block's shared memory holds 2^13 pairs (64
// KB), and on the main path there is one row (B = 1), so one row's sort
// must spread over many blocks, which have no order among them:
//   * every compare-exchange pass whose partner distance j is below a
//     chunk (2^13) runs inside one block, in shared memory: the first
//     launch sorts every chunk completely (merge stages k = 2 .. 2^13),
//     and each later stage k ends with one launch that runs its passes
//     j = 2^12 .. 1 per chunk;
//   * each pass with j >= 2^13 is one launch over device memory (the
//     pairs stay in L2), one thread per pair of partners.
// A stage's direction is bit k of the element's index in its ROW (the
// flat index modulo E), so rows sort independently in the same launches
// and the last stage (k = E) is ascending everywhere.  E = 2^19 takes
// 1 + (1 + 2 + ... + 6) + 6 = 28 launches.
//
// Bound on this card: bytes.  Each key is read once and each (key,
// index) pair written once: 12 bytes an element, 6.3 MB at E = 2^19 (1.9
// us at 3.35 TB/s).  The network moves 8 bytes an element in each of its
// 28 launches, out of L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 1 << 13;   // pairs a block sorts in shared memory
constexpr int NT = 1024;
constexpr int GT = 256;

// (ka, va) is the pair at the lower index.  Ascending: it must be the
// smaller; descending: the larger.  Pairs are distinct, so "not greater"
// is "less".
__device__ __forceinline__ void cmpswap(int& ka, int& va, int& kb, int& vb,
                                        bool asc) {
  const bool gt = ka > kb || (ka == kb && va > vb);
  if (gt == asc) {
    const int tk = ka, tv = va;
    ka = kb; va = vb;
    kb = tk; vb = tv;
  }
}

// Index of the lower partner of pair t at distance j (a power of two):
// t with a 0 bit inserted at j's position.
__device__ __forceinline__ int lower_of(int t, int j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// One chunk per block, in shared memory: merge stages k_begin .. k_end,
// each from distance min(k, CHUNK) / 2 down to 1.  init: read keys from
// in_k and start the indices at the row-local position; else in place.
__global__ void __launch_bounds__(NT)
chunk_kernel(const int* in_k, int* out_k, int* out_v, int E, int k_begin,
             int k_end, int init) {
  extern __shared__ int sm[];
  int* sk = sm;
  int* sv = sm + CHUNK;
  const long long g0 = (long long)blockIdx.x * CHUNK;  // flat over B * E
  const int i0 = (int)(g0 & (long long)(E - 1));       // index in the row
  for (int t = threadIdx.x; t < CHUNK; t += NT) {
    sk[t] = in_k[g0 + t];
    sv[t] = init ? i0 + t : out_v[g0 + t];
  }
  __syncthreads();
  for (int k = k_begin; k <= k_end; k <<= 1) {
    for (int j = (k < CHUNK ? k : CHUNK) >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < CHUNK / 2; t += NT) {
        const int lo = lower_of(t, j);
        const int hi = lo | j;
        cmpswap(sk[lo], sv[lo], sk[hi], sv[hi], ((i0 + lo) & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < CHUNK; t += NT) {
    out_k[g0 + t] = sk[t];
    out_v[g0 + t] = sv[t];
  }
}

// One pass of stage k at distance j >= CHUNK over device memory; n_pairs
// = B * E / 2 threads.
__global__ void __launch_bounds__(GT)
pass_kernel(int* kk, int* vv, int E, int j, int k, long long n_pairs) {
  const long long t = blockIdx.x * (long long)GT + threadIdx.x;
  if (t >= n_pairs) return;
  const int half = E >> 1;
  const long long row = t / half;
  const int lo = lower_of((int)(t - row * half), j);
  const int hi = lo | j;
  int* rk = kk + row * E;
  int* rv = vv + row * E;
  int ka = rk[lo], va = rv[lo], kb = rk[hi], vb = rv[hi];
  const int k0 = ka, v0 = va;
  cmpswap(ka, va, kb, vb, (lo & k) == 0);
  if (ka != k0 || va != v0) {
    rk[lo] = ka; rv[lo] = va;
    rk[hi] = kb; rv[hi] = vb;
  }
}

}  // namespace

extern "C" {

// keys (B, E) int32 -> out_k (B, E) sorted keys, out_v (B, E) original
// indices.  E a power of two in [2^14, 2^19].
int sort_kv(const void* keys, void* out_k, void* out_v, int B, int E,
            void* stream) {
  if (E & (E - 1) || E < (1 << 14) || E > (1 << 19) || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = 2 * CHUNK * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int* ok = (int*)out_k;
  int* ov = (int*)out_v;
  const long long n = (long long)B * E;
  const int n_chunks = (int)(n / CHUNK);
  const long long n_pairs = n / 2;
  const int pass_blocks = (int)((n_pairs + GT - 1) / GT);
  chunk_kernel<<<n_chunks, NT, smem, st>>>((const int*)keys, ok, ov, E, 2,
                                           CHUNK, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (int k = 2 * CHUNK; k <= E; k <<= 1) {
    for (int j = k >> 1; j >= CHUNK; j >>= 1)
      pass_kernel<<<pass_blocks, GT, 0, st>>>(ok, ov, E, j, k, n_pairs);
    chunk_kernel<<<n_chunks, NT, smem, st>>>(ok, ok, ov, E, k, k, 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
