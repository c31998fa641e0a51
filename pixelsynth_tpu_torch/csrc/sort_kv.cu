// K5: per-row stable ascending sort of int32 keys, returning the sorted
// keys and each one's original index, for Hopper (sm_90a).
//
// Replaces the TPU kernel of pixelsynth_tpu/ops/sort_pallas.py
// (_sort_kernel, :158; the network is _sort_network, :89).
//
// Design.  The TPU kernel runs a bitonic network: no scatter, one core, a
// row's 4 MB in VMEM, O(E log^2 E) compare-exchanges.  This card scatters
// well and has 132 SMs, so the sort is a least-significant-digit radix
// sort: four passes over 8-bit digits of key ^ 0x80000000 (the flipped
// sign bit orders negative keys first), each pass a STABLE scatter of
// (key, index) pairs, so the result is the stable order by construction,
// bit for bit, with no tolerance.
//   * hist_kernel reads the keys once and builds all four 256-bin digit
//     histograms of every row (shared-memory atomics per block; a warp
//     whose 32 digits are equal, as in a run of equal keys, adds once; one
//     global add per occupied bin and block).
//   * pass_kernel, one launch a pass: a block takes a tile of 4096
//     consecutive elements of one row.  Warp w owns the tile's elements
//     [256w, 256w + 256) in warp-striped order (item i of lane l is
//     element 256w + 32i + l) and ranks them item by item: lanes with an
//     equal digit (__match_any_sync) take consecutive ranks in lane order
//     on top of the warp's running count of that digit, which is exactly
//     element order.  The warps' counts are scanned per digit in shared
//     memory.  What earlier tiles of the row hold of each digit comes from
//     a decoupled look-back: tiles are taken by an atomic ticket, so a tile
//     waits only on tiles that started before it; each publishes its own
//     digit counts before it looks back (flag AGGREGATE), then its
//     inclusive prefix (flag PREFIX).  An element goes to
//       digits below it in the row + the same digit in earlier tiles
//       + in earlier warps of the tile + its rank in the warp.
//     The tile's pairs are first put into shared memory in digit order, so
//     the stores to the row run along each digit's elements instead of
//     scattering 4 bytes a thread.
//   * the passes ping-pong between scratch and the outputs and end in the
//     outputs; rows sort independently in the same launches (ticket ->
//     (row, tile)).
// A sort is one memset and five kernel launches whatever E is (the
// network took 28 at E = 2^19).
//
// Bound on this card: bytes.  Each key is read once and each (key,
// index) pair written once: 12 bytes an element, 6.3 MB at E = 2^19 (1.9
// us at 3.35 TB/s).  The four passes move 16 bytes an element each, out
// of L2; the launches and the look-back's chain are what it takes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RADIX = 256;
constexpr int PASSES = 4;
constexpr int NT = 512;              // threads a block (16 warps)
constexpr int NW = NT / 32;
constexpr int ITEMS = 8;             // elements a thread
constexpr int TILE = NT * ITEMS;     // 4096 elements a block
constexpr unsigned FLAG_AGGREGATE = 1u << 30;
constexpr unsigned FLAG_PREFIX = 2u << 30;
constexpr unsigned VALUE_MASK = (1u << 30) - 1;

__device__ __forceinline__ unsigned digit_of(int key, int pass) {
  return ((static_cast<unsigned>(key) ^ 0x80000000u) >> (8 * pass)) & 0xffu;
}

// hist (B, PASSES, RADIX): the count of every digit of every pass in each
// row.  gridDim.x = B * blocks_per_row; a block takes TILE elements.
__global__ void __launch_bounds__(NT)
hist_kernel(const int* keys, unsigned* hist, int E) {
  __shared__ unsigned h[PASSES][RADIX];
  for (int i = threadIdx.x; i < PASSES * RADIX; i += NT) (&h[0][0])[i] = 0;
  __syncthreads();
  const int tiles = E / TILE;
  const int row = blockIdx.x / tiles;
  const int* src = keys + (size_t)row * E + (size_t)(blockIdx.x - row * tiles) * TILE;
  const unsigned lane = threadIdx.x & 31;
  int key[ITEMS];   // all loads first: the warp votes below order what follows them
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) key[i] = src[i * NT + threadIdx.x];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const unsigned d = digit_of(key[i], p);
      // a warp inside a run of equal keys (the sentinel tail) adds once
      if (__all_sync(0xffffffffu, d == __shfl_sync(0xffffffffu, d, 0))) {
        if (lane == 0) atomicAdd(&h[p][d], 32u);
      } else {
        atomicAdd(&h[p][d], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < PASSES * RADIX; i += NT) {
    const unsigned c = (&h[0][0])[i];
    if (c) atomicAdd(hist + (size_t)row * PASSES * RADIX + i, c);
  }
}

// Inclusive scan of `v` over the first RADIX threads of the block (whole
// warps; every one of them calls this), minus v: what lies below.
// `sums` is RADIX / 32 words of shared memory; the caller puts a
// __syncthreads() between this and `scan_finish`.
__device__ __forceinline__ unsigned scan_start(unsigned v, unsigned* sums) {
  const unsigned lane = threadIdx.x & 31;
  unsigned inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned up = __shfl_up_sync(0xffffffffu, inc, o);
    if ((int)lane >= o) inc += up;
  }
  if (lane == 31) sums[threadIdx.x >> 5] = inc;
  return inc - v;
}
__device__ __forceinline__ unsigned scan_finish(unsigned below,
                                                const unsigned* sums) {
  for (unsigned w = 0; w < (threadIdx.x >> 5); ++w) below += sums[w];
  return below;
}

// One stable scatter pass on digit `pass`.  in_v == null: the values start
// as the index in the row.  state (B * tiles, RADIX) and ticket start at 0.
__global__ void __launch_bounds__(NT)
pass_kernel(const int* in_k, const int* in_v, int* out_k, int* out_v,
            const unsigned* hist, unsigned* state, unsigned* ticket, int E,
            int pass) {
  // the warps' digit counts (then their exclusive scan per digit); later
  // the tile's keys in digit order
  __shared__ unsigned warp_count[NW][RADIX];
  __shared__ int sorted_v[TILE];          // the tile's values in digit order
  __shared__ unsigned tile_below[RADIX];  // digits below d inside the tile
  __shared__ unsigned row_start[RADIX];   // where the tile's run of d starts in the row
  __shared__ unsigned sums_a[RADIX / 32], sums_b[RADIX / 32];
  __shared__ unsigned my_ticket;
  static_assert(NW * RADIX == TILE, "the counts' space holds the tile's keys");
  int* sorted_k = reinterpret_cast<int*>(&warp_count[0][0]);
  if (threadIdx.x == 0) my_ticket = atomicAdd(ticket, 1u);
  for (int i = threadIdx.x; i < NW * RADIX; i += NT) (&warp_count[0][0])[i] = 0;
  __syncthreads();
  const int tiles = E / TILE;
  const int row = my_ticket / tiles;
  const int tile = my_ticket - row * tiles;
  const unsigned warp = threadIdx.x >> 5;
  const unsigned lane = threadIdx.x & 31;
  const int first = tile * TILE + warp * (32 * ITEMS) + lane;  // index in the row
  const size_t row0 = (size_t)row * E;

  int key[ITEMS], val[ITEMS];
  unsigned rank[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    key[i] = in_k[row0 + first + 32 * i];
    val[i] = in_v == nullptr ? first + 32 * i : in_v[row0 + first + 32 * i];
  }
  // rank inside the warp, in element order: items in turn, lanes in order
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned d = digit_of(key[i], pass);
    const unsigned same = __match_any_sync(0xffffffffu, d);
    const int leader = __ffs(same) - 1;
    unsigned before = 0;
    if ((int)lane == leader) {
      before = warp_count[warp][d];
      warp_count[warp][d] = before + __popc(same);
    }
    before = __shfl_sync(0xffffffffu, before, leader);
    rank[i] = before + __popc(same & ((1u << lane) - 1u));
    __syncwarp();
  }
  __syncthreads();

  // thread d < RADIX owns digit d: scan the warps' counts, publish the
  // tile's count, then two scans across the digits: of the tile's counts
  // (the digit's place inside the tile) and of the row's histogram (the
  // digits below d in the row)
  unsigned count = 0, below_tile = 0, below_row = 0;
  if (threadIdx.x < RADIX) {
    const int d = threadIdx.x;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const unsigned c = warp_count[w][d];
      warp_count[w][d] = count;
      count += c;
    }
    volatile unsigned* st = state + ((size_t)row * tiles) * RADIX + d;
    st[(size_t)tile * RADIX] =
        (tile == 0 ? FLAG_PREFIX : FLAG_AGGREGATE) | count;
    below_tile = scan_start(count, sums_a);
    below_row = scan_start(hist[((size_t)row * PASSES + pass) * RADIX + d], sums_b);
  }
  __syncthreads();
  if (threadIdx.x < RADIX) {
    const int d = threadIdx.x;
    below_tile = scan_finish(below_tile, sums_a);
    below_row = scan_finish(below_row, sums_b);
    // look back over the row's earlier tiles
    volatile unsigned* st = state + ((size_t)row * tiles) * RADIX + d;
    unsigned earlier = 0;
    for (int t = tile - 1; t >= 0; --t) {
      unsigned s;
#ifdef LMK_SPIN_LIMIT   // debugging: a tile that never publishes traps
      long long spins = 0;
#endif
      do {
#ifdef LMK_SPIN_LIMIT
        if (++spins > (long long)LMK_SPIN_LIMIT) __trap();
#endif
        s = st[(size_t)t * RADIX];
      } while ((s >> 30) == 0);
      earlier += s & VALUE_MASK;
      if (s & FLAG_PREFIX) break;
    }
    if (tile > 0) st[(size_t)tile * RADIX] = FLAG_PREFIX | (earlier + count);
    tile_below[d] = below_tile;
    // element at place j of the tile's digit order goes to row_start[d] + j
    row_start[d] = below_row + earlier - below_tile;
  }
  __syncthreads();
  // each pair's place in the tile's digit order, then the pairs into shared
  // memory in that order (the counts' space is free once every place is
  // known), so that the stores to the row run along each digit's elements
  unsigned place[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned d = digit_of(key[i], pass);
    place[i] = tile_below[d] + warp_count[warp][d] + rank[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    sorted_k[place[i]] = key[i];
    sorted_v[place[i]] = val[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned j = threadIdx.x + i * NT;
    const int k = sorted_k[j];
    const size_t pos = row0 + (row_start[digit_of(k, pass)] + j);
    out_k[pos] = k;
    out_v[pos] = sorted_v[j];
  }
}

}  // namespace

extern "C" {

// Bytes of `work` the sort of a (B, E) array needs.
long long sort_kv_work_bytes(int B, int E) {
  const long long tiles = (long long)B * (E / TILE);
  return 4 * ((long long)B * PASSES * RADIX + PASSES * tiles * RADIX + PASSES);
}

// How many launches (kernels and the memset) one sort takes.
int sort_kv_launches(void) { return 2 + PASSES; }

// keys (B, E) int32 -> out_k (B, E) sorted keys, out_v (B, E) original
// indices.  E a power of two in [2^14, 2^19].  scratch: two (B, E) int32
// arrays (the passes' other buffer) followed by sort_kv_work_bytes(B, E)
// bytes.
int sort_kv(const void* keys, void* out_k, void* out_v, void* scratch, int B,
            int E, void* stream) {
  if (E & (E - 1) || E < (1 << 14) || E > (1 << 19) || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = B * (E / TILE);
  int* tmp_k = (int*)scratch;
  int* tmp_v = tmp_k + (size_t)B * E;
  void* work = tmp_v + (size_t)B * E;
  unsigned* hist = (unsigned*)work;
  unsigned* state = hist + (size_t)B * PASSES * RADIX;
  unsigned* ticket = state + (size_t)PASSES * blocks * RADIX;
  cudaError_t e = cudaMemsetAsync(work, 0, (size_t)sort_kv_work_bytes(B, E), st);
  if (e != cudaSuccess) return (int)e;
  hist_kernel<<<blocks, NT, 0, st>>>((const int*)keys, hist, E);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int* src_k = (const int*)keys;
  const int* src_v = nullptr;
  for (int p = 0; p < PASSES; ++p) {
    // passes 0 and 2 write the scratch, 1 and 3 the outputs
    int* dst_k = p & 1 ? (int*)out_k : tmp_k;
    int* dst_v = p & 1 ? (int*)out_v : tmp_v;
    pass_kernel<<<blocks, NT, 0, st>>>(src_k, src_v, dst_k, dst_v, hist,
                                       state + (size_t)p * blocks * RADIX,
                                       ticket + p, E, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    src_k = dst_k;
    src_v = dst_v;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
