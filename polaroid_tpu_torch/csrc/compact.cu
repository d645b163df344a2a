// Stable compaction of 4- and 8-byte words: the rows where mask is true
// move to a prefix of each output, in their original order, and the live
// count is written to a device scalar. One launch does it all.
//
// Replaces: the TPU kernels `_partition_concat_kernel` (behind
// `compact_words`) and `_concat_kernel` (behind `_prefix_concat`, the
// PT_PARTITION_SHIFT=0 variant) in polaroid_tpu/ops/pallas_partition.py.
// Both implement one contract; on the TPU they compact 8192-row VMEM
// blocks with shift passes and stitch them with lane rotations and DMAs,
// which is why they need n % 8192 == 0. This kernel takes any n >= 1.
//
// Bound on the H100: device-memory bytes, and what the mask asks for: the
// mask is read whole and each live row's word is read once and written
// once. For k live rows and words of b_w bytes:
//   n + sum_w 2 * k * b_w   bytes over 3.35 TB/s.
//
// Design, for the hash tier's nearly empty masks as for q1's 80% live.
// The mask is cut into as many tiles as blocks fit the card at once, each
// a whole number of chunks of PT_CHUNK rows, so that the tiles' offsets
// take one round of look-back. Each round costs a few L2 round trips, and
// with a tile per chunk the rounds of look-back over thousands of nearly
// empty tiles took most of the kernel's time (PERF.md).
// - A block takes its tile by an atomic ticket, so that a tile only ever
//   waits on tiles that already run, and counts the tile's live rows:
//   each thread loads 32 mask bytes of a chunk as two 16-byte loads.
// - It publishes the count in a self-contained 64-bit status word (ready
//   flag | inclusive flag | count), then looks back for its exclusive
//   offset (decoupled look-back, as in radix_sort.cu; all PT_THREADS
//   threads read an earlier tile's word each) and publishes the inclusive
//   prefix.
// - The block then takes a second ticket, of finished look-backs; the last
//   block to take it returns the status words and both tickets to zero, so
//   the scratch persists between calls with no memset, and a replay of a
//   captured launch finds it as the first launch did.
// - A tile with no live row returns there, touching no word.
// - Otherwise the block walks its chunks again (the mask it just read is
//   in L2, and the next chunk's bytes load while one is ranked): a warp
//   scan and a scan of the warp totals rank each chunk's live rows in row
//   order, and their tile positions are listed in shared memory in rank
//   order. The walk stops at the tile's last live row. When the list is
//   full, and at the end, the block copies word by word: thread j takes
//   the j-th, (j+256)-th, ... listed row, so consecutive threads read
//   nearly consecutive rows and write consecutive slots, and a sparse tile
//   copies all its rows at once. A word may be strided (its output keeps
//   the stride) and is 4 or 8 bytes wide.
// - The last tile writes the live count.
// A call with more than PT_MAX_WORDS words launches again per group of
// words with `lookback` 0: each tile then reads its inclusive prefix, left
// by the first launch, instead of looking back; only the call's last
// launch (`reset`) zeroes the status words.

#include <cuda_runtime.h>
#include <stdint.h>

#define PT_THREADS 256
#define PT_WARPS (PT_THREADS / 32)
#define PT_CHUNK (PT_THREADS * 32)  // rows of a chunk: 32 a thread
#define PT_MAX_WORDS 32

struct WordPtrs {
  const void* in[PT_MAX_WORDS];
  void* out[PT_MAX_WORDS];
  long long stride[PT_MAX_WORDS];  // in elements, shared by the input and its output
  unsigned wide;                   // bit w set: word w is 8 bytes, else 4
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
// status word: 0 until tile j publishes; then bit 32 set, bit 33 set when
// the count is the inclusive prefix over tiles 0..j and clear when it is
// tile j's own, the count in bits 0-31 (n < 2^31)
constexpr unsigned long long READY = 1ull << 32;
constexpr unsigned long long INCLUSIVE = 1ull << 33;
constexpr unsigned long long COUNT_MASK = READY - 1;

__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// bit i set where byte i of the 4-byte group x is non-zero
__device__ __forceinline__ unsigned byte_bits(unsigned x) {
  return (x & 0xffu ? 1u : 0u) | (x & 0xff00u ? 2u : 0u) | (x & 0xff0000u ? 4u : 0u) |
         (x & 0xff000000u ? 8u : 0u);
}

// Start loading the 32 mask bytes of rows r .. r+31 as two 16-byte loads, if
// they lie below n 16-byte aligned; returns whether it did.
__device__ __forceinline__ bool load_mask(const unsigned char* __restrict__ mask, long long n,
                                          long long r, uint4& a, uint4& b) {
  if (r + 32 > n || ((uintptr_t)(mask + r) & 15)) return false;
  a = reinterpret_cast<const uint4*>(mask + r)[0];
  b = reinterpret_cast<const uint4*>(mask + r)[1];
  return true;
}

// bit i set where row r + i (< n) is live: from the bytes load_mask
// loaded (fast), else read one by one
__device__ __forceinline__ unsigned mask_bits(const unsigned char* __restrict__ mask, long long n,
                                              long long r, bool fast, const uint4& a,
                                              const uint4& b) {
  if (fast)
    return byte_bits(a.x) | byte_bits(a.y) << 4 | byte_bits(a.z) << 8 | byte_bits(a.w) << 12 |
           byte_bits(b.x) << 16 | byte_bits(b.y) << 20 | byte_bits(b.z) << 24 |
           byte_bits(b.w) << 28;
  unsigned bits = 0;
  for (int i = 0; i < 32 && r + i < n; ++i)
    if (mask[r + i]) bits |= 1u << i;
  return bits;
}

// out[(base + k) * stride] = in[(first + rows[k]) * stride] for k < live,
// four rows in flight a thread
template <typename T>
__device__ __forceinline__ void copy_word(const T* __restrict__ in, T* __restrict__ out,
                                          long long stride, const unsigned* rows,
                                          long long first, long long base, int live) {
  for (int k = threadIdx.x; k < live; k += 4 * PT_THREADS) {
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = k + u * PT_THREADS;
      if (kk < live) v[u] = in[(first + rows[kk]) * stride];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = k + u * PT_THREADS;
      if (kk < live) out[(base + kk) * stride] = v[u];
    }
  }
}

// every word's rows first + rows[k] to slots base + k, for k < live
__device__ __forceinline__ void copy_rows(const WordPtrs& p, int W, const unsigned* rows,
                                          long long first, long long base, int live) {
  for (int w = 0; w < W; ++w) {
    if ((p.wide >> w) & 1)
      copy_word((const unsigned long long*)p.in[w], (unsigned long long*)p.out[w], p.stride[w],
                rows, first, base, live);
    else
      copy_word((const unsigned*)p.in[w], (unsigned*)p.out[w], p.stride[w], rows, first, base,
                live);
  }
}

// The live rows of tiles 0 .. tile-1, from the status words st: PT_THREADS
// earlier tiles a step, back to the nearest inclusive prefix (tile 0
// publishes one at once, so the walk ends). Every thread gets the sum.
__device__ unsigned long long look_back(const unsigned long long* st, int tile, unsigned* s_incl,
                                        unsigned* s_wait, unsigned long long* s_part) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long prefix = 0;
  for (int top = tile - 1;;) {
    const int j = top - t;
    const unsigned long long s = j >= 0 ? ld_status(st + j) : (READY | INCLUSIVE);
    const bool ready = s != 0;
    const unsigned incl_lanes = __ballot_sync(FULL, ready && (s & INCLUSIVE));
    const unsigned waiting = __ballot_sync(FULL, !ready);
    if (lane == 0) s_incl[warp] = incl_lanes, s_wait[warp] = waiting;
    __syncthreads();
    // stop: the thread of the nearest inclusive tile (the last thread if
    // none); retry if a tile up to it has not published yet
    int stop = PT_THREADS - 1;
    bool found = false, retry = false;
#pragma unroll
    for (int w = 0; w < PT_WARPS; ++w) {
      if (found) break;
      const unsigned m = s_incl[w], wt = s_wait[w];
      if (m) {
        const int l = __ffs(m) - 1;
        retry |= (wt & ((2u << l) - 1u)) != 0;  // lanes 0..l (2u << 31 is 0)
        stop = 32 * w + l;
        found = true;
      } else {
        retry |= wt != 0;
      }
    }
    unsigned long long c = t <= stop ? (s & COUNT_MASK) : 0;
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) c += __shfl_xor_sync(FULL, c, d);
    if (lane == 0) s_part[warp] = c;
    __syncthreads();
    if (retry) continue;
#pragma unroll
    for (int w = 0; w < PT_WARPS; ++w) prefix += s_part[w];
    if (found) return prefix;
    top -= PT_THREADS;
  }
}

// status[0] is the tile ticket, status[1] the ticket of finished
// look-backs, status[2 + j] tile j's status word; a tile is tile_rows rows
// (a multiple of PT_CHUNK)
__global__ void __launch_bounds__(PT_THREADS)
compact_kernel(const unsigned char* __restrict__ mask, long long n, long long tile_rows, int W,
               const __grid_constant__ WordPtrs p, unsigned long long* __restrict__ status,
               long long* __restrict__ count, int lookback, int reset) {
  __shared__ unsigned s_rows[PT_CHUNK];
  __shared__ int s_wsum[PT_WARPS];
  __shared__ unsigned s_incl[PT_WARPS], s_wait[PT_WARPS];
  __shared__ unsigned long long s_part[PT_WARPS];
  __shared__ int s_tile;
  __shared__ bool s_last;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (lookback) {
    if (t == 0) s_tile = (int)atomicAdd(status, 1ull);
    __syncthreads();
  }
  const int tile = lookback ? s_tile : (int)blockIdx.x;
  const long long first = (long long)tile * tile_rows;
  const long long last = min(n, first + tile_rows);

  // the tile's live rows
  int mine = 0;
#pragma unroll 4
  for (long long r = first + 32 * t; r < last; r += PT_CHUNK) {
    uint4 a, b;
    const bool fast = load_mask(mask, last, r, a, b);
    mine += __popc(mask_bits(mask, last, r, fast, a, b));
  }
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) mine += __shfl_xor_sync(FULL, mine, d);
  if (lane == 0) s_wsum[warp] = mine;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < PT_WARPS; ++w) total += s_wsum[w];

  unsigned long long* st = status + 2;
  unsigned long long prefix = 0;  // live rows in tiles 0 .. tile-1
  if (!lookback) {
    prefix = (ld_status(st + tile) & COUNT_MASK) - (unsigned long long)total;
  } else if (tile == 0) {
    if (t == 0) st_status(st, READY | INCLUSIVE | (unsigned long long)total);
  } else {
    // publish the count first, so that no tile waits on a later one
    if (t == 0) st_status(st + tile, READY | (unsigned long long)total);
    prefix = look_back(st, tile, s_incl, s_wait, s_part);
    if (t == 0) st_status(st + tile, READY | INCLUSIVE | (prefix + total));
  }
  if (lookback && t == 0 && tile == (int)gridDim.x - 1) *count = (long long)prefix + total;

  // this block reads no status word from here on: the last block to get
  // here returns the scratch to zero for the next call
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(status + 1, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    if (reset)
      for (int j = t; j < (int)gridDim.x; j += PT_THREADS) st[j] = 0;
    if (t == 0) status[0] = status[1] = 0;
  }
  if (total == 0) return;

  // each chunk's live rows, ranked in row order, listed in s_rows as tile
  // positions; the list is copied out when the next chunk's would overflow
  // it, and at the end, so a nearly empty tile copies once
  long long base = (long long)prefix;  // the slot of s_rows[0]
  const long long end = base + total;
  int run = 0;                         // rows listed
  uint4 a, b;
  bool fast = load_mask(mask, last, first + 32 * t, a, b);
  for (long long c0 = first; c0 < last && base + run < end; c0 += PT_CHUNK) {
    unsigned bits = mask_bits(mask, last, c0 + 32 * t, fast, a, b);
    // the next chunk's bytes are in flight while this one is ranked
    fast = load_mask(mask, last, c0 + PT_CHUNK + 32 * t, a, b);
    const int m = __popc(bits);
    int incl = m;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) s_wsum[warp] = incl;
    __syncthreads();
    int before = run + incl - m, live = 0;
#pragma unroll
    for (int w = 0; w < PT_WARPS; ++w) {
      const int c = s_wsum[w];
      if (w < warp) before += c;
      live += c;
    }
    if (run + live > PT_CHUNK) {
      copy_rows(p, W, s_rows, first, base, run);
      base += run;
      before -= run;
      run = 0;
      __syncthreads();
    }
    const unsigned pos = (unsigned)(c0 - first) + 32 * t;
    for (; bits; bits &= bits - 1) s_rows[before++] = pos + __ffs(bits) - 1;
    run += live;
    __syncthreads();  // s_wsum is written again; s_rows is read
  }
  copy_rows(p, W, s_rows, first, base, run);
}

// rows of a tile: n over the grid, rounded up to whole chunks
long long tile_rows_of(long long n, int max_blocks) {
  const long long per = (n + max_blocks - 1) / max_blocks;
  return (per + PT_CHUNK - 1) / PT_CHUNK * PT_CHUNK;
}

}  // namespace

extern "C" {

// mask: (n,) bool, 1 <= n < 2^31; words: 3W int64 for W <= PT_MAX_WORDS
// words, the input device pointers, the output device pointers and the
// element strides (shared by an input and its output); wide: a bitmask of
// the 8-byte words; status: a device int64 buffer of 2 + max_blocks words,
// zeroed once and left zero by every call that ends with reset 1 (one
// call at a time uses it); count: a device int64 scalar; max_blocks:
// pt_compact_blocks' answer. lookback 1 computes the offsets and writes
// count; lookback 0 (further words of the same call, same max_blocks)
// reads the offsets the first launch left in status. reset 1 marks the
// call's last launch.
int pt_compact_words(const void* mask, long long n, int W, const long long* words, unsigned wide,
                     void* status, void* count, int lookback, int reset, int max_blocks,
                     void* stream) {
  if (W < 1 || W > PT_MAX_WORDS || n < 1 || n >= (1LL << 31) || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  WordPtrs p;
  for (int w = 0; w < W; ++w) {
    p.in[w] = (const void*)words[w];
    p.out[w] = (void*)words[W + w];
    p.stride[w] = words[2 * W + w];
  }
  p.wide = wide;
  const long long tile_rows = tile_rows_of(n, max_blocks);
  const long long tiles = (n + tile_rows - 1) / tile_rows;
  compact_kernel<<<(unsigned)tiles, PT_THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)mask, n, tile_rows, W, p, (unsigned long long*)status,
      (long long*)count, lookback, reset);
  return (int)cudaGetLastError();
}

// The most blocks of the kernel that fit the card at once: the most tiles
// of a launch. Returns the CUDA error, or 0.
int pt_compact_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_kernel, PT_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return 0;
}

// The most words of a launch.
int pt_compact_max_words() { return PT_MAX_WORDS; }

const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}
