// Least-significant-digit radix sort of tuples of 32-bit words: kernel F of
// the port. The rows are sorted lexicographically on their first nk words,
// compared as unsigned; the other words ride along. Each pass is stable, so
// sorting by the last key word's digits first and the first key word's last
// gives the stable order with no injected index word: the row index starts
// as 0..n-1 and is the only payload that moves through the passes.
//
// Replaces: the TPU kernel `_chunk_kernel` behind `merge_sort_words`
// (polaroid_tpu/ops/merge_sort.py, `_chunk_pass`), a bitonic network of
// `lax.sort`ed base blocks and 128-lane rolls. A comparison network reads
// and writes every word O(log^2 n) times; this design reads each key word a
// few times and moves only the index between passes:
//   (a) histogram_kernel reads every key word once and counts, for each
//       (key word, 8-bit digit), the rows per digit value into a
//       [nk][4][256] table: one shared-memory atomic for a warp whose 32
//       rows share the digit, one per row otherwise (on the H100 this beat
//       aggregating each warp's equal digits with __match_any_sync; see
//       PERF.md). The host reads the table back once and
//       launches passes only for digits whose rows do not all share one
//       value (a pass over such a digit is the identity);
//   (b) digit_pass_kernel, one launch per digit pass, the "onesweep" scheme
//       (Adinets & Merrill, 2022): a block takes a tile of PT_TILE rows by an
//       atomic ticket, ranks them stably by digit in shared memory, publishes
//       its per-digit counts, looks back over earlier tiles' published counts
//       (decoupled look-back) for its global offset per digit, and writes
//       each digit's run of (key, index) out contiguously. The first pass of
//       a key word gathers the word through the current index; later passes
//       of the same word carry (key, index) pairs. A word with one pass
//       (its only non-trivial digit) gathers that digit from a byte copy
//       that digit_kernel writes first: 1 byte a row, 16 MB at 2^24 rows,
//       which the 50 MB L2 cache holds, where the word is 8 bytes a row;
//   (c) place_kernel writes the output words, each row reading its words
//       through the final index, and the index itself as int64.
// Words are read in place from the caller's int64 tensors (their low 32
// bits), through a table of pointers passed as a kernel parameter.
//
// Bound on the H100: device-memory bytes. The least work reads and writes
// W * n words once: at n = 2^24 and W = 5, 671 MB over 3.35 TB/s, 0.200 ms.
// This design moves one read of the nk key words (8 bytes a row each, the
// int64 storage), about 16 bytes a row for each digit pass (key and index
// in and out; a gather of the key word, or of its digit's byte copy after
// a read of the word and a write of the copy, instead of the key on a
// word's first pass), and the placement's reads through the index and
// writes of W int64 words and the index.

#include <cuda_runtime.h>
#include <stdint.h>

#define PT_MAX_WORDS 32
#define PT_RADIX 256
#define PT_THREADS 256  // threads of a pass block: one per digit value in the look-back
#define PT_IPT 15       // rows per thread of a pass tile
#define PT_TILE (PT_THREADS * PT_IPT)
#define PT_WARPS (PT_THREADS / 32)
#define PT_HIST_THREADS 256
#define PT_HIST_ROWS 4  // rows a histogram thread loads per round
#define PT_HIST_BLOCKS 1024
#define PT_PLACE_THREADS 256

namespace {

struct Words {
  long long* p[PT_MAX_WORDS];
};

// a pass's first output slot of each digit value, passed by value
struct Bases {
  int v[PT_RADIX];
};

constexpr unsigned FULL = 0xffffffffu;
// A look-back status word: the pass's epoch (pass number + 1) in bits 32-63,
// so one zeroed buffer serves every pass of a sort and a word left by an
// earlier pass reads as unpublished; bit 31 set when the count is the
// inclusive prefix over tiles 0..j, clear when it is tile j's own count;
// the count in bits 0-30 (n <= 2^30).
constexpr unsigned long long INCLUSIVE = 1ull << 31;
constexpr unsigned long long COUNT_MASK = INCLUSIVE - 1;

// A status word carries its flag and its count in one 64-bit access, and
// no other data is read on the strength of it, so the look-back needs only
// coherent (gpu-scope) single-copy-atomic loads and stores, not acquire
// and release ordering.
__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// hist[w][d][v] += rows of key word w whose digit d (bits 8d .. 8d+7) is v.
// Grid: (blocks, nk); blockIdx.y is the word.
__global__ void __launch_bounds__(PT_HIST_THREADS)
histogram_kernel(Words words, int n, unsigned* __restrict__ hist) {
  __shared__ unsigned s_hist[4 * PT_RADIX];
  const int w = blockIdx.y;
  const long long* __restrict__ word = words.p[w];
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 4 * PT_RADIX; i += PT_HIST_THREADS) s_hist[i] = 0;
  __syncthreads();
  const long long step = (long long)PT_HIST_THREADS * PT_HIST_ROWS;
  // base is the same for the whole block, so every lane reaches the warp
  // collectives below
  for (long long base = blockIdx.x * step; base < n; base += gridDim.x * step) {
    uint32_t key[PT_HIST_ROWS];
#pragma unroll
    for (int r = 0; r < PT_HIST_ROWS; ++r) {
      const long long row = base + r * PT_HIST_THREADS + threadIdx.x;
      key[r] = row < n ? (uint32_t)word[row] : 0u;
    }
#pragma unroll
    for (int r = 0; r < PT_HIST_ROWS; ++r) {
      const long long row = base + r * PT_HIST_THREADS + threadIdx.x;
      const bool ok = row < n;
      const bool warp_ok = (row | 31) < n;
      // the bits in which the warp's keys differ: a digit with none is one
      // value for all 32 rows, one atomic
      const unsigned diff = __reduce_or_sync(FULL, key[r] ^ __shfl_sync(FULL, key[r], 0));
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        // PT_RADIX marks a row past n: it is counted nowhere
        const unsigned v = ok ? (key[r] >> (8 * d)) & 0xff : PT_RADIX;
        if (warp_ok && !((diff >> (8 * d)) & 0xff)) {
          if (lane == 0) atomicAdd(&s_hist[d * PT_RADIX + v], 32u);
        } else if (v < PT_RADIX) {
          atomicAdd(&s_hist[d * PT_RADIX + v], 1u);
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * PT_RADIX; i += PT_HIST_THREADS) {
    const unsigned c = s_hist[i];
    if (c) atomicAdd(&hist[(size_t)w * 4 * PT_RADIX + i], c);
  }
}

// digits[r] = bits shift .. shift + 7 of word[r].
__global__ void __launch_bounds__(PT_PLACE_THREADS)
digit_kernel(const long long* __restrict__ word, int shift, uint8_t* __restrict__ digits, int n) {
  const int i = blockIdx.x * PT_PLACE_THREADS + threadIdx.x;
  if (i < n) digits[i] = (uint8_t)(word[i] >> shift);
}

// One stable pass over the digit at bit `shift` of the current key. The key
// of row r is keys_in[r] or, with keys_in null, digits_in[idx_in[r]] or,
// with that null too, word[idx_in[r]] (word[r] with idx_in null: the
// identity index); its index is idx_in[r] (r with idx_in null). Writes
// idx_out and, unless keys_out is null, keys_out, at each row's slot in the
// digit order: bases[v] + the rows of digit v in earlier tiles + the rows of
// digit v before it in its tile.
__global__ void __launch_bounds__(PT_THREADS)
digit_pass_kernel(const long long* __restrict__ word, const uint32_t* __restrict__ keys_in,
                  const uint8_t* __restrict__ digits_in, const int* __restrict__ idx_in,
                  uint32_t* __restrict__ keys_out, int* __restrict__ idx_out, const Bases bases,
                  unsigned long long* __restrict__ status, unsigned long long* __restrict__ ticket,
                  int n, int shift, unsigned epoch) {
  __shared__ unsigned s_count[PT_WARPS][PT_RADIX];  // per-warp counts, then offsets
  __shared__ int s_local[PT_RADIX];                 // start of digit v's run in the tile
  __shared__ int s_global[PT_RADIX];                // slot of tile position 0 of digit v
  __shared__ unsigned s_wsum[PT_WARPS];
  __shared__ uint32_t s_keys[PT_TILE];
  __shared__ int s_idx[PT_TILE];
  __shared__ int s_tile;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // tiles in ticket order: a tile waits only on tiles that already run
  if (t == 0) s_tile = (int)atomicAdd(ticket, 1ull);
  for (int i = t; i < PT_WARPS * PT_RADIX; i += PT_THREADS) (&s_count[0][0])[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int first = tile * PT_TILE;
  // item i of lane l of warp w is row first + w*32*IPT + i*32 + l, so the
  // items a warp visits in i order, lanes in order, are its rows in order
  const int wfirst = first + warp * 32 * PT_IPT;

  uint32_t key[PT_IPT];
  int idx[PT_IPT];
#pragma unroll
  for (int i = 0; i < PT_IPT; ++i) {
    const int row = wfirst + i * 32 + lane;
    idx[i] = row < n ? (idx_in ? idx_in[row] : row) : 0;
  }
#pragma unroll
  for (int i = 0; i < PT_IPT; ++i) {
    const int row = wfirst + i * 32 + lane;
    key[i] = row >= n    ? 0u
             : keys_in   ? keys_in[row]
             : digits_in ? (uint32_t)digits_in[idx[i]]
                         : (uint32_t)word[idx[i]];
  }

  // rank each row among the warp's earlier rows of its digit
  int rank[PT_IPT];
  unsigned* cnt = s_count[warp];
#pragma unroll
  for (int i = 0; i < PT_IPT; ++i) {
    const bool ok = wfirst + i * 32 + lane < n;
    const unsigned v = ok ? (key[i] >> shift) & 0xff : PT_RADIX;
    const unsigned peers = __match_any_sync(FULL, v);
    const unsigned before = ok ? cnt[v] : 0u;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) cnt[v] = before + __popc(peers);
    __syncwarp();
    rank[i] = (int)(before + __popc(peers & lanemask_lt()));
  }
  __syncthreads();

  // thread t owns digit value t: each warp's offset within the tile's run
  // of t, and the tile's count of t
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < PT_WARPS; ++w) {
    const unsigned c = s_count[w][t];
    s_count[w][t] = count;
    count += c;
  }
  // publish the count before looking back, so that no tile waits on a
  // later one's look-back
  unsigned long long* mine = status + (size_t)tile * PT_RADIX + t;
  const unsigned long long tag = (unsigned long long)epoch << 32;
  st_status(mine, tag | (tile == 0 ? INCLUSIVE : 0ull) | count);

  // the start of t's run in the tile: an exclusive scan over digit values
  unsigned inc = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_wsum[warp] = inc;
  __syncthreads();
  unsigned local = inc - count;
  for (int w = 0; w < warp; ++w) local += s_wsum[w];
  s_local[t] = (int)local;

  // the rows of t in earlier tiles: their counts, back to the first
  // inclusive prefix (tile 0 publishes one at once, so the walk ends)
  unsigned long long before = 0;
  if (tile > 0) {
    for (int j = tile - 1;;) {
      const unsigned long long s = ld_status(status + (size_t)j * PT_RADIX + t);
      if ((s >> 32) != epoch) continue;  // not published yet
      before += s & COUNT_MASK;
      if (s & INCLUSIVE) break;
      --j;
    }
    st_status(mine, tag | INCLUSIVE | (before + count));
  }
  s_global[t] = bases.v[t] + (int)before - (int)local;
  __syncthreads();

  // the tile in digit order in shared memory, then each run out
#pragma unroll
  for (int i = 0; i < PT_IPT; ++i) {
    if (wfirst + i * 32 + lane < n) {
      const unsigned v = (key[i] >> shift) & 0xff;
      const int pos = s_local[v] + (int)s_count[warp][v] + rank[i];
      s_keys[pos] = key[i];
      s_idx[pos] = idx[i];
    }
  }
  __syncthreads();
  const int rows = min(PT_TILE, n - first);
  for (int p = t; p < rows; p += PT_THREADS) {
    const uint32_t k = s_keys[p];
    const int slot = s_global[(k >> shift) & 0xff] + p;
    idx_out[slot] = s_idx[p];
    if (keys_out) keys_out[slot] = k;
  }
}

// out[w][i] = the low 32 bits of in[w][perm[i]] for w < W, perm_out[i] =
// perm[i] unless perm_out is null; a null perm is the identity.
__global__ void __launch_bounds__(PT_PLACE_THREADS)
place_kernel(Words in, Words out, int W, const int* __restrict__ perm,
             long long* __restrict__ perm_out, int n) {
  const int i = blockIdx.x * PT_PLACE_THREADS + threadIdx.x;
  if (i >= n) return;
  const int src = perm ? perm[i] : i;
  if (perm_out) perm_out[i] = src;
  for (int w = 0; w < W; ++w) out.p[w][i] = in.p[w][src] & 0xFFFFFFFFLL;
}

bool valid_n(long long n) { return n >= 1 && !(n & (n - 1)) && n < (1LL << 31); }

}  // namespace

extern "C" {

// hist: a zeroed [nk][4][256] int32 table on the device; words: nk device
// pointers to int64 words of n rows (n a power of two below 2^31). Adds
// each (word, digit)'s counts per digit value on `stream`; returns the
// launch's CUDA error, or 0.
int pt_radix_histogram(void* const* words, long long n, int nk, void* hist, void* stream) {
  if (!valid_n(n) || nk < 1 || nk > PT_MAX_WORDS) return (int)cudaErrorInvalidValue;
  Words w = {};
  for (int i = 0; i < nk; ++i) w.p[i] = (long long*)words[i];
  const long long rounds = (n + PT_HIST_THREADS * PT_HIST_ROWS - 1) / (PT_HIST_THREADS * PT_HIST_ROWS);
  const dim3 grid((unsigned)(rounds < PT_HIST_BLOCKS ? rounds : PT_HIST_BLOCKS), (unsigned)nk);
  histogram_kernel<<<grid, PT_HIST_THREADS, 0, (cudaStream_t)stream>>>(w, (int)n, (unsigned*)hist);
  return (int)cudaGetLastError();
}

// Runs P digit passes and the placement on `stream`. words: W device
// pointers to int64 words of n rows; pass p sorts by digit pass_digit[p] of
// word pass_word[p] with the digit bases bases[p][256] (int32, host
// memory), passes in order least significant first. status: a zeroed
// device int64 buffer of ceil(n / PT_TILE) * 256 look-back words, shared by
// the passes, then one tile ticket per pass; keys, idx: [2][n] int32 device
// buffers. out: W device pointers to int64 outputs, written with the sorted
// words unless `place` is 0; perm: an int64 device output for the
// permutation, or null. Returns the first CUDA error, or 0.
int pt_radix_sort(void* const* words, int W, long long n, int P, const int* pass_word,
                  const int* pass_digit, const int* bases, void* status, void* keys, void* idx,
                  int place, void* const* out, void* perm, void* stream) {
  if (!valid_n(n) || W < 1 || W > PT_MAX_WORDS || P < 0 || P > 4 * W)
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < P; ++p)
    if (pass_word[p] < 0 || pass_word[p] >= W || pass_digit[p] < 0 || pass_digit[p] > 3)
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* kbuf[2] = {(uint32_t*)keys, (uint32_t*)keys + n};
  int* ibuf[2] = {(int*)idx, (int*)idx + n};
  const unsigned tiles = (unsigned)((n + PT_TILE - 1) / PT_TILE);
  unsigned long long* tickets = (unsigned long long*)status + (size_t)tiles * PT_RADIX;
  const unsigned place_blocks = (unsigned)((n + PT_PLACE_THREADS - 1) / PT_PLACE_THREADS);
  int cur = -1;   // the idx buffer holding the index; -1: the identity
  int kcur = -1;  // the keys buffer holding the current word's keys
  for (int p = 0; p < P; ++p) {
    const int w = pass_word[p];
    const bool carried = p > 0 && pass_word[p - 1] == w;
    const bool carry = p + 1 < P && pass_word[p + 1] == w;
    const int kout = carried ? 1 - kcur : 0;
    const int iout = cur < 0 ? 0 : 1 - cur;
    // the word's only pass, through the index: gather its digit's byte
    // copy, written into the keys buffer that no pass holds now
    uint8_t* digits = !carried && !carry && cur >= 0 ? (uint8_t*)kbuf[0] : nullptr;
    if (digits) {
      digit_kernel<<<place_blocks, PT_PLACE_THREADS, 0, s>>>(
          (const long long*)words[w], 8 * pass_digit[p], digits, (int)n);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    Bases b;
    for (int v = 0; v < PT_RADIX; ++v) b.v[v] = bases[(size_t)p * PT_RADIX + v];
    digit_pass_kernel<<<tiles, PT_THREADS, 0, s>>>(
        (const long long*)words[w], carried ? kbuf[kcur] : nullptr, digits,
        cur < 0 ? nullptr : ibuf[cur], carry ? kbuf[kout] : nullptr, ibuf[iout],
        b, (unsigned long long*)status, tickets + p, (int)n, digits ? 0 : 8 * pass_digit[p],
        (unsigned)(p + 1));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur = iout;
    kcur = carry ? kout : -1;
  }
  Words in = {}, outw = {};
  for (int i = 0; i < W; ++i) {
    in.p[i] = (long long*)words[i];
    outw.p[i] = place ? (long long*)out[i] : nullptr;
  }
  place_kernel<<<place_blocks, PT_PLACE_THREADS, 0, s>>>(in, outw, place ? W : 0,
                                                   cur < 0 ? nullptr : ibuf[cur],
                                                   (long long*)perm, (int)n);
  return (int)cudaGetLastError();
}

// The limits compiled in: the most words, the rows of a pass tile and the
// digit values.
void pt_radix_limits(int* out) {
  out[0] = PT_MAX_WORDS;
  out[1] = PT_TILE;
  out[2] = PT_RADIX;
}

const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
