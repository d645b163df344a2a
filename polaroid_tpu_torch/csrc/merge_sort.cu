// Bitonic sort of tuples of 32-bit words: kernel F of the port. The rows
// of a [W, n] word-major buffer (n a power of two) are sorted in place,
// lexicographically on their first nk words compared as unsigned; the
// other words ride along. The wrapper makes a stable sort by giving the
// row index as the last key word, so every combined key is distinct and
// the output is the one stable order.
//
// Replaces: the TPU kernel `_chunk_kernel` behind `merge_sort_words`
// (polaroid_tpu/ops/merge_sort.py, `_chunk_pass`). There, batched
// `lax.sort` calls sort 8192-row base blocks, each in-VMEM level is one
// Pallas pass built from 128-lane rolls, and the cross-chunk distances are
// XLA butterfly passes. Here the network is the same
// alternating-direction bitonic network, with no rolls and no lax.sort:
//   (a) tile_kernel: one block loads a tile of T rows x W words into
//       dynamic shared memory (T * W * 4 <= 227 KB), runs every stage whose
//       distance is below T, and writes the tile back. It is the base sort
//       of every tile (levels 2 .. T) and the tail (distances T/2 .. 1) of
//       every later level;
//   (b) stage_kernel: one launch per stage of distance d >= T, one thread
//       per pair.
// The direction of each 2s-row subproblem is bit log2(2s) of its rows'
// global index, so no run is ever reversed.
//
// Bound on the H100: device-memory bytes. The least work reads and writes
// W * n words once: at n = 2^24 and W = 5, 671 MB over 3.35 TB/s, 0.20 ms.
// This design reads and writes the buffer once per pass: one tile pass
// plus, for each level 2s = 2T .. n, its stages of distance >= T and a
// tile pass. At n = 2^24 and T = 2^12 that is 78 stage passes and 13 tile
// passes, about 90 times the bound's traffic. That is what a later
// redesign (a radix sort over the key words, or merge-path merges of
// sorted tiles) removes.

#include <cuda_runtime.h>
#include <stdint.h>

#define PT_MAX_WORDS 32
#define PT_MAX_TILE 4096
#define PT_SMEM_BYTES 232448
#define PT_TILE_THREADS 1024
#define PT_STAGE_THREADS 256

namespace {

// -1, 0 or 1 as row i is below, equal to or above row l over the first nk
// words of a word-major array with the given stride.
template <typename Index>
__device__ __forceinline__ int lex_cmp(const uint32_t* __restrict__ p, Index stride, Index i,
                                       Index l, int nk) {
  for (int w = 0; w < nk; ++w) {
    const uint32_t a = p[w * stride + i];
    const uint32_t b = p[w * stride + l];
    if (a != b) return a > b ? 1 : -1;
  }
  return 0;
}

// Position of the lower row of pair p at distance j (j a power of two).
template <typename Index>
__device__ __forceinline__ Index pair_low(Index p, Index j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

__global__ void __launch_bounds__(PT_TILE_THREADS)
tile_kernel(uint32_t* __restrict__ data, long long n, int W, int nk, int T, long long k_first,
            long long k_last) {
  extern __shared__ uint32_t tile[];  // [W][T]
  const long long base = (long long)blockIdx.x * T;
  for (int w = 0; w < W; ++w)
    for (int r = threadIdx.x; r < T; r += blockDim.x) tile[w * T + r] = data[w * n + base + r];
  __syncthreads();
  const int half = T >> 1;
  for (long long k = k_first; k <= k_last; k <<= 1) {
    const int j_first = (int)((k >> 1) < half ? (k >> 1) : half);
    for (int j = j_first; j >= 1; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = pair_low(p, j);
        const int l = i + j;
        const bool desc = ((base + i) & k) != 0;
        const int c = lex_cmp(tile, T, i, l, nk);
        if (desc ? c < 0 : c > 0) {
          for (int w = 0; w < W; ++w) {
            const uint32_t t = tile[w * T + i];
            tile[w * T + i] = tile[w * T + l];
            tile[w * T + l] = t;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int w = 0; w < W; ++w)
    for (int r = threadIdx.x; r < T; r += blockDim.x) data[w * n + base + r] = tile[w * T + r];
}

__global__ void __launch_bounds__(PT_STAGE_THREADS)
stage_kernel(uint32_t* __restrict__ data, long long n, int W, int nk, long long j, long long k) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (n >> 1)) return;
  const long long i = pair_low(p, j);
  const long long l = i + j;
  const bool desc = (i & k) != 0;
  const int c = lex_cmp(data, n, i, l, nk);
  if (desc ? c < 0 : c > 0) {
    for (int w = 0; w < W; ++w) {
      const uint32_t t = data[w * n + i];
      data[w * n + i] = data[w * n + l];
      data[w * n + l] = t;
    }
  }
}

}  // namespace

extern "C" {

// data: a contiguous [W, n] buffer of 4-byte words on the device, sorted in
// place by its first nk words (unsigned, lexicographic). n: a power of two
// below 2^31; T: the tile rows, a power of two with T <= n, T <=
// PT_MAX_TILE and T * W * 4 <= PT_SMEM_BYTES. Launches 1 + log2(n / T) tile
// passes and the stage passes between them on `stream`; returns the first
// CUDA error, or 0.
int pt_merge_sort_words(void* data, long long n, int W, int nk, int T, void* stream) {
  if (n < 1 || (n & (n - 1)) || n >= (1LL << 31) || W < 1 || W > PT_MAX_WORDS || nk < 1 ||
      nk > W || T < 1 || (T & (T - 1)) || T > PT_MAX_TILE || T > n ||
      (long long)T * W * 4 > PT_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         PT_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* d = (uint32_t*)data;
  const size_t smem = (size_t)T * W * 4;
  const int tile_threads = T / 2 < 1 ? 1 : (T / 2 < PT_TILE_THREADS ? T / 2 : PT_TILE_THREADS);
  const unsigned tiles = (unsigned)(n / T);
  const unsigned stage_blocks = (unsigned)(((n >> 1) + PT_STAGE_THREADS - 1) / PT_STAGE_THREADS);
  tile_kernel<<<tiles, tile_threads, smem, s>>>(d, n, W, nk, T, 2, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (long long k = 2LL * T; k <= n; k <<= 1) {
    for (long long j = k >> 1; j >= T; j >>= 1) {
      stage_kernel<<<stage_blocks, PT_STAGE_THREADS, 0, s>>>(d, n, W, nk, j, k);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    tile_kernel<<<tiles, tile_threads, smem, s>>>(d, n, W, nk, T, k, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// The limits compiled in: the most words, the largest tile and the shared
// memory a tile may use.
void pt_merge_sort_limits(int* out) {
  out[0] = PT_MAX_WORDS;
  out[1] = PT_MAX_TILE;
  out[2] = PT_SMEM_BYTES;
}

const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}
