// Stable compaction of 4-byte words: the rows where mask is true move to
// a prefix of each output, in their original order.
//
// Replaces: the TPU kernels `_partition_concat_kernel` (behind
// `compact_words`) and `_concat_kernel` (behind `_prefix_concat`, the
// PT_PARTITION_SHIFT=0 variant) in polaroid_tpu/ops/pallas_partition.py.
// Both implement one contract; on the TPU they compact 8192-row VMEM
// blocks with shift passes and stitch them with lane rotations and DMAs,
// which is why they need n % 8192 == 0. This kernel takes any n >= 1.
//
// Bound on the H100: device-memory bytes, n * (1 + 4W) read plus
// count * 4W written for W words, over 3.35 TB/s.
//
// Design: as on the TPU, the per-tile live counts and their exclusive
// prefix (`offs`) are computed outside the kernel (torch ops in the
// wrapper). Then one block per tile of TILE rows, one row per thread:
// each warp ranks its live rows with __ballot_sync/__popc, warp 0 scans
// the warp totals in shared memory, and every live row writes its words
// to out[offs[tile] + rank]. Order is kept by construction, rows are read
// and written once, and no sort is needed. A word may be a strided view
// (stride 2 for one half of an 8-byte column); its output uses the same
// stride, so an 8-byte column compacts as two words with no repacking.

#include <cuda_runtime.h>
#include <stdint.h>

#define PT_TILE 1024
#define PT_MAX_WORDS 32

struct WordPtrs {
  const uint32_t* in[PT_MAX_WORDS];
  uint32_t* out[PT_MAX_WORDS];
  long long stride[PT_MAX_WORDS];  // shared by the input and its output
};

namespace {

__global__ void __launch_bounds__(PT_TILE)
compact_kernel(const unsigned char* __restrict__ mask, const long long* __restrict__ offs,
               long long n, int W, WordPtrs p) {
  __shared__ int warp_base[PT_TILE / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * PT_TILE + threadIdx.x;
  const bool live = row < n && mask[row] != 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    // exclusive scan of the 32 warp totals
    const int total = warp_base[lane];
    int incl = total;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    warp_base[lane] = incl - total;
  }
  __syncthreads();
  if (!live) return;
  const int rank = warp_base[warp] + __popc(ballot & ((1u << lane) - 1u));
  const long long dst = offs[blockIdx.x] + rank;
  for (int w = 0; w < W; ++w) {
    p.out[w][dst * p.stride[w]] = p.in[w][row * p.stride[w]];
  }
}

}  // namespace

extern "C" {

// mask: (n,) bool; offs: (ceil(n / 1024),) int64 exclusive prefix of the
// per-tile live counts; in_ptrs/out_ptrs/strides: host arrays of W (<= 32)
// device pointers and element strides (inputs and outputs share strides).
int pt_compact_words(const void* mask, const void* offs, long long n, int W,
                     const void* in_ptrs, const void* out_ptrs, const void* strides,
                     void* stream) {
  if (W < 1 || W > PT_MAX_WORDS) return (int)cudaErrorInvalidValue;
  WordPtrs p;
  const uint32_t* const* ins = (const uint32_t* const*)in_ptrs;
  uint32_t* const* outs = (uint32_t* const*)out_ptrs;
  const long long* st = (const long long*)strides;
  for (int w = 0; w < W; ++w) {
    p.in[w] = ins[w];
    p.out[w] = outs[w];
    p.stride[w] = st[w];
  }
  const long long tiles = (n + PT_TILE - 1) / PT_TILE;
  compact_kernel<<<(unsigned)tiles, PT_TILE, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)mask, (const long long*)offs, n, W, p);
  return (int)cudaGetLastError();
}

int pt_compact_tile() { return PT_TILE; }

const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}
