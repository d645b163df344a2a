// Group -> row gather: out[i] = table[gid[i]], and 0 where gid[i] lies
// outside [0, G).
//
// Replaces: the TPU kernel `_gather_kernel` behind `onehot_gather`
// (polaroid_tpu/ops/pallas_kernels.py). The TPU has no fast gather, so
// that kernel multiplies a one-hot of each gid's high radix digit by the
// table on the MXU (in f32) and picks the low digit with a masked sum.
// The card gathers directly, in the table's own type (f32 or f64), so a
// Float64 group mean comes back to its rows bit for bit.
//
// Bound on the H100: device-memory bytes. Each gid is read once and each
// output written once, n * (4 + itemsize), over 3.35 TB/s; the table
// (at most a few KB at the dense tier's G) stays in cache.
//
// Design: a grid-stride loop, one row per thread and step, so that a
// warp reads 32 neighbouring gids and writes 32 neighbouring outputs
// (coalesced). Table reads go through the read-only data cache (__ldg):
// the whole table fits each SM's L1, so they cost no device-memory
// traffic after the first touch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void gather_kernel(const T* __restrict__ table, int G, const int* __restrict__ gid,
                              long long n, T* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int g = gid[i];
    out[i] = (unsigned)g < (unsigned)G ? __ldg(&table[g]) : T(0);
  }
}

template <typename T>
int launch(const void* table, int G, const void* gid, long long n, void* out, void* stream) {
  const int threads = 256;
  int dev = 0, sms = 0, blocks_per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm,
                                                                  gather_kernel<T>, threads, 0);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (n + threads - 1) / threads;
  const long long cap = (long long)sms * blocks_per_sm;
  int blocks = (int)(want < cap ? want : cap);
  if (blocks < 1) return 0;  // n == 0: nothing to write
  gather_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)table, G, (const int*)gid, n, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table: (G,) contiguous f32, gid: (n,) int32, out: (n,) f32.
int pt_gather_f32(const void* table, int G, const void* gid, long long n, void* out,
                  void* stream) {
  return launch<float>(table, G, gid, n, out, stream);
}

// table: (G,) contiguous f64, gid: (n,) int32, out: (n,) f64.
int pt_gather_f64(const void* table, int G, const void* gid, long long n, void* out,
                  void* stream) {
  return launch<double>(table, G, gid, n, out, stream);
}

const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}
