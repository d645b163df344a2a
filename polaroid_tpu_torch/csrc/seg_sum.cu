// Segment sum over dense group ids: out[c, g] = sum_i vals[c, i] * [gid[i] == g].
//
// Replaces: the TPU kernel `_seg_sum_kernel` behind `onehot_seg_sum`
// (polaroid_tpu/ops/pallas_kernels.py). That kernel builds radix one-hot
// tiles in VMEM and multiplies them on the MXU with an f32 accumulator;
// here there is no matrix product at all.
//
// Bound on the H100: device-memory bytes. Each row is read once
// (4 bytes of gid + C values), and the C x G result is tiny (<= 227 KB),
// so the floor is n * (4 + C * itemsize) / 3.35 TB/s.
//
// Design: a grid-stride loop over rows, a few blocks per SM. Each block
// keeps its C x G partial sums in shared memory as f64 and adds each row
// with a shared-memory atomicAdd; at the end the block adds its partials
// once into the global result (zeroed by the caller) with global atomics.
// Rows are read with coalesced loads, the only device-memory traffic is
// the one read of the inputs, and the f64 accumulator keeps counts exact
// and Float64 sums at f64 precision. The order of the atomic additions
// varies from run to run, so sums agree with a sequential f64 sum to
// within n_g * 2^-53 * sum|v| of the group, not bit for bit.
// Ids outside [0, G) contribute nothing. C * G * 8 bytes must fit the
// block's dynamic shared memory; the caller splits C where it does not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void seg_sum_kernel(const T* __restrict__ vals, const int* __restrict__ gid,
                               long long n, int C, int G, double* __restrict__ out) {
  extern __shared__ double acc[];
  const int cg = C * G;
  for (int k = threadIdx.x; k < cg; k += blockDim.x) acc[k] = 0.0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int g = gid[i];
    if ((unsigned)g < (unsigned)G) {
      for (int c = 0; c < C; ++c) {
        atomicAdd(&acc[c * G + g], (double)vals[(long long)c * n + i]);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cg; k += blockDim.x) {
    const double v = acc[k];
    if (v != 0.0) atomicAdd(&out[k], v);
  }
}

template <typename T>
int launch(const void* vals, const void* gid, long long n, int C, int G, void* out,
           void* stream) {
  const int threads = 512;
  const size_t smem = (size_t)C * G * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(seg_sum_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, blocks_per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, seg_sum_kernel<T>,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long want = (n + threads - 1) / threads;
  long long cap = (long long)sms * blocks_per_sm;
  int blocks = (int)(want < cap ? want : cap);
  if (blocks < 1) blocks = 1;
  seg_sum_kernel<T><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)vals, (const int*)gid, n, C, G, (double*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vals: (C, n) contiguous f32, gid: (n,) int32, out: (C, G) f64 zeroed.
int pt_seg_sum_f32(const void* vals, const void* gid, long long n, int C, int G, void* out,
                   void* stream) {
  return launch<float>(vals, gid, n, C, G, out, stream);
}

// vals: (C, n) contiguous f64, gid: (n,) int32, out: (C, G) f64 zeroed.
int pt_seg_sum_f64(const void* vals, const void* gid, long long n, int C, int G, void* out,
                   void* stream) {
  return launch<double>(vals, gid, n, C, G, out, stream);
}

const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}
