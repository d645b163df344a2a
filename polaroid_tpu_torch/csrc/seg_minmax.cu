// Segment min or max over dense group ids:
//   out[g] = min (or max) of { x[i] : gid[i] == g },  identity where none.
//
// Replaces: the TPU kernel `_seg_minmax_kernel` behind `onehot_seg_minmax`
// (polaroid_tpu/ops/pallas_kernels.py). That kernel compares each row's
// gid against all G lanes in VMEM and reduces a (rows, G) masked window,
// f32 only; here each row touches only its own group, and x may be f32,
// f64, int32 or int64.
//
// Bound on the H100: device-memory bytes. Each row is read once (4 bytes
// of gid + the value), and the G results are tiny, so the floor is
// n * (4 + itemsize) / 3.35 TB/s.
//
// Design: every value becomes a signed integer key whose order is the
// order the reduction wants, so one integer atomicMin/atomicMax does the
// work for every type:
// - ints are their own key;
// - a float's bits b give key = b >= 0 ? b : b ^ 0x7f..f, which orders
//   -inf < ... < -0.0 < +0.0 < ... < +inf (so min(0.0, -0.0) = -0.0 and
//   max = +0.0, as the JAX package's CPU path gives);
// - any NaN becomes the key that wins (INT_MIN for min, INT_MAX for max;
//   no other float maps there), so a group holding a NaN gives NaN for min
//   as well as for max. Which NaN: beside the keys, a float reduction
//   keeps per group the largest NaN bit pattern (as unsigned) it met, and
//   the result is that NaN, so a group whose NaNs share one pattern (the
//   usual case) gets exactly that pattern back, sign and payload.
// Three launches on the caller's stream: `init` writes the identity's key
// (and "no NaN", 0) to the G outputs; `reduce` keeps each block's G
// partials in shared memory (at most 64 KB), folds each row in with a
// shared-memory atomic (skipped when the row cannot improve the partial,
// which after the first rows is nearly always), and merges each touched
// partial once into the output with a global atomic; `decode` turns the
// keys back into values in place. Min and max are order-free, so the
// result is the same on every run. Ids outside [0, G) are ignored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// K: the signed order key; U: the unsigned bit pattern of a NaN.
template <typename T>
struct Enc;

template <>
struct Enc<float> {
  using K = int;
  using U = unsigned int;
  static constexpr bool kFloat = true;
  __device__ static K nan_key(bool is_max) { return is_max ? 0x7fffffff : (int)0x80000000; }
  __device__ static U bits(float x) { return __float_as_uint(x); }
  __device__ static K key(float x, bool is_max) {
    if (x != x) return nan_key(is_max);
    const int b = __float_as_int(x);
    return b >= 0 ? b : b ^ 0x7fffffff;
  }
  __device__ static float val(K k, U nan_bits, bool is_max) {
    if (k == nan_key(is_max)) return __uint_as_float(nan_bits);
    return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
  }
};

template <>
struct Enc<double> {
  using K = long long;
  using U = unsigned long long;
  static constexpr bool kFloat = true;
  __device__ static K nan_key(bool is_max) {
    return is_max ? 0x7fffffffffffffffLL : (long long)0x8000000000000000ULL;
  }
  __device__ static U bits(double x) { return (U)__double_as_longlong(x); }
  __device__ static K key(double x, bool is_max) {
    if (x != x) return nan_key(is_max);
    const long long b = __double_as_longlong(x);
    return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
  }
  __device__ static double val(K k, U nan_bits, bool is_max) {
    if (k == nan_key(is_max)) return __longlong_as_double((long long)nan_bits);
    return __longlong_as_double(k >= 0 ? k : k ^ 0x7fffffffffffffffLL);
  }
};

template <>
struct Enc<int> {
  using K = int;
  using U = unsigned int;
  static constexpr bool kFloat = false;
  __device__ static U bits(int x) { return (U)x; }
  __device__ static K key(int x, bool) { return x; }
  __device__ static int val(K k, U, bool) { return k; }
};

template <>
struct Enc<long long> {
  using K = long long;
  using U = unsigned long long;
  static constexpr bool kFloat = false;
  __device__ static U bits(long long x) { return (U)x; }
  __device__ static K key(long long x, bool) { return x; }
  __device__ static long long val(K k, U, bool) { return k; }
};

// nan_out is null for the integer types.
template <typename T>
__global__ void init_kernel(T identity, int G, bool is_max, typename Enc<T>::K* __restrict__ out,
                            typename Enc<T>::U* __restrict__ nan_out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) {
    out[g] = Enc<T>::key(identity, is_max);
    if (Enc<T>::kFloat) nan_out[g] = 0;
  }
}

template <typename T, bool MAX>
__global__ void reduce_kernel(const T* __restrict__ x, const int* __restrict__ gid, long long n,
                              int G, T identity, typename Enc<T>::K* __restrict__ out,
                              typename Enc<T>::U* __restrict__ nan_out) {
  using K = typename Enc<T>::K;
  using U = typename Enc<T>::U;
  extern __shared__ unsigned long long smem_raw[];
  K* acc = reinterpret_cast<K*>(smem_raw);
  U* nan_acc = reinterpret_cast<U*>(acc + G);  // floats only
  volatile K* seen = acc;
  const K ident = Enc<T>::key(identity, MAX);
  for (int k = threadIdx.x; k < G; k += blockDim.x) {
    acc[k] = ident;
    if (Enc<T>::kFloat) nan_acc[k] = 0;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int g = gid[i];
    if ((unsigned)g < (unsigned)G) {
      const T v = x[i];
      if (Enc<T>::kFloat && v != v) atomicMax(&nan_acc[g], Enc<T>::bits(v));
      const K k = Enc<T>::key(v, MAX);
      if (MAX ? k > seen[g] : k < seen[g]) {
        if (MAX) atomicMax(&acc[g], k);
        else atomicMin(&acc[g], k);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < G; k += blockDim.x) {
    const K v = acc[k];
    if (v != ident) {
      if (MAX) atomicMax(&out[k], v);
      else atomicMin(&out[k], v);
    }
    if (Enc<T>::kFloat && nan_acc[k] != 0) atomicMax(&nan_out[k], nan_acc[k]);
  }
}

template <typename T>
__global__ void decode_kernel(int G, bool is_max, T* __restrict__ out,
                              const typename Enc<T>::U* __restrict__ nan_out) {
  using K = typename Enc<T>::K;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) {
    const K k = reinterpret_cast<const K*>(out)[g];
    out[g] = Enc<T>::val(k, Enc<T>::kFloat ? nan_out[g] : 0, is_max);
  }
}

template <typename T, bool MAX>
int launch_reduce(const T* x, const int* gid, long long n, int G, T identity,
                  typename Enc<T>::K* keys, typename Enc<T>::U* nan_bits, cudaStream_t stream) {
  const int threads = 512;
  const size_t smem = (size_t)G * (sizeof(typename Enc<T>::K) +
                                   (Enc<T>::kFloat ? sizeof(typename Enc<T>::U) : 0));
  cudaError_t err = cudaFuncSetAttribute(reduce_kernel<T, MAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, blocks_per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, reduce_kernel<T, MAX>,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (n + threads - 1) / threads;
  const long long cap = (long long)sms * blocks_per_sm;
  int blocks = (int)(want < cap ? want : cap);
  if (blocks < 1) blocks = 1;
  reduce_kernel<T, MAX><<<blocks, threads, smem, stream>>>(x, gid, n, G, identity, keys,
                                                           nan_bits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* gid, long long n, int G, int is_max, T identity, void* out,
           void* nan_bits, void* stream) {
  using K = typename Enc<T>::K;
  using U = typename Enc<T>::U;
  if (Enc<T>::kFloat && nan_bits == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  K* keys = reinterpret_cast<K*>(out);
  U* nans = reinterpret_cast<U*>(nan_bits);
  const int gthreads = 256;
  const int gblocks = (G + gthreads - 1) / gthreads;
  init_kernel<T><<<gblocks, gthreads, 0, s>>>(identity, G, is_max != 0, keys, nans);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rc =
      is_max ? launch_reduce<T, true>((const T*)x, (const int*)gid, n, G, identity, keys, nans, s)
             : launch_reduce<T, false>((const T*)x, (const int*)gid, n, G, identity, keys, nans, s);
  if (rc != 0) return rc;
  decode_kernel<T><<<gblocks, gthreads, 0, s>>>(G, is_max != 0, (T*)out, nans);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n,) contiguous, gid: (n,) int32, out: (G,) of x's type (written
// whole). is_max: 0 for min, 1 for max. identity: the value of a group
// with no rows (not NaN). nan_bits: (G,) 4-byte (f32) or 8-byte (f64)
// scratch for the floats, null for the ints.
int pt_seg_minmax_f32(const void* x, const void* gid, long long n, int G, int is_max,
                      double identity, void* out, void* nan_bits, void* stream) {
  return launch<float>(x, gid, n, G, is_max, (float)identity, out, nan_bits, stream);
}

int pt_seg_minmax_f64(const void* x, const void* gid, long long n, int G, int is_max,
                      double identity, void* out, void* nan_bits, void* stream) {
  return launch<double>(x, gid, n, G, is_max, identity, out, nan_bits, stream);
}

int pt_seg_minmax_i32(const void* x, const void* gid, long long n, int G, int is_max,
                      long long identity, void* out, void* nan_bits, void* stream) {
  return launch<int>(x, gid, n, G, is_max, (int)identity, out, nan_bits, stream);
}

int pt_seg_minmax_i64(const void* x, const void* gid, long long n, int G, int is_max,
                      long long identity, void* out, void* nan_bits, void* stream) {
  return launch<long long>(x, gid, n, G, is_max, identity, out, nan_bits, stream);
}

const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}
