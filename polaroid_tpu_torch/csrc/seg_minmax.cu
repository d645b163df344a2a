// Segment min or max over dense group ids:
//   out[g] = min (or max) of { identity } and { x[i] : gid[i] == g }.
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
// Design: every value becomes an unsigned key whose order is the order in
// which the reduction prefers values, so one integer atomicMax does the
// work for every type and both reductions, and key 0 is weaker than any
// value's key (the empty pattern):
// - the signed order key k: ints are their own key; a float's bits b give
//   k = b >= 0 ? b : b ^ 0x7f..f, which orders -inf < ... < -0.0 < +0.0 <
//   ... < +inf (so min(0.0, -0.0) = -0.0 and max = +0.0, as the JAX
//   package's CPU path gives);
// - the unsigned key flips k's sign bit (max), or flips it and inverts
//   every bit (min), so the preferred value has the larger key;
// - any NaN gets the all-ones key, which wins and which no other float
//   takes, so a group holding a NaN gives NaN for min as well as for max.
//   Which NaN: beside the keys, a float reduction keeps per group the
//   largest NaN bit pattern (as unsigned) it met, and the result is that
//   NaN, so a group whose NaNs share one pattern (the usual case) gets
//   exactly that pattern back, sign and payload.
// One launch on the caller's stream. Each block keeps G partial keys (and
// NaN patterns) in shared memory (at most 128 KB), loads 4 ids (16 bytes)
// and 16 or 32 bytes of values at a time, folds each row in with a
// shared-memory atomic (skipped when the row cannot improve the partial,
// which after the first rows is nearly always), and merges each touched
// partial once into a persistent scratch with a global atomic. The last
// block to finish (a ticket taken after a fence) folds in the identity,
// decodes into out, and returns the scratch and the ticket to zero for the
// next call. Min and max are order-free, so the result is the same on
// every run. Ids outside [0, G) are ignored.

#include <cuda_runtime.h>
#include <stdint.h>

#define PT_THREADS 512
#define PT_UNROLL 2  // vectors of 4 rows in flight a thread
#define PT_MAX_GROUPS 8192  // MAX_GROUPS of ops/cuda_kernels.py

namespace {

// S: the signed order key; U: the unsigned key and the bit pattern of a NaN.
template <typename T>
struct Enc;

template <>
struct Enc<float> {
  using S = int;
  using U = unsigned int;
  static constexpr bool kFloat = true;
  __device__ static U bits(float x) { return __float_as_uint(x); }
  __device__ static bool is_nan(float x) { return x != x; }
  __device__ static S key(float x) {
    const int b = __float_as_int(x);
    return b >= 0 ? b : b ^ 0x7fffffff;
  }
  __device__ static float val(S k) { return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff); }
  __device__ static float nan(U b) { return __uint_as_float(b); }
};

template <>
struct Enc<double> {
  using S = long long;
  using U = unsigned long long;
  static constexpr bool kFloat = true;
  __device__ static U bits(double x) { return (U)__double_as_longlong(x); }
  __device__ static bool is_nan(double x) { return x != x; }
  __device__ static S key(double x) {
    const long long b = __double_as_longlong(x);
    return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
  }
  __device__ static double val(S k) {
    return __longlong_as_double(k >= 0 ? k : k ^ 0x7fffffffffffffffLL);
  }
  __device__ static double nan(U b) { return __longlong_as_double((long long)b); }
};

template <>
struct Enc<int> {
  using S = int;
  using U = unsigned int;
  static constexpr bool kFloat = false;
  __device__ static U bits(int x) { return (U)x; }
  __device__ static bool is_nan(int) { return false; }
  __device__ static S key(int x) { return x; }
  __device__ static int val(S k) { return k; }
  __device__ static int nan(U) { return 0; }
};

template <>
struct Enc<long long> {
  using S = long long;
  using U = unsigned long long;
  static constexpr bool kFloat = false;
  __device__ static U bits(long long x) { return (U)x; }
  __device__ static bool is_nan(long long) { return false; }
  __device__ static S key(long long x) { return x; }
  __device__ static long long val(S k) { return k; }
  __device__ static long long nan(U) { return 0; }
};

template <typename T, bool MAX>
struct Key {
  using E = Enc<T>;
  using S = typename E::S;
  using U = typename E::U;
  static constexpr U SIGN = (U)1 << (8 * sizeof(U) - 1);
  static constexpr U NAN_KEY = ~(U)0;
  __device__ static U of(T x) {
    if (E::is_nan(x)) return NAN_KEY;
    const U u = (U)E::key(x) ^ SIGN;
    return MAX ? u : ~u;
  }
  // x of a non-NaN key
  __device__ static T val(U u) { return E::val((S)((MAX ? u : ~u) ^ SIGN)); }
};

template <typename T, int R>
struct Vec;  // R values of T in 16-byte loads
template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
};
template <>
struct Vec<int, 4> {
  __device__ static void load(const int* p, int* v) {
    const int4 a = *reinterpret_cast<const int4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
};
template <>
struct Vec<double, 4> {
  __device__ static void load(const double* p, double* v) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
};
template <>
struct Vec<long long, 4> {
  __device__ static void load(const long long* p, long long* v) {
    const longlong2 a = reinterpret_cast<const longlong2*>(p)[0];
    const longlong2 b = reinterpret_cast<const longlong2*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
};

// scratch: G keys of U, then G NaN patterns of U (floats), left all zero;
// done: the finished-block ticket, left 0.
template <typename T, bool MAX>
__global__ void __launch_bounds__(PT_THREADS)
minmax_kernel(const T* __restrict__ x, const int* __restrict__ gid, long long n, int G,
              T identity, typename Enc<T>::U* __restrict__ scratch, unsigned* __restrict__ done,
              T* __restrict__ out) {
  using E = Enc<T>;
  using K = Key<T, MAX>;
  using U = typename E::U;
  extern __shared__ unsigned long long smem_raw[];
  U* acc = reinterpret_cast<U*>(smem_raw);
  U* nan_acc = acc + G;  // floats only
  volatile U* seen = acc;
  __shared__ bool s_last;
  for (int k = threadIdx.x; k < G; k += PT_THREADS) {
    acc[k] = 0;
    if (E::kFloat) nan_acc[k] = 0;
  }
  __syncthreads();

  auto fold = [&](int g, T v) {
    if ((unsigned)g < (unsigned)G) {
      if (E::kFloat && E::is_nan(v)) atomicMax(&nan_acc[g], E::bits(v));
      const U u = K::of(v);
      if (u > seen[g]) atomicMax(&acc[g], u);
    }
  };

  // rows [head, head + 4 * nvec) in 16-byte loads; the rest one by one
  long long head = (long long)(((16 - ((uintptr_t)gid & 15)) & 15) >> 2);
  if (head > n) head = n;
  const bool vec = !((uintptr_t)(x + head) & 15);
  const long long nvec = vec ? (n - head) >> 2 : 0;
  if (!vec) head = n;
  const long long tid = (long long)blockIdx.x * PT_THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * PT_THREADS;
  for (long long i = tid; i < nvec; i += PT_UNROLL * stride) {
    int4 g4[PT_UNROLL];
    T v[PT_UNROLL][4];
#pragma unroll
    for (int u = 0; u < PT_UNROLL; ++u) {
      const long long iu = i + u * stride;
      if (iu < nvec) {
        g4[u] = *reinterpret_cast<const int4*>(gid + head + 4 * iu);
        Vec<T, 4>::load(x + head + 4 * iu, v[u]);
      } else {
        g4[u] = make_int4(-1, -1, -1, -1);
      }
    }
#pragma unroll
    for (int u = 0; u < PT_UNROLL; ++u) {
      fold(g4[u].x, v[u][0]);
      fold(g4[u].y, v[u][1]);
      fold(g4[u].z, v[u][2]);
      fold(g4[u].w, v[u][3]);
    }
  }
  const long long tail = head + 4 * nvec;
  for (long long s = tid; s < head + (n - tail); s += stride) {
    const long long r = s < head ? s : tail + (s - head);
    fold(gid[r], x[r]);
  }
  __syncthreads();

  U* keys = scratch;
  U* nans = scratch + G;
  for (int k = threadIdx.x; k < G; k += PT_THREADS) {
    if (acc[k]) atomicMax(&keys[k], acc[k]);
    if (E::kFloat && nan_acc[k]) atomicMax(&nans[k], nan_acc[k]);
  }
  // the last block to get here sees every block's merges
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const U ident = K::of(identity);
  for (int k = threadIdx.x; k < G; k += PT_THREADS) {
    const U a = __ldcg(&keys[k]);
    const U u = a > ident ? a : ident;
    out[k] = E::kFloat && u == K::NAN_KEY ? E::nan(__ldcg(&nans[k])) : K::val(u);
    keys[k] = 0;
    if (E::kFloat) nans[k] = 0;
  }
  if (threadIdx.x == 0) *done = 0;
}

template <typename T>
size_t smem_bytes(int G) {
  return (size_t)G * sizeof(typename Enc<T>::U) * (Enc<T>::kFloat ? 2 : 1);
}

template <typename T, bool MAX>
int occupancy(int G, int* blocks) {
  // allow the largest G's shared memory, so that every G launches
  cudaError_t err = cudaFuncSetAttribute(minmax_kernel<T, MAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes<T>(PT_MAX_GROUPS));
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, minmax_kernel<T, MAX>, PT_THREADS,
                                                      smem_bytes<T>(G));
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return 0;
}

template <typename T, bool MAX>
int launch(const void* x, const void* gid, long long n, int G, T identity, void* out,
           void* scratch, int max_blocks, cudaStream_t s) {
  using U = typename Enc<T>::U;
  const long long want = (n / 4 + PT_THREADS - 1) / PT_THREADS;
  const int blocks = (int)(want < 1 ? 1 : want < max_blocks ? want : max_blocks);
  U* sc = (U*)scratch;
  // the ticket sits after the largest keys and NaN patterns
  unsigned* done = (unsigned*)((unsigned long long*)scratch + 2 * PT_MAX_GROUPS);
  minmax_kernel<T, MAX><<<blocks, PT_THREADS, smem_bytes<T>(G), s>>>(
      (const T*)x, (const int*)gid, n, G, identity, sc, done, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* gid, long long n, int G, int is_max, T identity,
             void* out, void* scratch, int max_blocks, void* stream) {
  if (G < 1 || G > PT_MAX_GROUPS || n < 0 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_max ? launch<T, true>(x, gid, n, G, identity, out, scratch, max_blocks, s)
                : launch<T, false>(x, gid, n, G, identity, out, scratch, max_blocks, s);
}

}  // namespace

extern "C" {

// The most blocks of the kernel for (type, is_max, G) that fit the card at
// once (type 0 f32, 1 f64, 2 int32, 3 int64), after allowing the kernel
// its shared memory; returns the CUDA error, or 0.
int pt_seg_minmax_blocks(int type, int is_max, int G, int* blocks) {
  if (G < 1 || G > PT_MAX_GROUPS) return (int)cudaErrorInvalidValue;
  switch (type * 2 + (is_max != 0)) {
    case 0: return occupancy<float, false>(G, blocks);
    case 1: return occupancy<float, true>(G, blocks);
    case 2: return occupancy<double, false>(G, blocks);
    case 3: return occupancy<double, true>(G, blocks);
    case 4: return occupancy<int, false>(G, blocks);
    case 5: return occupancy<int, true>(G, blocks);
    case 6: return occupancy<long long, false>(G, blocks);
    case 7: return occupancy<long long, true>(G, blocks);
  }
  return (int)cudaErrorInvalidValue;
}

// x: (n,) contiguous, gid: (n,) int32, out: (G,) of x's type (written
// whole), G <= PT_MAX_GROUPS. is_max: 0 for min, 1 for max. identity: the
// value of a group with no rows (not NaN). scratch: a device buffer of
// 2 * PT_MAX_GROUPS + 1 int64, zeroed once and left zero by every call;
// one call at a time uses it. max_blocks: pt_seg_minmax_blocks' answer for the same type, op and G.
int pt_seg_minmax_f32(const void* x, const void* gid, long long n, int G, int is_max,
                      double identity, void* out, void* scratch, int max_blocks, void* stream) {
  return dispatch<float>(x, gid, n, G, is_max, (float)identity, out, scratch, max_blocks, stream);
}

int pt_seg_minmax_f64(const void* x, const void* gid, long long n, int G, int is_max,
                      double identity, void* out, void* scratch, int max_blocks, void* stream) {
  return dispatch<double>(x, gid, n, G, is_max, identity, out, scratch, max_blocks, stream);
}

int pt_seg_minmax_i32(const void* x, const void* gid, long long n, int G, int is_max,
                      long long identity, void* out, void* scratch, int max_blocks,
                      void* stream) {
  return dispatch<int>(x, gid, n, G, is_max, (int)identity, out, scratch, max_blocks, stream);
}

int pt_seg_minmax_i64(const void* x, const void* gid, long long n, int G, int is_max,
                      long long identity, void* out, void* scratch, int max_blocks,
                      void* stream) {
  return dispatch<long long>(x, gid, n, G, is_max, identity, out, scratch, max_blocks, stream);
}

// The most groups compiled in (the scratch holds keys and NaN patterns of
// as many groups).
int pt_seg_minmax_max_groups() { return PT_MAX_GROUPS; }

const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}
