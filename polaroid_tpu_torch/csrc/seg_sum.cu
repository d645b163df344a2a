// Segment sum over dense group ids: out[c, g] = sum_i vals[c, i] * [gid[i] == g],
// with an optional count row: out[0, g] = #{i : gid[i] == g}.
//
// Replaces: the TPU kernel `_seg_sum_kernel` behind `onehot_seg_sum`
// (polaroid_tpu/ops/pallas_kernels.py). That kernel builds radix one-hot
// tiles in VMEM and multiplies them on the MXU with an f32 accumulator;
// here there is no matrix product at all.
//
// Bound on the H100: device-memory bytes. Each row is read once (4 bytes
// of gid and C values; the count reads nothing more) and the (C + count) x
// G f64 result is written once, so the floor is
// (n * (4 + C * itemsize) + (C + count) * G * 8) / 3.35 TB/s. What holds
// the kernel above it is the shared-memory add: sm_90 has no shared f64
// atomic add (atomicAdd(double*) on shared memory compiles to an
// ATOMS.CAST.SPIN.64 loop, about one lane a clock an SM), while the u32
// count's add is a native ATOMS.ADD.
//
// Design (the launch plan is `seg_sum_plan` in ops/cuda_kernels.py):
// * One block of 1024 threads an SM, holding its f64 partials of up to 8
//   columns (3 at G 8192, where 64 KB a column fill 227 KB) and a u32
//   count row in shared memory. More columns go to further column groups in
//   the same launch, block b taking group b % groups.
// * Rows in flight. Each warp takes chunks of 32 * U consecutive rows and
//   loads all of a chunk's gid and values before it adds anything (U = 8,
//   4 or 2 as the block takes up to 2, 4 or 8 columns): coalesced loads,
//   values with the streaming hint, as they are read once.
// * Hot groups. The first 32-row slot of a chunk is sampled with
//   __match_any_sync (every chunk while the samples call for peer sets,
//   else every fourth): where adding by peer sets saves enough rows (its rows
//   in [0, G) less their distinct groups, against a threshold that falls
//   with the columns), the warp adds the chunk's slots by peer sets (each
//   set's values summed by shuffles into its lowest lane, in log2 of its
//   size steps; a slot all in one group by a butterfly), one shared add a
//   set and column. Else each lane adds its own row: __match_any_sync on
//   every slot costs more than the atomics it saves on keys that rarely
//   meet, and the count's native atomics take even hot keys.
// * Replicated partials. The block holds one copy of its partials a warp
//   where they fit (then a warp's peer-set adds are plain read-add-writes,
//   a __syncwarp apart), else two (warp w adding into copy w % 2, which
//   halves the contention of hot groups), else one. The copies are merged
//   in shared memory and each block adds its nonzero partials once into
//   the result with global f64 atomics.
// * The result. Block 0 zeroes it while the other blocks read rows and
//   raises a flag in a persistent scratch, on which every block waits
//   before its global adds; the last block to finish (a ticket) lowers the
//   flag and the ticket for the next launch on the stream. So a call is one
//   launch, with no memset before it, and is captured by a CUDA graph as
//   it is. (Zeroing by every block of the first wave measured no faster at
//   the port's shapes, and would need that whole wave resident at once.)
// f64 partials keep counts exact and Float64 sums at f64 precision. The
// order of the additions (peer sets, atomics, copies, blocks) varies from
// run to run, so a sum agrees with a sequential f64 sum to within
// n_g * 2^-53 * sum|v| of its group, not bit for bit. Ids outside [0, G)
// add nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
// flags: bits 0-7, and from bit 8 the fewest rows that adding by peer sets
// must save in a sampled slot for a warp to add its chunk so (0: never)
constexpr int kCount = 1;    // row 0 of the result counts the ids
constexpr int kPrivate = 2;  // one copy of the partials a warp
constexpr int kAggShift = 8;
// chunks a warp adds lane by lane, unsampled, after a sample that did not
// call for peer sets
constexpr int kSkip = 3;

// rows each thread holds in flight, by the most columns a block takes
template <int CMAX>
struct RowsInFlight {
  static constexpr int value = CMAX >= 8 ? 2 : (CMAX >= 4 ? 4 : 8);
};

// __launch_bounds__(1024, 1) holds a thread to 64 registers: one block of
// 1024 threads or two of 512 fit an SM
template <typename T, int CMAX>
__global__ void __launch_bounds__(kMaxThreads, 1)
seg_sum_kernel(const T* __restrict__ vals, const int* __restrict__ gid, long long n, int C,
               int G, int cols, int groups, int R, int flags, double* __restrict__ out,
               unsigned* __restrict__ scratch) {
  constexpr int U = RowsInFlight<CMAX>::value;
  constexpr int CA = CMAX > 0 ? CMAX : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cg = blockIdx.x % groups;
  const int worker = blockIdx.x / groups;
  const int workers = gridDim.x / groups;
  const int c0 = cg * cols;
  const int nc = CMAX > 0 ? min(cols, C - c0) : 0;
  const bool has_count = flags & kCount;
  const bool count = has_count && cg == 0;
  const bool priv = flags & kPrivate;
  const int agg_at = CMAX > 0 ? flags >> kAggShift : 0;
  double* acc = reinterpret_cast<double*>(smem);
  unsigned* cnt = reinterpret_cast<unsigned*>(acc + (size_t)R * cols * G);
  const int words = R * G * (2 * cols + (has_count ? 1 : 0));
  unsigned* w32 = reinterpret_cast<unsigned*>(smem);
  for (int k = threadIdx.x; k < words; k += blockDim.x) w32[k] = 0u;
  // block 0 zeroes the result while the other blocks read rows, then
  // raises the flag that every block waits on before it adds into the
  // result (blocks are dispatched in index order: a block that waits finds
  // block 0 dispatched)
  unsigned* ready = scratch;
  unsigned* done = scratch + 1;
  if (blockIdx.x == 0) {
    const int all = (C + (has_count ? 1 : 0)) * G;
    for (int k = threadIdx.x; k < all; k += blockDim.x) out[k] = 0.0;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicExch(ready, 1u);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  double* my_acc = acc + (size_t)(warp % R) * cols * G;
  unsigned* my_cnt = cnt + (size_t)(warp % R) * G;
  const T* v0 = vals + (long long)c0 * n;
  const long long chunk = 32LL * U;
  const long long stride = (long long)workers * warps * chunk;
  int skip = 0;
  for (long long base = ((long long)worker * warps + warp) * chunk; base < n; base += stride) {
    int g[U];
    double x[U][CA];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long i = base + j * 32 + lane;
      const int v = i < n ? __ldg(gid + i) : -1;
      g[j] = (unsigned)v < (unsigned)G ? v : -1;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long i = base + j * 32 + lane;
#pragma unroll
      for (int c = 0; c < CA; ++c)
        x[j][c] = (CMAX > 0 && c < nc && i < n) ? (double)__ldcs(v0 + (long long)c * n + i) : 0.0;
    }
    // the first slot's peer sets decide for the chunk: where adding by
    // peer sets saves at least agg_at of its rows (hot keys) the warp
    // aggregates, else each lane adds its own row, and the next kSkip
    // chunks are not sampled
    unsigned peers0 = 0u;
    bool agg = false;
    if (agg_at > 0 && skip-- == 0) {
      peers0 = __match_any_sync(kFull, g[0]);
      const int rows = __popc(__ballot_sync(kFull, g[0] >= 0));
      const int sets = __popc(__ballot_sync(kFull, g[0] >= 0 && (peers0 & below) == 0u));
      agg = rows - sets >= agg_at;
      skip = agg ? 0 : kSkip;
    }
    if (!agg) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int gj = g[j];
        if (gj >= 0) {
#pragma unroll
          for (int c = 0; c < CA; ++c)
            if (c < nc) atomicAdd(&my_acc[c * G + gj], x[j][c]);
          if (count) atomicAdd(&my_cnt[gj], 1u);
        }
      }
      continue;
    }
    // a private copy's atomics of an earlier chunk before its plain adds
    if (priv) __syncwarp();
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int gj = g[j];
      if (__all_sync(kFull, gj == __shfl_sync(kFull, gj, 0))) {
        // the whole slot in one group (or outside every group): a butterfly
        if (gj >= 0) {
#pragma unroll
          for (int c = 0; c < CA; ++c) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) x[j][c] += __shfl_xor_sync(kFull, x[j][c], o);
          }
          if (lane == 0) {
            if (priv) {
#pragma unroll
              for (int c = 0; c < CA; ++c)
                if (c < nc) my_acc[c * G + gj] += x[j][c];
              if (count) my_cnt[gj] += 32u;
            } else {
#pragma unroll
              for (int c = 0; c < CA; ++c)
                if (c < nc) atomicAdd(&my_acc[c * G + gj], x[j][c]);
              if (count) atomicAdd(&my_cnt[gj], 32u);
            }
          }
        }
        if (priv) __syncwarp();
        continue;
      }
      const unsigned peers = j == 0 ? peers0 : __match_any_sync(kFull, gj);
      // each peer set's values into its lowest lane: at step k a lane adds
      // the running sum of the next remaining peer above it, and the lanes
      // of odd rank among the remaining drop out (rows outside every group
      // take no part)
      unsigned above = gj >= 0 ? peers & ~(below | (1u << lane)) : 0u;
      int rank = __popc(peers & below);
      while (__any_sync(kFull, above)) {
        const int next = __ffs(above) - 1;
#pragma unroll
        for (int c = 0; c < CA; ++c) {
          const double t = __shfl_sync(kFull, x[j][c], next & 31);
          if (next >= 0) x[j][c] += t;
        }
        above &= __ballot_sync(kFull, (rank & 1) == 0);
        rank >>= 1;
      }
      if (gj >= 0 && (peers & below) == 0u) {
        if (priv) {
#pragma unroll
          for (int c = 0; c < CA; ++c)
            if (c < nc) my_acc[c * G + gj] += x[j][c];
          if (count) my_cnt[gj] += __popc(peers);
        } else {
#pragma unroll
          for (int c = 0; c < CA; ++c)
            if (c < nc) atomicAdd(&my_acc[c * G + gj], x[j][c]);
          if (count) atomicAdd(&my_cnt[gj], (unsigned)__popc(peers));
        }
      }
      // a private copy's plain adds: one slot's before the next's
      if (priv) __syncwarp();
    }
  }
  __syncthreads();

  // merge the copies and add the block's partials into the result, once
  // it is zeroed
  if (threadIdx.x == 0) {
    while (atomicAdd(ready, 0u) == 0u) __nanosleep(100);
    __threadfence();
  }
  __syncthreads();
  const int row0 = (has_count ? 1 : 0) + c0;
  const int cells = nc * G;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    double s = 0.0;
    for (int r = 0; r < R; ++r) s += acc[(size_t)r * cols * G + k];
    if (s != 0.0) atomicAdd(&out[(size_t)row0 * G + k], s);
  }
  if (count) {
    for (int k = threadIdx.x; k < G; k += blockDim.x) {
      unsigned s = 0u;
      for (int r = 0; r < R; ++r) s += cnt[(size_t)r * G + k];
      if (s != 0u) atomicAdd(&out[k], (double)s);
    }
  }
  // the last block to finish lowers the flag and the ticket for the next
  // launch on the stream (every block has waited on the flag by then)
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(done, 1u) == gridDim.x - 1) {
    *ready = 0u;
    *done = 0u;
  }
}

template <typename T, int CMAX>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&seg_sum_kernel<T, CMAX>);
}

int cmax_index(int cmax) {
  switch (cmax) {
    case 0: return 0;
    case 1: return 1;
    case 2: return 2;
    case 4: return 3;
    case 8: return 4;
    default: return -1;
  }
}

const void* kernel(int f64, int cmax) {
  static const void* table[2][5] = {
      {kernel_of<float, 0>(), kernel_of<float, 1>(), kernel_of<float, 2>(),
       kernel_of<float, 4>(), kernel_of<float, 8>()},
      {kernel_of<double, 0>(), kernel_of<double, 1>(), kernel_of<double, 2>(),
       kernel_of<double, 4>(), kernel_of<double, 8>()}};
  const int k = cmax_index(cmax);
  return k < 0 ? nullptr : table[f64 ? 1 : 0][k];
}

// whether each kernel may take the most dynamic shared memory, per device:
// set once (the same value every time, so two threads racing set it twice)
bool g_smem_set[kMaxDevices][2][5];

int prepare(int f64, int cmax, const void** fn) {
  *fn = kernel(f64, cmax);
  if (*fn == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  bool& set = g_smem_set[dev][f64 ? 1 : 0][cmax_index(cmax)];
  if (!set) {
    err = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    set = true;
  }
  return 0;
}

}  // namespace

extern "C" {

// vals: (C, n) contiguous f32 (plan[0] = 0) or f64 (plan[0] = 1); gid:
// (n,) int32; out: (C + count, G) f64, every element written; scratch: two
// u32 words, zero, and left zero (block 0's flag that the result is zeroed,
// and the finished blocks' ticket).
// plan: the words of `seg_sum_plan` (ops/cuda_kernels.py `_seg_words`):
// f64, cmax, C, G, cols, groups, replicas, flags, threads, blocks, smem;
// blocks is a multiple of groups, smem = replicas * G * (8 * cols + 4 *
// count) bytes.
int pt_seg_sum(const void* vals, const void* gid, long long n, const int* plan, void* out,
               void* scratch, void* stream) {
  const int f64 = plan[0], cmax = plan[1];
  int C = plan[2], G = plan[3], cols = plan[4], groups = plan[5], replicas = plan[6],
      flags = plan[7];
  const int threads = plan[8], blocks = plan[9], smem = plan[10];
  const void* fn = nullptr;
  int err = prepare(f64, cmax, &fn);
  if (err != 0) return err;
  if (threads > kMaxThreads || threads % 32 != 0 || groups < 1 || blocks % groups != 0 ||
      replicas < 1 || smem > kMaxSmem)
    return (int)cudaErrorInvalidConfiguration;
  void* args[] = {(void*)&vals,     (void*)&gid,   (void*)&n,     (void*)&C,
                  (void*)&G,        (void*)&cols,  (void*)&groups, (void*)&replicas,
                  (void*)&flags,    (void*)&out,   (void*)&scratch};
  const cudaError_t e = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, (size_t)smem,
                                         (cudaStream_t)stream);
  // a refused launch leaves its error behind for the next check: clear it
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// the blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that fit one SM of the current device
int pt_seg_sum_occupancy(int f64, int cmax, int threads, int smem, int* blocks_per_sm) {
  const void* fn = nullptr;
  int err = prepare(f64, cmax, &fn);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads,
                                                           (size_t)smem);
}

const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}
