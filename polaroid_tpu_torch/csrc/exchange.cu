// Bucket exchange: the shuffle step of the hash-exchange group-by. Each
// block of PT_S rows arrives sorted so that the rows of each of its PT_K
// buckets form one contiguous run [starts[b,k], starts[b,k] + counts[b,k]).
// Every run is copied into a padded cell of PT_CAP slots of a
// bucket-major [PT_K, B * PT_CAP] output; the slots past the run hold a
// fill word. A run longer than PT_CAP is cut at PT_CAP (the caller checks
// counts.max() <= PT_CAP first and takes its fallback otherwise).
//
// Replaces: the TPU kernel `_exchange_kernel` behind `bucket_exchange`
// (polaroid_tpu/ops/exchange.py). On the TPU each grid step holds one
// source block in VMEM, aligns every run with a lane roll and writes the
// [B, K, CAP] layout, and a separate XLA transpose makes it [K, B * CAP].
// Here each cell writes its place in the transposed layout directly.
//
// Bound on the H100: device-memory bytes. Per word, the live rows are
// read once and all B * PT_K * PT_CAP slots written once, plus the
// starts and counts, over 3.35 TB/s. No arithmetic to speak of.
//
// Design: one thread block of PT_CAP / 3 threads per (b, k) cell. The
// block reads its run's extent once, then for each word every thread
// copies three slots: neighbouring threads read neighbouring source rows
// and write neighbouring output slots, so both sides are coalesced. The
// extent is clamped to the source block (starts in [0, PT_S], runs ending
// by PT_S), so no input outside the block is read whatever the table.

#include <cuda_runtime.h>
#include <stdint.h>

#define PT_S 8192
#define PT_K 32
#define PT_CAP 384
#define PT_MAX_WORDS 8
#define PT_THREADS (PT_CAP / 3)

struct ExchangeWords {
  const uint32_t* in[PT_MAX_WORDS];
  uint32_t* out[PT_MAX_WORDS];
  uint32_t fill[PT_MAX_WORDS];
};

namespace {

__global__ void __launch_bounds__(PT_THREADS)
exchange_kernel(const int* __restrict__ starts, const int* __restrict__ counts, long long B,
                int W, ExchangeWords p) {
  const long long cell = blockIdx.x;  // b * PT_K + k
  const long long b = cell / PT_K;
  const int k = (int)(cell % PT_K);
  int s = starts[cell];
  s = s < 0 ? 0 : (s > PT_S ? PT_S : s);
  int c = counts[cell];
  c = c < 0 ? 0 : c;
  c = c < PT_CAP ? c : PT_CAP;
  c = c < PT_S - s ? c : PT_S - s;
  const long long src = b * PT_S + s;
  const long long dst = (long long)k * B * PT_CAP + b * PT_CAP;
  for (int w = 0; w < W; ++w) {
    const uint32_t* __restrict__ in = p.in[w];
    uint32_t* __restrict__ out = p.out[w];
    const uint32_t fill = p.fill[w];
    for (int j = threadIdx.x; j < PT_CAP; j += PT_THREADS) {
      out[dst + j] = j < c ? in[src + j] : fill;
    }
  }
}

}  // namespace

extern "C" {

// starts, counts: (B, PT_K) contiguous int32; in_ptrs/out_ptrs: host
// arrays of W (<= PT_MAX_WORDS) device pointers, inputs (B * PT_S,) and
// outputs (PT_K, B * PT_CAP), all 4-byte words; fills: host array of W
// fill words.
int pt_bucket_exchange(const void* starts, const void* counts, long long B, int W,
                       const void* in_ptrs, const void* out_ptrs, const void* fills,
                       void* stream) {
  if (W < 1 || W > PT_MAX_WORDS || B < 1 || B * PT_K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  ExchangeWords p;
  const uint32_t* const* ins = (const uint32_t* const*)in_ptrs;
  uint32_t* const* outs = (uint32_t* const*)out_ptrs;
  const uint32_t* fl = (const uint32_t*)fills;
  for (int w = 0; w < W; ++w) {
    p.in[w] = ins[w];
    p.out[w] = outs[w];
    p.fill[w] = fl[w];
  }
  exchange_kernel<<<(unsigned)(B * PT_K), PT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const int*)counts, B, W, p);
  return (int)cudaGetLastError();
}

// The geometry compiled in: S, K, CAP and the most words per launch.
void pt_exchange_geometry(int* out) {
  out[0] = PT_S;
  out[1] = PT_K;
  out[2] = PT_CAP;
  out[3] = PT_MAX_WORDS;
}

const char* pt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}
