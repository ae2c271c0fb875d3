// Exact k-th largest value of each row of a non-negative f32 matrix [C, n],
// by a radix select over the clamped bit pattern: three digit passes.
//
// Replaces: neuroimagedisttraining_tpu/ops/pallas_kernels.py threshold_topk
//   (_threshold_kernel), the backend of ops/topk_select.py::select_threshold;
//   on the training path it is the SNIP global threshold
//   (ops/sparsity.py::mask_from_scores) at [1, 2573888], and the top-k
//   wire's per-group selection (parallel/collectives.py) at [8, n_group].
//
// Non-negative IEEE floats order like their bit patterns read as integers.
// The key of an element is its bit pattern clamped to [0, 0x7F800000]:
// negative patterns (-0.0, negative values) count as 0 and NaN patterns as
// +inf, exactly as the plain search (ops/topk_select.py::exact_threshold,
// count(bits >= mid) over [0, 0x7F800001)) treats them. The k-th largest key
// is then the answer, bit for bit, on every input.
//
// Bound: one read of the row, 4 bytes per element; the full-width SNIP row
// (2,573,888 elements, 10.3 MB) takes ~3.1 us at 3.35 TB/s, the [8, 498036]
// top-k group ~4.8 us. There are no products: the work is bytes and counts.
//
// Design: the 31 significant key bits split into three digits, 11/10/10
// (2048, 1024 and 1024 bins: 8 KB of shared memory at most, and three
// launches, where 8-bit digits would take four and 16-bit ones a 256 KB
// histogram). Pass d, one launch with gridDim.y = rows:
//   * each block reads its share of the row with 16-byte loads (a scalar
//     head and tail where the row does not start on a 16-byte boundary or
//     n is not a multiple of 4; that lets [C, n] rows of any n and offset
//     views through) and counts the digit-d values of the elements whose
//     higher digits equal the prefix chosen so far into a shared-memory
//     histogram, one shared-memory atomic per element. On this card that
//     beat grouping a warp's lanes by bin first (__match_any_sync, one
//     atomic per distinct bin) on every row measured, the all-zero row
//     included, where all 32 lanes of a warp add to one address;
//   * the block adds its non-zero bins to the row's histogram for this
//     pass in device memory (atomics), fences, and takes a ticket;
//   * the block that takes the last ticket of its row scans the row's
//     histogram from the top bin down, picks the bin where the running
//     count reaches k_remaining, and writes the longer prefix and the new
//     k_remaining to the row's state; after the last pass it writes the
//     prefix as the f32 answer.
// The next launch reads that state once this one has ended: there is no
// grid-wide barrier. Passes 1 and 2 are launched as programmatic dependents
// (Hopper's griddepcontrol): each block of a pass lets the next pass launch
// as soon as it starts, and a block of the next pass zeroes its histogram
// and loads its first kPreload steps of the row (the input, complete before
// pass 0) while the pass before it flushes and scans; only then does it
// wait for that pass to end and read the state. That hides the launch gap
// and most of one read of the row behind each pass's serial tail.
// Every pass has its own histogram and ticket in the scratch, which the
// wrapper zeroes with one memset per search, so nothing is reset in between.
// The counts are integers, so the order of the atomics changes no bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kKeyMax = 0x7F800000u;  // the +inf bit pattern
constexpr int kPasses = 3;

// Per-row scratch, in 64-bit words: the three passes' histograms, their
// tickets, and the state (prefix, k_remaining) handed from pass to pass.
constexpr int kHist0 = 0, kHist1 = 2048, kHist2 = 3072;
constexpr int kTickets = 4096;
constexpr int kState = kTickets + kPasses;
constexpr int kScratch = kState + 2;
// Steps of the row each thread loads before the previous pass has ended:
// the wrapper's block count gives most rows at most this many.
constexpr int kPreload = 4;

__device__ __forceinline__ unsigned clamp_key(int bits) {
  return bits < 0 ? 0u : min(static_cast<unsigned>(bits), kKeyMax);
}

// Counts one element into `hist`: its digit at kShift, if the bits above
// the digit equal `prefix`.
template <int kBits, int kShift>
__device__ __forceinline__ void count_key(unsigned* hist, int bits,
                                          bool valid, unsigned prefix) {
  const unsigned key = clamp_key(bits);
  if (valid && (key >> (kShift + kBits)) == prefix) {
    atomicAdd(hist + ((key >> kShift) & ((1u << kBits) - 1u)), 1u);
  }
}

// Programmatic dependent launch (sm_90): the next pass may start once every
// block of this one has called let_next_pass_start(); its
// wait_for_previous_pass() returns when this grid has finished and its
// writes are visible. Without the launch attribute both are no-ops.
__device__ __forceinline__ void let_next_pass_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous_pass() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <int kBits, int kShift>
__device__ __forceinline__ void count4(unsigned* hist, int4 q, bool valid,
                                       unsigned prefix) {
  count_key<kBits, kShift>(hist, q.x, valid, prefix);
  count_key<kBits, kShift>(hist, q.y, valid, prefix);
  count_key<kBits, kShift>(hist, q.z, valid, prefix);
  count_key<kBits, kShift>(hist, q.w, valid, prefix);
}

template <int kBits, int kShift, int kPass>
__global__ void __launch_bounds__(kThreads)
    radix_pass_kernel(const float* __restrict__ av, long long n, long long k,
                      unsigned long long* __restrict__ scratch,
                      float* __restrict__ out) {
  constexpr int kBins = 1 << kBits;
  constexpr int kHist = kPass == 0 ? kHist0 : (kPass == 1 ? kHist1 : kHist2);
  constexpr int kPerThread = kBins / kThreads;  // bins each thread scans
  __shared__ unsigned hist[kBins];
  __shared__ unsigned long long warp_sums[kThreads / 32];
  __shared__ int last;

  let_next_pass_start();
  const int row = blockIdx.y;
  unsigned long long* rs = scratch + static_cast<long long>(row) * kScratch;
  unsigned long long* ghist = rs + kHist;
  for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0u;

  // the row: a scalar head up to the first 16-byte boundary, int4 vectors,
  // a scalar tail. A warp reads 64 contiguous vectors per step, two per
  // lane. The input is complete before the first pass starts, so the first
  // kPreload steps are loaded before waiting for the previous pass.
  const float* row_ptr = av + static_cast<long long>(row) * n;
  const long long head = min(
      static_cast<long long>(
          ((16u - (reinterpret_cast<uintptr_t>(row_ptr) & 15u)) & 15u) >> 2),
      n);
  const long long nvec = (n - head) >> 2;
  const int4* __restrict__ vec =
      reinterpret_cast<const int4*>(row_ptr + head);
  const int lane = threadIdx.x & 31;
  const long long first =
      ((static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5) *
          64 + lane;
  const long long step = static_cast<long long>(gridDim.x) * kThreads * 2;
  int4 pre[kPreload][2];
#pragma unroll
  for (int i = 0; i < kPreload; ++i) {
    const long long v = first + i * step;
    pre[i][0] = v < nvec ? __ldg(vec + v) : make_int4(0, 0, 0, 0);
    pre[i][1] = v + 32 < nvec ? __ldg(vec + v + 32) : make_int4(0, 0, 0, 0);
  }
  // the head (threads [0, head)) and the tail (the next (n - head) & 3)
  const int t = threadIdx.x;
  const bool edge = blockIdx.x == 0 && t < head + ((n - head) & 3);
  const int edge_bits =
      edge ? reinterpret_cast<const int*>(
                 row_ptr)[t < head ? t : head + 4 * nvec + (t - head)]
           : 0;

  wait_for_previous_pass();
  const unsigned prefix =
      kPass == 0 ? 0u : static_cast<unsigned>(__ldcg(rs + kState));
  const unsigned long long k_rem =
      kPass == 0 ? static_cast<unsigned long long>(k) : __ldcg(rs + kState + 1);
  __syncthreads();  // the histogram is zeroed
#pragma unroll
  for (int i = 0; i < kPreload; ++i) {
    const long long v = first + i * step;
    count4<kBits, kShift>(hist, pre[i][0], v < nvec, prefix);
    count4<kBits, kShift>(hist, pre[i][1], v + 32 < nvec, prefix);
  }
  for (long long v = first + kPreload * step; v < nvec; v += step) {
    const bool ok1 = v + 32 < nvec;
    const int4 a = __ldg(vec + v);
    const int4 b = ok1 ? __ldg(vec + v + 32) : make_int4(0, 0, 0, 0);
    count4<kBits, kShift>(hist, a, true, prefix);
    count4<kBits, kShift>(hist, b, ok1, prefix);
  }
  count_key<kBits, kShift>(hist, edge_bits, edge, prefix);
  __syncthreads();

  for (int i = threadIdx.x; i < kBins; i += kThreads) {
    const unsigned c = hist[i];
    if (c != 0u) atomicAdd(ghist + i, static_cast<unsigned long long>(c));
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(rs + kTickets + kPass, 1ull) == gridDim.x - 1u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The row's last block: thread t holds bins [hi - kPerThread, hi) with
  // hi = kBins - t * kPerThread, so thread 0 holds the top bins. An
  // inclusive scan over the threads gives each the count at and above its
  // bins; the one where it first reaches k_rem holds the chosen bin.
  const int hi = kBins - threadIdx.x * kPerThread;
  unsigned long long h[kPerThread], mine = 0;  // h[i]: bin hi - 1 - i
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    h[i] = __ldcg(ghist + hi - 1 - i);
    mine += h[i];
  }
  unsigned long long incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const int warp_in_block = threadIdx.x >> 5;
  if (lane == 31) warp_sums[warp_in_block] = incl;
  __syncthreads();
  for (int i = 0; i < warp_in_block; ++i) incl += warp_sums[i];
  const unsigned long long above = incl - mine;  // counts above my bins
  if (above < k_rem && incl >= k_rem) {
    unsigned long long acc = above;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (acc + h[i] >= k_rem) {
        const unsigned next =
            (prefix << kBits) | static_cast<unsigned>(hi - 1 - i);
        rs[kState] = next;
        rs[kState + 1] = k_rem - acc;
        if (kPass == kPasses - 1) out[row] = __uint_as_float(next);
        break;
      }
      acc += h[i];
    }
  }
}

}  // namespace

// Scratch the search needs per row, in 64-bit words.
extern "C" int nidt_threshold_scratch() { return kScratch; }

// av: [rows, n] f32 (non-negative) on the device; scratch: rows *
// nidt_threshold_scratch() zeroed 64-bit words; out: [rows] f32.
// 1 <= k <= n. Issues the three digit passes on `stream`, `blocks` blocks
// per row; returns the first launch error, else cudaGetLastError().
extern "C" int nidt_threshold(const void* av, long long rows, long long n,
                              long long k, void* scratch, void* out,
                              int blocks, void* stream) {
  if (rows < 1 || rows > 65535 || n < 1 || k < 1 || k > n || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, static_cast<unsigned>(rows));
  const float* x = static_cast<const float*>(av);
  auto* sc = static_cast<unsigned long long*>(scratch);
  float* o = static_cast<float*>(out);
  radix_pass_kernel<11, 20, 0><<<grid, kThreads, 0, s>>>(x, n, k, sc, o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // passes 1 and 2 may start while the pass before them ends
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, radix_pass_kernel<10, 10, 1>, x, n, k, sc,
                           o);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, radix_pass_kernel<10, 0, 2>, x, n, k, sc, o);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
