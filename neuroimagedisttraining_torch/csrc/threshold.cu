// Exact k-th largest value of each row of a non-negative f32 matrix [C, n],
// by a 31-pass binary search over the int32 bit patterns.
//
// Replaces: neuroimagedisttraining_tpu/ops/pallas_kernels.py threshold_topk
//   (_threshold_kernel), the backend of ops/topk_select.py::select_threshold;
//   on the training path it is the SNIP global threshold
//   (ops/sparsity.py::mask_from_scores).
//
// Non-negative IEEE floats order like their bit patterns read as integers, so
// the k-th largest value is the largest bit pattern b with
// count(bits >= b) >= k. Each pass halves [lo, hi) with mid = lo + (hi-lo)/2
// and keeps the half whose count still reaches k. After 31 passes the
// interval is one wide and lo is that unique integer, whatever order the
// counts were summed in: the result equals the plain search
// (ops/topk_select.py::exact_threshold) bit for bit.
//
// The reference kernel keeps a row resident in TPU VMEM and caps it at
// THRESHOLD_MAX_N = 1 << 20 elements; the full-width SNIP row (2,573,888)
// exceeded that, so on the TPU this search never ran at full width. Here
// there is no cap: pass 0 reads the row from device memory, and the later
// passes find the row (10.3 MB at full width) in the 50 MB L2.
//
// Bound: one read of the row (4 bytes per element) plus 31 compare-and-count
// passes; by bytes, 2,573,888 elements are ~10.3 MB, ~3 us at 3.35 TB/s.
//
// Design: one launch per pass, gridDim.y = rows. Passes run in stream order,
// so pass i's blocks can read every earlier pass's total: each block replays
// the earlier decisions from counts[row][0..i) to rebuild lo and hi (a few
// integer ops), counts its slice of the row, reduces in the block and adds
// one atomic to counts[row][i]. A last one-block launch replays all 31
// decisions and writes the threshold. No state but the count array, no
// grid-wide barrier.
#include <cuda_runtime.h>

namespace {

constexpr int kIters = 31;           // ceil(log2(kBitsHi))
constexpr int kBitsHi = 0x7F800001;  // one past the +inf bit pattern
constexpr int kCountThreads = 256;

__device__ __forceinline__ int replay(const int* counts, int passes, int k,
                                      int* hi_out) {
  int lo = 0, hi = kBitsHi;
  for (int i = 0; i < passes; ++i) {
    const int mid = lo + (hi - lo) / 2;
    if (counts[i] >= k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  *hi_out = hi;
  return lo;
}

__global__ void __launch_bounds__(kCountThreads)
    threshold_count_kernel(const int* __restrict__ bits, long long n, int k,
                           int pass, int* counts) {
  const int row = blockIdx.y;
  int* row_counts = counts + static_cast<long long>(row) * kIters;
  int hi;
  const int lo = replay(row_counts, pass, k, &hi);
  const int mid = lo + (hi - lo) / 2;
  const int* __restrict__ row_bits = bits + static_cast<long long>(row) * n;

  int local = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < n; j += stride) {
    local += row_bits[j] >= mid;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    local += __shfl_down_sync(0xffffffffu, local, off);
  }
  __shared__ int warp_sums[kCountThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = local;
  __syncthreads();
  if (warp == 0) {
    local = lane < kCountThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      local += __shfl_down_sync(0xffffffffu, local, off);
    }
    if (lane == 0 && local != 0) atomicAdd(row_counts + pass, local);
  }
}

__global__ void threshold_finish_kernel(const int* __restrict__ counts,
                                        int rows, int k,
                                        float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  int hi;
  const int lo =
      replay(counts + static_cast<long long>(row) * kIters, kIters, k, &hi);
  out[row] = __int_as_float(lo);
}

}  // namespace

// av: [rows, n] f32 (non-negative) on the device; counts: int32 scratch of
// rows * 31; out: [rows] f32. 1 <= k <= n. Issues a memset, 31 count passes
// and one finishing launch on `stream`; returns cudaGetLastError().
extern "C" int nidt_threshold(const void* av, long long rows, long long n,
                              int k, void* counts, void* out, int blocks,
                              void* stream) {
  if (rows < 1 || rows > 65535 || n < 1 || k < 1 || k > n || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* cnt = static_cast<int*>(counts);
  cudaError_t err = cudaMemsetAsync(
      cnt, 0, static_cast<size_t>(rows) * kIters * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks, static_cast<unsigned>(rows));
  for (int pass = 0; pass < kIters; ++pass) {
    threshold_count_kernel<<<grid, kCountThreads, 0, s>>>(
        static_cast<const int*>(av), n, k, pass, cnt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int r = static_cast<int>(rows);
  threshold_finish_kernel<<<(r + 127) / 128, 128, 0, s>>>(
      cnt, r, k, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
