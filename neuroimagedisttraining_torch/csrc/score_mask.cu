// SNIP mask build: mask = (score / norm >= threshold) as f32 {0, 1}, over
// every kernel leaf of a score tree, in one launch.
//
// Replaces: neuroimagedisttraining_tpu/ops/pallas_kernels.py
//   fused_score_mask_leaf (_score_mask_kernel), called per kernel leaf by
//   ops/sparsity.py::mask_from_scores.
//
// The division is __fdiv_rn (IEEE, round to nearest), the same single
// rounding as the reference and the plain PyTorch version, so the masks agree
// bit for bit. norm and threshold are read from device memory: both are
// results of earlier device work (a sum and the threshold search), so the
// host never waits for them.
//
// Bound: device memory, 4 bytes read and 4 written per element; the seven
// kernel leaves of AlexNet3DS2D hold 2,573,888 elements, ~20.6 MB, ~6 us at
// 3.35 TB/s. Design: one launch over a by-value leaf table (leaf_table.cuh).
#include <cuda_runtime.h>

#include "leaf_table.cuh"

namespace {

struct MaskTable {
  const float* s[kMaxLeaves];
  float* out[kMaxLeaves];
  long long n[kMaxLeaves];
  int block_start[kMaxLeaves + 1];
  int n_leaves;
};

__global__ void __launch_bounds__(kThreads)
    score_mask_kernel(const MaskTable t, const float* __restrict__ norm_ptr,
                      const float* __restrict__ thr_ptr) {
  const int leaf = find_leaf(t.block_start, t.n_leaves, blockIdx.x);
  const long long n = t.n[leaf];
  const float* __restrict__ s = t.s[leaf];
  float* __restrict__ out = t.out[leaf];
  const float norm = *norm_ptr;
  const float thr = *thr_ptr;
  const long long base =
      static_cast<long long>(blockIdx.x - t.block_start[leaf]) * kPerBlock +
      threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long j = base + static_cast<long long>(i) * kThreads;
    if (j < n) out[j] = __fdiv_rn(s[j], norm) >= thr ? 1.0f : 0.0f;
  }
}

}  // namespace

// One launch over count <= kMaxLeaves leaves. norm and thr point at one f32
// each on the device. Returns cudaGetLastError() after the launch.
extern "C" int nidt_score_mask(int count, void** s, void** out,
                               const long long* n, const void* norm,
                               const void* thr, void* stream) {
  if (count < 1 || count > kMaxLeaves) return cudaErrorInvalidValue;
  MaskTable t;
  for (int i = 0; i < count; ++i) {
    t.s[i] = static_cast<const float*>(s[i]);
    t.out[i] = static_cast<float*>(out[i]);
    t.n[i] = n[i];
  }
  t.n_leaves = count;
  const int blocks = plan_blocks(t.n, count, t.block_start);
  if (blocks > 0) {
    score_mask_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        t, static_cast<const float*>(norm), static_cast<const float*>(thr));
  }
  return static_cast<int>(cudaGetLastError());
}
