// Mask projection out = p * mask over every leaf of a parameter tree, in one
// launch, out of place.
//
// Replaces: neuroimagedisttraining_tpu/ops/pallas_kernels.py
//   fused_mask_apply_leaf (_mask_apply_kernel), driven per leaf by
//   fused_mask_apply. On the training path it is the SalientGrads re-mask of
//   the global model after an agg_impl="topk" aggregate
//   (algorithms/salientgrads.py), once per round.
//
// One __fmul_rn per element: the plain PyTorch version (p * m) and the
// reference both round the one product once, so all three agree bit for bit.
//
// Bound: device memory. Each element reads p and mask and writes out (12
// bytes of f32); AlexNet3DS2D's 24 leaves hold 2,576,065 elements, 30.9 MB,
// ~9.2 us at 3.35 TB/s. Layout and design: each leaf is a flat contiguous f32
// buffer; the leaves' pointers travel in a by-value kernel parameter
// (leaf_table.cuh), so one launch covers all 24 leaves; each thread handles
// kPerThread elements strided by the block width, so neighbouring threads
// touch neighbouring addresses.
#include <cuda_runtime.h>

#include "leaf_table.cuh"

namespace {

struct ApplyTable {
  const float* p[kMaxLeaves];
  const float* k[kMaxLeaves];
  float* out[kMaxLeaves];
  long long n[kMaxLeaves];
  int block_start[kMaxLeaves + 1];
  int n_leaves;
};

__global__ void __launch_bounds__(kThreads)
    mask_apply_kernel(const ApplyTable t) {
  const int leaf = find_leaf(t.block_start, t.n_leaves, blockIdx.x);
  const long long n = t.n[leaf];
  const float* __restrict__ p = t.p[leaf];
  const float* __restrict__ k = t.k[leaf];
  float* __restrict__ out = t.out[leaf];
  const long long base =
      static_cast<long long>(blockIdx.x - t.block_start[leaf]) * kPerBlock +
      threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long j = base + static_cast<long long>(i) * kThreads;
    if (j < n) out[j] = __fmul_rn(p[j], k[j]);
  }
}

}  // namespace

// One launch over count <= kMaxLeaves leaves (the caller splits longer
// lists). Pointers are f32 device buffers of n[i] elements each. Returns
// cudaGetLastError() after the launch.
extern "C" int nidt_mask_apply(int count, void** p, void** k, void** out,
                               const long long* n, void* stream) {
  if (count < 1 || count > kMaxLeaves) return cudaErrorInvalidValue;
  ApplyTable t;
  for (int i = 0; i < count; ++i) {
    t.p[i] = static_cast<const float*>(p[i]);
    t.k[i] = static_cast<const float*>(k[i]);
    t.out[i] = static_cast<float*>(out[i]);
    t.n[i] = n[i];
  }
  t.n_leaves = count;
  const int blocks = plan_blocks(t.n, count, t.block_start);
  if (blocks > 0) {
    mask_apply_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(t);
  }
  return static_cast<int>(cudaGetLastError());
}
