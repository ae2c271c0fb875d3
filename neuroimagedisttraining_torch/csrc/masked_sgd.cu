// Masked SGD with momentum and weight decay over every leaf of a parameter
// tree, in one launch.
//
// Replaces: neuroimagedisttraining_tpu/ops/pallas_kernels.py
//   fused_masked_sgd_leaf (_masked_sgd_kernel), driven per leaf by
//   fused_masked_sgd_step.
//
// Per element, in the order the reference computes it:
//   g' = g (* mask when mask_grads) + wd * p
//   m' = momentum * m + g'
//   p' = p - lr * m'           (then p' *= mask unless mask_grads)
// The three multiply-adds are explicit __fmaf_rn: the reference, lowered by
// XLA, contracts each of them into one correctly rounded fused multiply-add,
// and the plain PyTorch version (ops/kernels.py) computes the same single
// rounding, so kernel, plain version and reference agree bit for bit. The mask
// products are __fmul_rn so nvcc cannot contract them into anything else.
//
// Bound: device memory. Each element reads p, m, g, mask and writes p', m'
// (24 bytes of f32); AlexNet3DS2D's 24 leaves hold ~2.6M elements, ~62 MB,
// ~18 us at 3.35 TB/s. Design: p and m are updated in place; the leaves'
// pointers travel in a by-value kernel parameter (leaf_table.cuh), so one
// launch per optimizer step covers all leaves instead of one per leaf; each
// thread handles kPerThread elements strided by the block width, so
// neighbouring threads touch neighbouring addresses.
//
// The learning rate comes by value (nidt_masked_sgd) or from a 0-d f32
// device buffer (nidt_masked_sgd_lr_ptr): a CUDA graph freezes the
// arguments of the launches it captures, so a round replayed from a graph
// reads its decayed rate from the buffer the host rewrites before each
// replay. Both entries run the same kernel on the same f32 value.
#include <cuda_runtime.h>

#include "leaf_table.cuh"

namespace {

struct SgdTable {
  float* p[kMaxLeaves];
  float* m[kMaxLeaves];
  const float* g[kMaxLeaves];
  const float* k[kMaxLeaves];
  long long n[kMaxLeaves];
  int block_start[kMaxLeaves + 1];
  int n_leaves;
};

__global__ void __launch_bounds__(kThreads)
    masked_sgd_kernel(const SgdTable t, const float* __restrict__ lr_ptr,
                      float lr_value, float momentum, float wd,
                      int mask_grads) {
  const float lr = lr_ptr != nullptr ? __ldg(lr_ptr) : lr_value;
  const int leaf = find_leaf(t.block_start, t.n_leaves, blockIdx.x);
  const long long n = t.n[leaf];
  float* __restrict__ p = t.p[leaf];
  float* __restrict__ m = t.m[leaf];
  const float* __restrict__ g = t.g[leaf];
  const float* __restrict__ k = t.k[leaf];
  const long long base =
      static_cast<long long>(blockIdx.x - t.block_start[leaf]) * kPerBlock +
      threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long j = base + static_cast<long long>(i) * kThreads;
    if (j < n) {
      const float pj = p[j];
      const float kj = k[j];
      float gj = g[j];
      if (mask_grads) gj = __fmul_rn(gj, kj);
      gj = __fmaf_rn(wd, pj, gj);
      const float mj = __fmaf_rn(momentum, m[j], gj);
      float pn = __fmaf_rn(-lr, mj, pj);
      if (!mask_grads) pn = __fmul_rn(pn, kj);
      p[j] = pn;
      m[j] = mj;
    }
  }
}

int launch(int count, void** p, void** m, void** g, void** k,
           const long long* n, const float* lr_ptr, float lr, float momentum,
           float wd, int mask_grads, void* stream) {
  if (count < 1 || count > kMaxLeaves) return cudaErrorInvalidValue;
  SgdTable t;
  for (int i = 0; i < count; ++i) {
    t.p[i] = static_cast<float*>(p[i]);
    t.m[i] = static_cast<float*>(m[i]);
    t.g[i] = static_cast<const float*>(g[i]);
    t.k[i] = static_cast<const float*>(k[i]);
    t.n[i] = n[i];
  }
  t.n_leaves = count;
  const int blocks = plan_blocks(t.n, count, t.block_start);
  if (blocks > 0) {
    masked_sgd_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        t, lr_ptr, lr, momentum, wd, mask_grads);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over count <= kMaxLeaves leaves (the caller splits longer
// lists). Pointers are f32 device buffers; p and m are updated in place.
// Returns cudaGetLastError() after the launch.
extern "C" int nidt_masked_sgd(int count, void** p, void** m, void** g,
                               void** k, const long long* n, float lr,
                               float momentum, float wd, int mask_grads,
                               void* stream) {
  return launch(count, p, m, g, k, n, nullptr, lr, momentum, wd, mask_grads,
                stream);
}

// The same launch with the learning rate read on the card from lr, a 0-d
// f32 device buffer.
extern "C" int nidt_masked_sgd_lr_ptr(int count, void** p, void** m,
                                      void** g, void** k, const long long* n,
                                      const void* lr, float momentum,
                                      float wd, int mask_grads,
                                      void* stream) {
  if (lr == nullptr) return cudaErrorInvalidValue;
  return launch(count, p, m, g, k, n, static_cast<const float*>(lr), 0.0f,
                momentum, wd, mask_grads, stream);
}
