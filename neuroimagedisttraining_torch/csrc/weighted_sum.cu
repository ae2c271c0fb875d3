// Weighted sum over a leading client axis, out[j] = sum_c w[c] * x[c, j], for
// every leaf of a [C, ...]-stacked parameter tree, in one launch.
//
// Replaces: neuroimagedisttraining_tpu/ops/pallas_kernels.py
//   fused_weighted_sum_leaf (_wsum_kernel), driven per leaf by
//   fused_weighted_sum. The JAX package calls it from no product path (only
//   from its tests); the port contracts every f32 and bf16 aggregate through
//   it: the dense one over the parameter tree, the bucketed wires over one
//   [C, nb * b] bucket tensor (parallel/collectives.py _reduce_mat).
//
// Each output value is owned by one thread, which walks the clients in
// static order from acc = 0: acc = __fadd_rn(acc, __fmul_rn(w[c], x[c, j])),
// as _wsum_kernel unrolls it. The explicit intrinsics keep nvcc from
// contracting the pair into a fused multiply-add, so the plain PyTorch
// version (one torch mul, then one add, per client: core/state.py
// weighted_sum) agrees bit for bit, and no TF32 setting can reach it.
//
// Bound: device memory. Each output reads C values and writes one (4 * (C+1)
// bytes of f32); at C = 8 over AlexNet3DS2D's 2,576,065 values that is
// 82.4 MB read + 10.3 MB written, ~27.7 us at 3.35 TB/s. Layout and design:
// leaf i is a contiguous [C, n_i] f32 buffer (client-major) and its output a
// contiguous [n_i] buffer; the pointers travel in a by-value kernel parameter
// (leaf_table.cuh); the weights stay in device memory (read once per thread,
// cached), so the host never waits for them. Per client, neighbouring
// threads read neighbouring addresses.
#include <cuda_runtime.h>

#include "leaf_table.cuh"

namespace {

struct SumTable {
  const float* x[kMaxLeaves];
  float* out[kMaxLeaves];
  long long n[kMaxLeaves];
  int block_start[kMaxLeaves + 1];
  int n_leaves;
};

__global__ void __launch_bounds__(kThreads)
    weighted_sum_kernel(const SumTable t, const float* __restrict__ w,
                        int clients) {
  const int leaf = find_leaf(t.block_start, t.n_leaves, blockIdx.x);
  const long long n = t.n[leaf];
  const float* __restrict__ x = t.x[leaf];
  float* __restrict__ out = t.out[leaf];
  const long long base =
      static_cast<long long>(blockIdx.x - t.block_start[leaf]) * kPerBlock +
      threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long j = base + static_cast<long long>(i) * kThreads;
    if (j < n) {
      float acc = 0.0f;
      for (int c = 0; c < clients; ++c) {
        acc = __fadd_rn(acc, __fmul_rn(w[c], x[c * n + j]));
      }
      out[j] = acc;
    }
  }
}

}  // namespace

// One launch over count <= kMaxLeaves leaves. x[i] points at a [clients,
// n[i]] f32 device buffer, out[i] at [n[i]]; w at [clients] f32 on the
// device. Returns cudaGetLastError() after the launch.
extern "C" int nidt_weighted_sum(int count, void** x, void** out,
                                 const long long* n, const void* w,
                                 int clients, void* stream) {
  if (count < 1 || count > kMaxLeaves || clients < 1) {
    return cudaErrorInvalidValue;
  }
  SumTable t;
  for (int i = 0; i < count; ++i) {
    t.x[i] = static_cast<const float*>(x[i]);
    t.out[i] = static_cast<float*>(out[i]);
    t.n[i] = n[i];
  }
  t.n_leaves = count;
  const int blocks = plan_blocks(t.n, count, t.block_start);
  if (blocks > 0) {
    weighted_sum_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        t, static_cast<const float*>(w), clients);
  }
  return static_cast<int>(cudaGetLastError());
}
