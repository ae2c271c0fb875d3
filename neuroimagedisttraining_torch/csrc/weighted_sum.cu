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
// Each output value walks the clients in static order from acc = 0:
// acc = __fadd_rn(acc, __fmul_rn(w[c], x[c, j])), as _wsum_kernel unrolls
// it. The explicit intrinsics keep nvcc from contracting the pair into a
// fused multiply-add, so the plain PyTorch version (one torch mul, then one
// add, per client: core/state.py weighted_sum) agrees bit for bit, and no
// TF32 setting can reach it.
//
// Bound: device memory. Each output reads C values and writes one (4 * (C+1)
// bytes of f32); at C = 8 over AlexNet3DS2D's 2,576,065 values that is
// 82.4 MB read + 10.3 MB written, ~27.7 us at 3.35 TB/s.
//
// Design: leaf i is a contiguous [C, n_i] f32 buffer (client-major) and its
// output a contiguous [n_i] buffer; the pointers travel in a by-value kernel
// parameter (leaf_table.cuh's find_leaf). To keep enough bytes in flight to
// cover the latency of device memory:
//   * the kernel is a template on the client count (1..16), so the weights
//     sit in registers, loaded once per thread, and the client chain is
//     fully unrolled;
//   * a thread owns two float4 column groups (8 outputs) and issues all of
//     their C loads, C x 32 bytes, before the first add; the inputs, read
//     once, are loaded with the streaming hint (__ldcs), the outputs stored
//     plainly (the round reads them next);
//   * a leaf takes the 16-byte path when its base is 16-byte aligned and
//     n % 4 == 0 (then every client row is aligned), else a scalar path
//     with the same 8 outputs and C x 8 loads per thread, in the same
//     launch. The wrapper decides per leaf (ops/kernels.py
//     weighted_sum_vector_leaf) and passes the choice in the table.
// Its block plan (2048 outputs per block) is its own: leaf_table.cuh's
// kThreads / kPerThread stay those of the elementwise kernels.
// More than 16 clients run as chunks of 16 in client order, each launch
// after the first resuming every chain from the partial sum it left in
// `out` (stored in f32, so the bits are those of one unbroken chain).
#include <cuda_runtime.h>

#include "leaf_table.cuh"

namespace {

constexpr int kSumThreads = 256;
constexpr int kVecPerThread = 2;                            // float4 groups
constexpr int kOutPerThread = 4 * kVecPerThread;            // 8 outputs
constexpr int kTile = kSumThreads * kOutPerThread;          // per block
constexpr int kMaxChunk = 16;                               // clients

struct SumTable {
  const float* x[kMaxLeaves];
  float* out[kMaxLeaves];
  long long n[kMaxLeaves];
  int vec[kMaxLeaves];
  int block_start[kMaxLeaves + 1];
  int n_leaves;
};

__device__ __forceinline__ float4 chain4(float4 acc, float w, float4 x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, x.w));
  return acc;
}

// Clients [c0, c0 + C) of every leaf; `resume` continues from `out`.
template <int C>
__global__ void __launch_bounds__(kSumThreads)
    weighted_sum_kernel(const SumTable t, const float* __restrict__ w,
                        int c0, int resume) {
  const int leaf = find_leaf(t.block_start, t.n_leaves, blockIdx.x);
  const long long n = t.n[leaf];
  const float* __restrict__ x = t.x[leaf] + static_cast<long long>(c0) * n;
  float* __restrict__ out = t.out[leaf];
  const long long tile =
      static_cast<long long>(blockIdx.x - t.block_start[leaf]) * kTile;
  float wr[C];
#pragma unroll
  for (int c = 0; c < C; ++c) wr[c] = __ldg(w + c0 + c);

  if (t.vec[leaf]) {
    const long long n4 = n >> 2;
    const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
    float4* __restrict__ o4 = reinterpret_cast<float4*>(out);
    const long long j0 = (tile >> 2) + threadIdx.x;
    float4 v[kVecPerThread][C];
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      const long long j = j0 + u * kSumThreads;
      if (j < n4) {
#pragma unroll
        for (int c = 0; c < C; ++c) v[u][c] = __ldcs(x4 + c * n4 + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      const long long j = j0 + u * kSumThreads;
      if (j < n4) {
        float4 acc = resume ? o4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < C; ++c) acc = chain4(acc, wr[c], v[u][c]);
        o4[j] = acc;
      }
    }
  } else {
    const long long j0 = tile + threadIdx.x;
    float v[kOutPerThread][C];
#pragma unroll
    for (int u = 0; u < kOutPerThread; ++u) {
      const long long j = j0 + u * kSumThreads;
      if (j < n) {
#pragma unroll
        for (int c = 0; c < C; ++c) v[u][c] = __ldcs(x + c * n + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kOutPerThread; ++u) {
      const long long j = j0 + u * kSumThreads;
      if (j < n) {
        float acc = resume ? out[j] : 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc = __fadd_rn(acc, __fmul_rn(wr[c], v[u][c]));
        }
        out[j] = acc;
      }
    }
  }
}

using SumKernel = void (*)(const SumTable, const float*, int, int);
const SumKernel kKernels[kMaxChunk] = {
    weighted_sum_kernel<1>,  weighted_sum_kernel<2>,  weighted_sum_kernel<3>,
    weighted_sum_kernel<4>,  weighted_sum_kernel<5>,  weighted_sum_kernel<6>,
    weighted_sum_kernel<7>,  weighted_sum_kernel<8>,  weighted_sum_kernel<9>,
    weighted_sum_kernel<10>, weighted_sum_kernel<11>, weighted_sum_kernel<12>,
    weighted_sum_kernel<13>, weighted_sum_kernel<14>, weighted_sum_kernel<15>,
    weighted_sum_kernel<16>};

}  // namespace

// One call over count <= kMaxLeaves leaves. x[i] points at a [clients,
// n[i]] f32 device buffer, out[i] at [n[i]]; vec[i] != 0 sends leaf i down
// the 16-byte path (the caller guarantees both pointers 16-byte aligned and
// n[i] % 4 == 0); w at [clients] f32 on the device. One launch per
// 16 clients. Returns the first launch error, else cudaGetLastError().
extern "C" int nidt_weighted_sum(int count, void** x, void** out,
                                 const long long* n, const int* vec,
                                 const void* w, int clients, void* stream) {
  if (count < 1 || count > kMaxLeaves || clients < 1) {
    return cudaErrorInvalidValue;
  }
  SumTable t;
  int blocks = 0;
  for (int i = 0; i < count; ++i) {
    t.x[i] = static_cast<const float*>(x[i]);
    t.out[i] = static_cast<float*>(out[i]);
    t.n[i] = n[i];
    t.vec[i] = vec[i];
    t.block_start[i] = blocks;
    blocks += static_cast<int>((n[i] + kTile - 1) / kTile);
  }
  t.block_start[count] = blocks;
  t.n_leaves = count;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int c0 = 0; c0 < clients; c0 += kMaxChunk) {
    const int chunk = clients - c0 < kMaxChunk ? clients - c0 : kMaxChunk;
    kKernels[chunk - 1]<<<blocks, kSumThreads, 0, s>>>(
        t, static_cast<const float*>(w), c0, c0 > 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
