// Shared by the four multi-leaf kernels (masked_sgd.cu, score_mask.cu,
// mask_apply.cu, weighted_sum.cu); the first three also share its block plan
// (kThreads, kPerThread, plan_blocks), weighted_sum.cu has its own.
//
// A "leaf table" lets one launch cover every tensor of a parameter tree: the
// host packs the leaves' pointers and sizes into a struct passed by value as a
// kernel parameter (no device-side table, no host-to-device copy), and gives
// each leaf a contiguous range of blocks. A block finds its leaf by scanning
// `block_start`, which has at most kMaxLeaves + 1 entries.
#pragma once

#include <cuda_runtime.h>

constexpr int kMaxLeaves = 32;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kPerBlock = kThreads * kPerThread;

__device__ __forceinline__ int find_leaf(const int* block_start, int n_leaves,
                                         int block) {
  int leaf = 0;
  while (leaf + 1 < n_leaves && block >= block_start[leaf + 1]) ++leaf;
  return leaf;
}

// Fills block_start[0..count] for leaves of sizes n[0..count); returns the
// total number of blocks.
inline int plan_blocks(const long long* n, int count, int* block_start) {
  int blocks = 0;
  for (int i = 0; i < count; ++i) {
    block_start[i] = blocks;
    blocks += static_cast<int>((n[i] + kPerBlock - 1) / kPerBlock);
  }
  block_start[count] = blocks;
  return blocks;
}
