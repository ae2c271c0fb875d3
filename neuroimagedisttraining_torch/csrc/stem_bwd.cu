// The stem stage's backward through its max-pool and GroupNorm statistics, in
// one pass over the full-resolution conv output, with the stem bias's
// gradient (the per-channel sum of that cotangent) on request.
//
// Replaces: neuroimagedisttraining_tpu/ops/experimental/pallas_stem_bwd.py
//   pool_sum_sumsq's backward (_bwd_kernel). In the port it is also the main
//   path's: models/alexnet3d.py StemStage.backward runs it on every training
//   step and SNIP batch.
//
// The pool-first stem stage reads its conv output zs only through three
// reductions: the 3x3x3/s3 max-pool and the per-(sample, channel) sums
// S1 = sum(zs), S2 = sum(zs^2). Given their cotangents g_pooled, g_s1 and
// g_s2, each element of zs (B, D, H, W, F) gets
//   dzs = T((g_s1[b, f] + (2 g_s2[b, f]) * zs) + pool_term)
// with one rounding per multiply and per add (__fmul_rn, __fadd_rn, in f32;
// 2 g_s2 is exact), the output in zs's type T. pool_term is 0 outside every
// whole window and, inside window (b, pd, ph, pw, f), routes the window's
// g_pooled by one of two rules:
//   ties = first: all of it to the first position in (d, h, w) order where
//     zs == pooled, which is what torch's max-pool backward does (the port's
//     training path);
//   ties = split: g_pooled / count (__fdiv_rn) to every position where
//     zs == pooled, the reference kernel's contract (pool_sum_sumsq).
// A bf16 zs has exact ties in a few percent of its windows, so the two rules
// give different gradients there; the caller picks one. The plain PyTorch
// version (ops/kernels.py stem_bwd_plain) spells the same operations, so the
// two agree bit for bit.
// With a bias gradient asked for, dbias[f] = T(sum over (b, d, h, w) of the
// rounded dzs), accumulated in f64 in a fixed order: each thread over its
// slabs, the block's threads in order into one f64 partial per block and
// channel, then a second launch sums the partials in block order and rounds
// once. No atomics, so a run gives the same bits every time.
//
// Bound, at the main path's shapes (zs (8, 59, 71, 59, 64) bf16): device
// memory. zs is read and dzs written once (2 x 253.1 MB), pooled and
// g_pooled read once (2 x 8.5 MB): 523 MB, 0.156 ms at 3.35 TB/s; the ~4
// operations per element are far below the bytes. The bias gradient adds
// no bytes: it sums values the kernel already holds.
//
// Design. The kernel before this one gave each thread one 3x3x3 cell of 8
// channels and read it twice from device memory, once to find the
// maximum's ties and once to write dzs: on the H100 its first pass alone
// took 0.121 ms and its second alone 0.226 of its 0.340 (PERF.md, PR 7),
// so the second read came from device memory, not from L1. This one reads
// zs once:
// * The work unit is a slab: 3 d-planes x 3 h-rows x kWc w-positions x F
//   channels of one sample, kWc = 3 kWin so that no pool window straddles
//   two slabs; kWin = 512 / F windows (8 at F = 64: 27,648 bytes of bf16).
//   Slabs are ordered (b, cd, ch, w-chunk), w-chunk fastest, and block k
//   takes slabs k, k + grid, ... (a static assignment: the bias partial of
//   a block always sums the same slabs). One block per SM at bf16 (four
//   stages fill 119 KB of shared memory).
// * One producer thread (warp 8) keeps a ring of kStages slabs in flight:
//   a TMA box of zs's (F, W, H, D, B) tensor map, (F, kWc, 3, 3, 1), and,
//   where the slab holds whole windows, the matching boxes of pooled and
//   g_pooled, (F, kWin, 1, 1, 1), one mbarrier per stage counting the
//   bytes. F x sizeof(T) and every stride are multiples of 16 bytes and
//   every box starts at channel 0, so each box is aligned. Boxes past D, H
//   or W arrive as zeros.
// * Eight consumer warps: thread (j, c) owns window j of the slab for
//   channels 2c and 2c + 1 (a warp covers 128 contiguous bytes of a
//   position at F = 64, so its shared loads are conflict-free). It loads
//   its 27 positions from the stage into registers once, finds each
//   channel's first maximum or tie count in (d, h, w) order, computes dzs
//   from the same registers and writes it back in place, then fences the
//   async proxy and arrives on the stage's second mbarrier.
// * The producer stores each finished stage to dzs with one TMA store (TMA
//   clips the ragged edges) and reloads the stage of the slab before it
//   once every store but the newest has read its stage
//   (cp.async.bulk.wait_group.read 1), so it never waits on the store it
//   just issued.
// Device memory sees each byte of zs, pooled and g_pooled read once and
// dzs written once. What is left (PERF.md, PR 7): the loads alone run at
// the card's read rate, and the whole at about 90% of a plain
// device-to-device copy of the same 523 MB. Measured and not kept: stores
// straight from registers (1.6x slower), reloading the stage just stored
// (kDefer = 0), 3 or 5-7 stages, two slabs at a time (two consumer
// groups), slabs twice as wide, a register cap of two blocks per SM (2%
// faster in one build of this loop, 8% slower in another).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kStages = 4;  // ring depth, as far as shared memory allows
constexpr int kSmemMax = 232448;  // dynamic shared memory of a block
constexpr int kConsumers = 256;            // eight consumer warps
constexpr int kThreads = kConsumers + 32;  // and one producer warp
// after storing slab i the producer reloads the stage of slab i - kDefer,
// once the stores but the last kDefer have read their stages (0: the stage
// just stored, waiting for its own store)
constexpr int kDefer = 1;
constexpr int kMaxF = 64;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int round128(int n) {
  return (n + 127) / 128 * 128;
}

// Two channels of T: a bf16 pair (4 bytes) or an f32 pair (8 bytes).
template <typename T>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ float2 f(V v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ V make(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};
template <>
struct Pair<float> {
  using V = float2;
  static __device__ __forceinline__ float2 f(V v) { return v; }
  static __device__ __forceinline__ V make(float a, float b) {
    return make_float2(a, b);
  }
};

__device__ __forceinline__ float from_double(double v, float*) {
  return __double2float_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 from_double(double v,
                                                     __nv_bfloat16*) {
  return __double2bfloat16(v);
}

// The slab geometry at F channels of T.
template <typename T, int F>
struct Slab {
  static constexpr int kWin = 2 * kConsumers / F;  // windows per slab
  static constexpr int kWc = 3 * kWin;  // w-positions per slab
  static constexpr int kTpw = F / 2;    // threads per window
  static constexpr int kBytes = 9 * kWc * F * static_cast<int>(sizeof(T));
  static constexpr int kPoolBytes = kWin * F * static_cast<int>(sizeof(T));
  static constexpr int kPoolOff = round128(kBytes);
  static constexpr int kStageBytes = kPoolOff + 2 * round128(kPoolBytes);
  // the stages that fit: 4 of bf16, 3 of f32 at F = 64
  static constexpr int kRing =
      (kSmemMax - 128) / (kStageBytes + 16) < kStages
          ? (kSmemMax - 128) / (kStageBytes + 16)
          : kStages;
  static_assert(kDefer < kRing, "a stage is reloaded before its slab");
  // 128 bytes of slack to align the stages, the stages, 2 kRing mbarriers
  static constexpr int kSmem = 128 + kRing * kStageBytes + 16 * kRing;
};

struct Geometry {
  int PD, PH, PW, ncd, nch, nchunk, nslabs;
};

__host__ __device__ inline Geometry geometry(int B, int D, int H, int W,
                                             int kWin) {
  Geometry g;
  g.PD = D / 3;
  g.PH = H / 3;
  g.PW = W / 3;
  g.ncd = (D + 2) / 3;
  g.nch = (H + 2) / 3;
  g.nchunk = ((W + 2) / 3 + kWin - 1) / kWin;
  g.nslabs = B * g.ncd * g.nch * g.nchunk;
  return g;
}

struct SlabAt {
  int b, cd, ch, chunk;
};

__device__ __forceinline__ SlabAt slab_at(int slab, const Geometry& g) {
  SlabAt s;
  int rest = slab;
  s.chunk = rest % g.nchunk;
  rest /= g.nchunk;
  s.ch = rest % g.nch;
  rest /= g.nch;
  s.cd = rest % g.ncd;
  s.b = rest / g.ncd;
  return s;
}

// zmap, pmap, gmap, omap: zs, pooled, g_pooled and dzs as (F, W, H, D, B)
// tensor maps (pmap and gmap unused when no window is whole: has_pool = 0).
// partials: [gridDim.x, F] f64, or null for no bias gradient.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
    stem_bwd_kernel(const __grid_constant__ CUtensorMap zmap,
                    const __grid_constant__ CUtensorMap pmap,
                    const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap omap,
                    const float* __restrict__ gs1,
                    const float* __restrict__ gs2,
                    double* __restrict__ partials, int B, int D, int H, int W,
                    int split, int has_pool) {
  using S = Slab<T, F>;
  using P = Pair<T>;
  using V = typename P::V;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - smem_addr(smem_raw) % 128) % 128);
  const uint32_t stages = smem_addr(smem);
  const uint32_t full_bar = stages + S::kRing * S::kStageBytes;
  const uint32_t done_bar = full_bar + 8 * S::kRing;
  const Geometry g = geometry(B, D, H, W, S::kWin);
  const int nmine =
      g.nslabs > static_cast<int>(blockIdx.x)
          ? (g.nslabs - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
          : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kRing; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(done_bar + 8 * s, kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  double sum0 = 0.0, sum1 = 0.0;  // this thread's channels' dbias
  const int tid = threadIdx.x;
  if (tid >= kConsumers) {
    // the producer
    if (tid == kConsumers) {
      auto load = [&](int i) {
        const int s = i % S::kRing;
        const SlabAt at = slab_at(blockIdx.x + i * gridDim.x, g);
        const uint32_t dst = stages + s * S::kStageBytes;
        const bool pool = has_pool && at.cd < g.PD && at.ch < g.PH &&
                          at.chunk * S::kWin < g.PW;
        mbar_expect_tx(full_bar + 8 * s,
                       S::kBytes + (pool ? 2 * S::kPoolBytes : 0));
        tma_load_5d(dst, &zmap, full_bar + 8 * s, 0, at.chunk * S::kWc,
                    3 * at.ch, 3 * at.cd, at.b);
        if (pool) {
          tma_load_5d(dst + S::kPoolOff, &pmap, full_bar + 8 * s, 0,
                      at.chunk * S::kWin, at.ch, at.cd, at.b);
          tma_load_5d(dst + S::kPoolOff + round128(S::kPoolBytes), &gmap,
                      full_bar + 8 * s, 0, at.chunk * S::kWin, at.ch, at.cd,
                      at.b);
        }
      };
      for (int i = 0; i < S::kRing && i < nmine; ++i) {
        load(i);
      }
      for (int i = 0; i < nmine; ++i) {
        const int s = i % S::kRing;
        mbar_wait_or_trap(done_bar + 8 * s, (i / S::kRing) & 1);
        const SlabAt at = slab_at(blockIdx.x + i * gridDim.x, g);
        tma_store_5d(&omap, stages + s * S::kStageBytes, 0, at.chunk * S::kWc,
                     3 * at.ch, 3 * at.cd, at.b);
        bulk_commit();
        const int r = i - kDefer;  // the slab whose stage is reloaded
        if (r >= 0 && r + S::kRing < nmine) {
          bulk_wait_read<kDefer>();  // slab r's store has read its stage
          load(r + S::kRing);
        }
      }
      bulk_wait();
    }
    __syncwarp();
  } else {
    // the consumers: thread (j, c) owns window j, channels 2c and 2c + 1
    const int j = tid / S::kTpw, c = tid % S::kTpw;
    const bool active = j < S::kWin;
    const int lane = tid % 32;
    for (int i = 0; i < nmine; ++i) {
      const int s = i % S::kRing;
      const SlabAt at = slab_at(blockIdx.x + i * gridDim.x, g);
      unsigned char* st = smem + s * S::kStageBytes;
      V* zp = reinterpret_cast<V*>(st) + 3 * j * S::kTpw + c;
      const int cw = at.chunk * S::kWin + j;
      const bool full = at.cd < g.PD && at.ch < g.PH && cw < g.PW;
      mbar_wait_or_trap(full_bar + 8 * s, (i / S::kRing) & 1);
      V z[27];
      float2 m = make_float2(0.0f, 0.0f), gp = make_float2(0.0f, 0.0f);
      if (active) {
#pragma unroll
        for (int k = 0; k < 27; ++k) {
          z[k] = zp[((k / 9) * 3 + (k / 3) % 3) * S::kWc * S::kTpw +
                    (k % 3) * S::kTpw];
        }
        if (full) {
          const V* pp = reinterpret_cast<const V*>(st + S::kPoolOff) +
                        j * S::kTpw + c;
          m = P::f(pp[0]);
          gp = P::f(pp[round128(S::kPoolBytes) / sizeof(V)]);
        }
      }
      if (active) {
        const float a0 = gs1[at.b * F + 2 * c];
        const float a1 = gs1[at.b * F + 2 * c + 1];
        const float c20 = 2.0f * gs2[at.b * F + 2 * c];
        const float c21 = 2.0f * gs2[at.b * F + 2 * c + 1];
        int first0 = -1, first1 = -1, count0 = 0, count1 = 0;
        if (full) {
#pragma unroll
          for (int k = 0; k < 27; ++k) {
            const float2 v = P::f(z[k]);
            const bool e0 = v.x == m.x, e1 = v.y == m.y;
            count0 += e0 ? 1 : 0;
            count1 += e1 ? 1 : 0;
            first0 = (first0 < 0 && e0) ? k : first0;
            first1 = (first1 < 0 && e1) ? k : first1;
          }
          if (split) {
            gp.x = __fdiv_rn(gp.x, static_cast<float>(count0 > 1 ? count0
                                                                 : 1));
            gp.y = __fdiv_rn(gp.y, static_cast<float>(count1 > 1 ? count1
                                                                 : 1));
          }
        }
        const int d0 = 3 * at.cd, h0 = 3 * at.ch, w0 = 3 * cw;
#pragma unroll
        for (int k = 0; k < 27; ++k) {
          const float2 v = P::f(z[k]);
          const bool hit0 =
              full && (split ? v.x == m.x : k == first0);
          const bool hit1 =
              full && (split ? v.y == m.y : k == first1);
          const float r0 = __fadd_rn(__fadd_rn(a0, __fmul_rn(c20, v.x)),
                                     hit0 ? gp.x : 0.0f);
          const float r1 = __fadd_rn(__fadd_rn(a1, __fmul_rn(c21, v.y)),
                                     hit1 ? gp.y : 0.0f);
          const V o = P::make(r0, r1);
          zp[((k / 9) * 3 + (k / 3) % 3) * S::kWc * S::kTpw +
             (k % 3) * S::kTpw] = o;
          // the store clips what lies past the volume; the sum skips it
          const int d = d0 + k / 9, h = h0 + (k / 3) % 3, w = w0 + k % 3;
          if (partials != nullptr && d < D && h < H && w < W) {
            const float2 q = P::f(o);
            sum0 = __dadd_rn(sum0, static_cast<double>(q.x));
            sum1 = __dadd_rn(sum1, static_cast<double>(q.y));
          }
        }
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(done_bar + 8 * s);  // dzs is in the stage
      }
    }
  }
  if (partials == nullptr) {
    return;
  }
  // the block's partial: the windows' sums in window order, per channel
  __syncthreads();  // every stage drained: reuse stage 0
  double* red = reinterpret_cast<double*>(smem);
  if (tid < kConsumers && tid / S::kTpw < S::kWin) {
    const int j = tid / S::kTpw, c = tid % S::kTpw;
    red[j * F + 2 * c] = sum0;
    red[j * F + 2 * c + 1] = sum1;
  }
  __syncthreads();
  if (tid < F) {
    double acc = 0.0;
    for (int j = 0; j < S::kWin; ++j) {
      acc = __dadd_rn(acc, red[j * F + tid]);
    }
    partials[static_cast<long long>(blockIdx.x) * F + tid] = acc;
  }
}

// dbias[f] = T(sum over the blocks' partials[k, f], in block order).
template <typename T>
__global__ void stem_bwd_bias_kernel(const double* __restrict__ partials,
                                     T* __restrict__ dbias, int blocks,
                                     int F) {
  const int f = threadIdx.x;
  if (f >= F) {
    return;
  }
  double acc = 0.0;
  for (int k = 0; k < blocks; ++k) {
    acc = __dadd_rn(acc, partials[static_cast<long long>(k) * F + f]);
  }
  dbias[f] = from_double(acc, static_cast<T*>(nullptr));
}

// The persistent launch: slabs, dynamic shared memory, blocks per SM (what
// the shared memory and registers allow; found once per device) and the
// grid, min(slabs, that times the SMs).
struct Config {
  int grid, slabs, threads, smem, per_sm, stages;
};

template <typename T, int F>
cudaError_t config_of(int B, int D, int H, int W, Config* c) {
  using S = Slab<T, F>;
  static int per_sm[kMaxDevices];
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    return err;
  }
  if (dev >= kMaxDevices) {
    return cudaErrorInvalidDevice;
  }
  if (per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(stem_bwd_kernel<T, F>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kSmem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[dev], stem_bwd_kernel<T, F>, kThreads, S::kSmem);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) {
      per_sm[dev] = 0;
      return err;
    }
    if (per_sm[dev] < 1) {
      return cudaErrorInvalidConfiguration;
    }
  }
  c->slabs = geometry(B, D, H, W, S::kWin).nslabs;
  c->threads = kThreads;
  c->smem = S::kSmem;
  c->per_sm = per_sm[dev];
  c->stages = S::kRing;
  const int most = per_sm[dev] * sms[dev];
  c->grid = c->slabs < most ? c->slabs : most;
  return cudaSuccess;
}

// A (F, W, H, D, B) tensor map of a contiguous channels-last tensor of T,
// boxes of (F, bw, bh, bd, 1). Returns 0, a cudaError_t, or
// kTensorMapError + the CUresult.
template <typename T>
int tensor_map(const void* base, int B, int D, int H, int W, int F, int bw,
               int bh, int bd, CUtensorMap* map) {
  EncodeTiledFn encode = nullptr;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(F),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {e * F, e * F * W, e * F * W * H,
                                 e * F * W * H * D};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(F),
                             static_cast<cuuint32_t>(bw),
                             static_cast<cuuint32_t>(bh),
                             static_cast<cuuint32_t>(bd), 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(
      map,
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      5, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(res);
}

template <typename T, int F>
int launch(const void* zs, const void* pooled, const void* gpool,
           const void* gs1, const void* gs2, void* out, void* partials,
           void* dbias, int B, int D, int H, int W, int split,
           cudaStream_t stream) {
  using S = Slab<T, F>;
  Config c;
  cudaError_t err = config_of<T, F>(B, D, H, W, &c);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const bool has_pool = D >= 3 && H >= 3 && W >= 3;
  CUtensorMap zmap, pmap, gmap, omap;
  int rc = tensor_map<T>(zs, B, D, H, W, F, S::kWc, 3, 3, &zmap);
  if (rc == 0) {
    rc = tensor_map<T>(out, B, D, H, W, F, S::kWc, 3, 3, &omap);
  }
  if (rc == 0 && has_pool) {
    rc = tensor_map<T>(pooled, B, D / 3, H / 3, W / 3, F, S::kWin, 1, 1,
                       &pmap);
  }
  if (rc == 0 && has_pool) {
    rc = tensor_map<T>(gpool, B, D / 3, H / 3, W / 3, F, S::kWin, 1, 1,
                       &gmap);
  }
  if (rc != 0) {
    return rc;
  }
  if (!has_pool) {
    pmap = zmap;  // not read
    gmap = zmap;
  }
  stem_bwd_kernel<T, F><<<c.grid, kThreads, S::kSmem, stream>>>(
      zmap, pmap, gmap, omap, static_cast<const float*>(gs1), static_cast<const float*>(gs2),
      static_cast<double*>(partials), B, D, H, W, split, has_pool ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || partials == nullptr) {
    return static_cast<int>(err);
  }
  stem_bwd_bias_kernel<T><<<1, F, 0, stream>>>(
      static_cast<const double*>(partials), static_cast<T*>(dbias), c.grid,
      F);
  return static_cast<int>(cudaGetLastError());
}

// Calls fn.template operator()<T, F>() for the runtime F (a multiple of 8 up
// to kMaxF).
template <typename T, typename Fn>
int by_channels(int F, Fn fn) {
  switch (F) {
    case 8: return fn.template operator()<T, 8>();
    case 16: return fn.template operator()<T, 16>();
    case 24: return fn.template operator()<T, 24>();
    case 32: return fn.template operator()<T, 32>();
    case 40: return fn.template operator()<T, 40>();
    case 48: return fn.template operator()<T, 48>();
    case 56: return fn.template operator()<T, 56>();
    case 64: return fn.template operator()<T, 64>();
    default: return cudaErrorInvalidValue;
  }
}

bool valid(int B, int D, int H, int W, int F) {
  return B >= 1 && D >= 1 && H >= 1 && W >= 1 && F >= 8 && F <= kMaxF &&
         F % 8 == 0;
}

struct ConfigFn {
  int B, D, H, W;
  Config* c;
  template <typename T, int F>
  int operator()() const {
    return static_cast<int>(config_of<T, F>(B, D, H, W, c));
  }
};

struct LaunchFn {
  const void *zs, *pooled, *gpool, *gs1, *gs2;
  void *out, *partials, *dbias;
  int B, D, H, W, split;
  cudaStream_t stream;
  template <typename T, int F>
  int operator()() const {
    return launch<T, F>(zs, pooled, gpool, gs1, gs2, out, partials, dbias, B,
                        D, H, W, split, stream);
  }
};

}  // namespace

// The persistent launch at these shapes on the current device: out =
// {grid, slabs, threads, dynamic shared memory bytes, blocks per SM,
// stages}. Returns a cudaError_t.
extern "C" int nidt_stem_bwd_config(int B, int D, int H, int W, int F,
                                    int bf16, int* out) {
  if (!valid(B, D, H, W, F)) {
    return cudaErrorInvalidValue;
  }
  Config c{};
  const ConfigFn fn{B, D, H, W, &c};
  const int rc = bf16 ? by_channels<__nv_bfloat16>(F, fn)
                      : by_channels<float>(F, fn);
  out[0] = c.grid;
  out[1] = c.slabs;
  out[2] = c.threads;
  out[3] = c.smem;
  out[4] = c.per_sm;
  out[5] = c.stages;
  return rc;
}

// zs (B, D, H, W, F), pooled and g_pooled (B, D/3, H/3, W/3, F), out like
// zs, all in T (bf16 when bf16 != 0, else f32); g_s1, g_s2 (B, F) f32; all
// contiguous and 16-byte aligned on the device. split != 0 splits tied
// cotangents evenly, 0 routes them to the first maximum. With partials
// ([grid, F] f64, grid from nidt_stem_bwd_config) and dbias ((F,) in T)
// non-null, also dbias = the per-channel sum of out. Returns the first CUDA
// error of the launches (0 when all were queued), or, when a tensor map is
// refused, 10000 + the CUresult.
extern "C" int nidt_stem_bwd(const void* zs, const void* pooled,
                             const void* gpool, const void* gs1,
                             const void* gs2, void* out, void* partials,
                             void* dbias, int B, int D, int H, int W, int F,
                             int bf16, int split, void* stream) {
  if (!valid(B, D, H, W, F) || (partials == nullptr) != (dbias == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const LaunchFn fn{zs,  pooled, gpool, gs1, gs2,   out,
                    partials, dbias, B,  D,   H,     W,
                    split, static_cast<cudaStream_t>(stream)};
  return bf16 ? by_channels<__nv_bfloat16>(F, fn)
              : by_channels<float>(F, fn);
}
