// The stem stage's backward through its max-pool and GroupNorm statistics, in
// one pass over the full-resolution conv output.
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
// A bf16 zs has exact ties in about a tenth of its windows, so the two rules
// give different gradients there; the caller picks one. The plain PyTorch
// version (ops/kernels.py stem_bwd_plain) spells the same operations, so the
// two agree bit for bit.
//
// Bound, at the main path's shapes (zs (8, 59, 71, 59, 64) bf16): device
// memory. zs is read and dzs written once (2 x 253.1 MB), pooled and
// g_pooled read once (2 x 8.5 MB): 523 MB, 0.156 ms at 3.35 TB/s; the ~4
// operations per element are far below the bytes.
// Layout and design: everything is channels-last (F fastest). One thread owns
// one 3x3x3 cell (a pool window, or the clipped remainder past the last whole
// window) for 8 contiguous channels, so each of its loads and stores is one
// 16-byte vector (bf16) and 8 neighbouring threads cover 64 channels of one
// position. Pass 1 reads the cell to find the tie count or the first maximum
// per channel; pass 2 reads it again (from cache: the thread's own 27 x 16
// bytes) and writes dzs. Each output is written once; no block depends on
// another.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFc = 8;
constexpr int kMaxF = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ void load8(const float* p, float v[kFc]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kFc]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float v[kFc]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kFc]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stem_bwd_kernel(const T* __restrict__ zs, const T* __restrict__ pooled,
                    const T* __restrict__ gpool,
                    const float* __restrict__ gs1,
                    const float* __restrict__ gs2, T* __restrict__ out, int D,
                    int H, int W, int F, int split, long long cells) {
  const int PD = D / 3, PH = H / 3, PW = W / 3;
  const int ncd = (D + 2) / 3, nch = (H + 2) / 3, ncw = (W + 2) / 3;
  const int nfc = F / kFc;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cells; i += stride) {
    long long rest = i;
    const int fc = static_cast<int>(rest % nfc);
    rest /= nfc;
    const int cw = static_cast<int>(rest % ncw);
    rest /= ncw;
    const int ch = static_cast<int>(rest % nch);
    rest /= nch;
    const int cd = static_cast<int>(rest % ncd);
    const long long b = rest / ncd;
    const int f0 = fc * kFc;
    float a[kFc], c2[kFc];
#pragma unroll
    for (int f = 0; f < kFc; ++f) {
      a[f] = gs1[b * F + f0 + f];
      c2[f] = 2.0f * gs2[b * F + f0 + f];
    }
    const bool full = cd < PD && ch < PH && cw < PW;
    float m[kFc], g[kFc];
    int first[kFc], count[kFc];
#pragma unroll
    for (int f = 0; f < kFc; ++f) {
      m[f] = 0.0f;
      g[f] = 0.0f;
      first[f] = -1;
      count[f] = 0;
    }
    if (full) {
      const long long at =
          (((b * PD + cd) * PH + ch) * PW + cw) * F + f0;
      load8(pooled + at, m);
      load8(gpool + at, g);
      for (int k = 0; k < 27; ++k) {
        const int d = 3 * cd + k / 9, h = 3 * ch + (k / 3) % 3,
                  w = 3 * cw + k % 3;
        float z[kFc];
        load8(zs + (((b * D + d) * H + h) * W + w) * F + f0, z);
#pragma unroll
        for (int f = 0; f < kFc; ++f) {
          const bool eq = z[f] == m[f];
          count[f] += eq ? 1 : 0;
          first[f] = (first[f] < 0 && eq) ? k : first[f];
        }
      }
      if (split) {
#pragma unroll
        for (int f = 0; f < kFc; ++f) {
          g[f] = __fdiv_rn(g[f], static_cast<float>(count[f] > 1 ? count[f]
                                                                  : 1));
        }
      }
    }
    for (int k = 0; k < 27; ++k) {
      const int d = 3 * cd + k / 9, h = 3 * ch + (k / 3) % 3,
                w = 3 * cw + k % 3;
      if (d >= D || h >= H || w >= W) {
        continue;
      }
      const long long at = (((b * D + d) * H + h) * W + w) * F + f0;
      float z[kFc], v[kFc];
      load8(zs + at, z);
#pragma unroll
      for (int f = 0; f < kFc; ++f) {
        const bool hit = full && (split ? z[f] == m[f] : k == first[f]);
        const float pool_term = hit ? g[f] : 0.0f;
        const float dense = __fadd_rn(a[f], __fmul_rn(c2[f], z[f]));
        v[f] = __fadd_rn(dense, pool_term);
      }
      store8(out + at, v);
    }
  }
}

}  // namespace

// zs (B, D, H, W, F), pooled and g_pooled (B, D/3, H/3, W/3, F), out like
// zs, all in T (bf16 when bf16 != 0, else f32); g_s1, g_s2 (B, F) f32; all
// contiguous and 16-byte aligned on the device. split != 0 splits tied
// cotangents evenly, 0 routes them to the first maximum. Returns
// cudaGetLastError() after the launch.
extern "C" int nidt_stem_bwd(const void* zs, const void* pooled,
                             const void* gpool, const void* gs1,
                             const void* gs2, void* out, int B, int D, int H,
                             int W, int F, int bf16, int split, int blocks,
                             void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || F < kFc || F > kMaxF ||
      F % kFc != 0 || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  const long long cells = static_cast<long long>(B) * ((D + 2) / 3) *
                          ((H + 2) / 3) * ((W + 2) / 3) * (F / kFc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    stem_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(zs),
        static_cast<const __nv_bfloat16*>(pooled),
        static_cast<const __nv_bfloat16*>(gpool),
        static_cast<const float*>(gs1), static_cast<const float*>(gs2),
        static_cast<__nv_bfloat16*>(out), D, H, W, F, split, cells);
  } else {
    stem_bwd_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(zs), static_cast<const float*>(pooled),
        static_cast<const float*>(gpool), static_cast<const float*>(gs1),
        static_cast<const float*>(gs2), static_cast<float*>(out), D, H, W, F,
        split, cells);
  }
  return static_cast<int>(cudaGetLastError());
}
