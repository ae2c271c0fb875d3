// The off-mesh int8 aggregation wire in one pass: stochastic int8 quantize,
// dequantize and the weighted client sum, for a bucketed client matrix.
//
// Replaces: neuroimagedisttraining_tpu/ops/pallas_kernels.py
//   fused_quantize_reduce (_qreduce_kernel), reached from
//   parallel/collectives.py::_reduce_mat on the int8 wire, once per round.
//
// Per output value j of bucket b, over the clients in static order from
// acc = 0:
//   y   = x[c, b, j] / s[c, b]                          (__fdiv_rn; see qterm)
//   f   = floor(y)
//   q   = clip(f + (u[c, b, j] < y - f), -127, 127)      (the int8 payload)
//   acc = acc + w[c] * (q * s[c, b])                     (__fmul_rn, __fadd_rn)
// The stochastic-rounding uniforms u and the per-bucket max-abs/127 scales s
// are inputs, computed by the caller as the reference computes them (the
// scale is a max, exact in any order), so the payload is the reference's bit
// for bit and the whole result is the plain PyTorch version's bit for bit
// (ops/kernels.py::quantize_reduce_plain: the same ops, each rounded once; no
// reciprocal multiply, no contraction into a fused multiply-add).
// The reference's own bit-identity rests on sharing XLA's dot between its two
// backends; this kernel shares nothing with XLA and agrees with the
// reference's sum within float32 round-off.
//
// Any bucket size: the Pallas kernel's multiple-of-1024 rule is a TPU tiling
// limit, and nothing here depends on it.
//
// Bound: device memory. x and u are read once ([C, nb, b] f32 each), s and w
// are tiny and cached, out is written once ([nb, b] f32): at C = 8, nb = 10,
// b = 262,144 that is 167.8 MB read + 10.5 MB written, ~53 us at 3.35 TB/s.
//
// Design: x, u are contiguous client-major [C, nb, b]. To keep enough bytes
// in flight to cover the latency of device memory:
//   * the grid is bucket-aligned, (tiles per bucket, buckets): a block owns
//     one tile of kTile outputs of one bucket, so the bucket index is
//     blockIdx.y (no division), and each thread loads the C scales of its
//     bucket once, into registers;
//   * the kernel is a template on the client count (1..16), so the weights
//     and scales sit in registers and the client chain is fully unrolled;
//   * a thread owns kGroups float4 groups of outputs and issues all of their
//     x and u loads, 2 x C x 16 bytes per group, before the first division;
//     x and u, read once, are loaded with the streaming hint (__ldcs), the
//     output stored plainly (the round reads it next);
//   * the 16-byte path needs b % 4 == 0 and x, u, out on 16-byte boundaries
//     (then every client's row of every bucket is aligned); any other input
//     takes the scalar path of the same kernel, with the same 4 * kGroups
//     outputs per thread (neighbouring threads on neighbouring addresses)
//     and all of its 2 x C x 4 * kGroups loads in flight. The wrapper
//     decides (ops/kernels.py::quantize_reduce_plan) and passes the path;
//   * a register cap lets an SM hold two blocks (16 warps) up to 8 clients,
//     so that while some warps divide, others have their loads in flight;
//   * a zero value, half of a masked model's wire, skips the division's
//     slow path (qterm) with the same bits.
// More than 16 clients run as chunks of 16 in client order, one launch each;
// each launch after the first resumes every chain from the partial sum it
// left in `out` (stored in f32, so the bits are those of one unbroken chain).
// A bucket index and a position inside a bucket are 32-bit; only the offsets
// that C * nb * b can carry past 2^31 (a client's plane c * nb * b, a
// bucket's row bucket * b, a client's scales c * nb) are 64-bit, computed
// once per thread and bucket.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 1;                        // float4 groups per thread
constexpr int kTile = kThreads * 4 * kGroups;     // outputs per block
constexpr int kMaxChunk = 16;                     // clients per launch
constexpr int kMaxGridY = 65535;

// Blocks an SM should hold at C clients, which caps the registers at
// 65536 / (kThreads * blocks): 128 up to 8 clients (ptxas wants ~170 at 8
// and spills under 100 bytes to fit, which measured faster than one block
// unspilled), none below 255 above that.
template <int C>
constexpr int min_blocks() {
  return C <= 8 ? 2 : 1;
}

__device__ __forceinline__ float qterm(float acc, float x, float u, float s,
                                       float w) {
  // y = x / s, correctly rounded. A zero numerator sends __fdiv_rn down its
  // slow path (a masked model's wire is half zeros), so a zero x over a
  // finite nonzero s takes x * s instead: +-0 with the sign of x times the
  // sign of s, which is exactly x / s. Every other x, and a zero x over an
  // infinite, zero or NaN s, is divided (s / s stands in for 0 / s, so the
  // skipped lanes do not take the slow path either).
  const bool z = x == 0.0f && fabsf(s) < INFINITY && s != 0.0f;
  const float y = z ? __fmul_rn(x, s) : __fdiv_rn(z ? s : x, s);
  const float f = floorf(y);
  const float up = u < __fsub_rn(y, f) ? 1.0f : 0.0f;
  // clip by compares, so a NaN passes through as torch.clamp passes it
  float q = __fadd_rn(f, up);
  q = q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);
  return __fadd_rn(acc, __fmul_rn(w, __fmul_rn(q, s)));
}

__device__ __forceinline__ float4 qterm4(float4 acc, float4 x, float4 u,
                                         float s, float w) {
  acc.x = qterm(acc.x, x.x, u.x, s, w);
  acc.y = qterm(acc.y, x.y, u.y, s, w);
  acc.z = qterm(acc.z, x.z, u.z, s, w);
  acc.w = qterm(acc.w, x.w, u.w, s, w);
  return acc;
}

// Clients [0, C) of x, u ([C, nb, b]), s ([C, nb]) and w ([C]), all already
// offset to the chunk's first client; `resume` continues from `out`.
template <int C>
__global__ void __launch_bounds__(kThreads, min_blocks<C>())
    quantize_reduce_kernel(const float* __restrict__ x,
                           const float* __restrict__ u,
                           const float* __restrict__ s,
                           const float* __restrict__ w,
                           float* __restrict__ out, int nb, int b, int vec,
                           int resume) {
  const long long plane = static_cast<long long>(nb) * b;
  float wr[C];
#pragma unroll
  for (int c = 0; c < C; ++c) wr[c] = __ldg(w + c);
  // one pass unless nb exceeds the grid's y limit
  for (int bucket = blockIdx.y; bucket < nb; bucket += gridDim.y) {
    const long long row = static_cast<long long>(bucket) * b;
    const float* __restrict__ xb = x + row;
    const float* __restrict__ ub = u + row;
    float* __restrict__ ob = out + row;
    float sr[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sr[c] = __ldg(s + static_cast<long long>(c) * nb + bucket);
    }

    if (vec) {
      const int b4 = b >> 2;
      const int j0 = blockIdx.x * (kTile / 4) + threadIdx.x;
      float4 xv[kGroups][C], uv[kGroups][C];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int j = j0 + g * kThreads;
        if (j < b4) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            xv[g][c] = __ldcs(reinterpret_cast<const float4*>(xb + c * plane)
                              + j);
            uv[g][c] = __ldcs(reinterpret_cast<const float4*>(ub + c * plane)
                              + j);
          }
        }
      }
      float4* __restrict__ o4 = reinterpret_cast<float4*>(ob);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int j = j0 + g * kThreads;
        if (j < b4) {
          float4 acc = resume ? o4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc = qterm4(acc, xv[g][c], uv[g][c], sr[c], wr[c]);
          }
          o4[j] = acc;
        }
      }
    } else {
      constexpr int kOut = 4 * kGroups;
      const int j0 = blockIdx.x * kTile + threadIdx.x;
      float xv[kOut][C], uv[kOut][C];
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const int j = j0 + k * kThreads;
        if (j < b) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            xv[k][c] = __ldcs(xb + c * plane + j);
            uv[k][c] = __ldcs(ub + c * plane + j);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const int j = j0 + k * kThreads;
        if (j < b) {
          float acc = resume ? ob[j] : 0.0f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc = qterm(acc, xv[k][c], uv[k][c], sr[c], wr[c]);
          }
          ob[j] = acc;
        }
      }
    }
  }
}

using QrKernel = void (*)(const float*, const float*, const float*,
                          const float*, float*, int, int, int, int);
const QrKernel kKernels[kMaxChunk] = {
    quantize_reduce_kernel<1>,  quantize_reduce_kernel<2>,
    quantize_reduce_kernel<3>,  quantize_reduce_kernel<4>,
    quantize_reduce_kernel<5>,  quantize_reduce_kernel<6>,
    quantize_reduce_kernel<7>,  quantize_reduce_kernel<8>,
    quantize_reduce_kernel<9>,  quantize_reduce_kernel<10>,
    quantize_reduce_kernel<11>, quantize_reduce_kernel<12>,
    quantize_reduce_kernel<13>, quantize_reduce_kernel<14>,
    quantize_reduce_kernel<15>, quantize_reduce_kernel<16>};

}  // namespace

// Outputs per block along a bucket: the wrapper's grid is (ceil(b / tile),
// min(nb, 65535)).
extern "C" int nidt_quantize_reduce_tile() { return kTile; }

// One launch over clients [c0, c0 + chunk) of x, u: [clients, nb, b] f32;
// s: [clients, nb] f32; w: [clients] f32; out: [nb, b] f32; all contiguous
// on the device. c0 > 0 resumes from `out`. vec != 0 takes the 16-byte path
// (the caller guarantees b % 4 == 0 and x, u, out 16-byte aligned). The grid
// is (tiles, grid_y): tiles * tile must cover b, grid_y at most
// min(nb, 65535). Returns cudaGetLastError() after the launch.
extern "C" int nidt_quantize_reduce(const void* x, const void* u,
                                    const void* s, const void* w, void* out,
                                    int clients, int nb, int b, int c0,
                                    int chunk, int vec, int tiles, int grid_y,
                                    void* stream) {
  if (clients < 1 || nb < 1 || b < 1 || c0 < 0 || chunk < 1 ||
      chunk > kMaxChunk || c0 + chunk > clients || tiles < 1 ||
      static_cast<long long>(tiles) * kTile < b ||
      static_cast<long long>(tiles - 1) * kTile >= b || grid_y < 1 ||
      grid_y > nb || grid_y > kMaxGridY) {
    return cudaErrorInvalidValue;
  }
  const long long plane = static_cast<long long>(nb) * b;
  const float* xf = static_cast<const float*>(x) + c0 * plane;
  const float* uf = static_cast<const float*>(u) + c0 * plane;
  const float* sf = static_cast<const float*>(s) + static_cast<long long>(c0)
                    * nb;
  const float* wf = static_cast<const float*>(w) + c0;
  kKernels[chunk - 1]<<<dim3(tiles, grid_y), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      xf, uf, sf, wf, static_cast<float*>(out), nb, b, vec, c0 > 0);
  return static_cast<int>(cudaGetLastError());
}
