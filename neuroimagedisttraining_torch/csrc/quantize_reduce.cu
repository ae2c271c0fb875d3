// The off-mesh int8 aggregation wire in one pass: stochastic int8 quantize,
// dequantize and the weighted client sum, for a bucketed client matrix.
//
// Replaces: neuroimagedisttraining_tpu/ops/pallas_kernels.py
//   fused_quantize_reduce (_qreduce_kernel), reached from
//   parallel/collectives.py::_reduce_mat on the int8 wire, once per round.
//
// Per output value j of bucket b, over the clients in static order from
// acc = 0:
//   y   = x[c, b, j] / s[c, b]                          (__fdiv_rn)
//   f   = floor(y)
//   q   = clip(f + (u[c, b, j] < y - f), -127, 127)      (the int8 payload)
//   acc = acc + w[c] * (q * s[c, b])                     (__fmul_rn, __fadd_rn)
// The stochastic-rounding uniforms u and the per-bucket max-abs/127 scales s
// are inputs, computed by the caller as the reference computes them (the
// scale is a max, exact in any order), so the payload is the reference's bit
// for bit and the whole result is the plain PyTorch version's bit for bit
// (ops/kernels.py::quantize_reduce_plain: the same ops, each rounded once).
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
// Layout and design: x, u are contiguous client-major [C, nb * b]; one thread
// owns one output value (grid-stride), so for each client neighbouring
// threads read neighbouring addresses.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    quantize_reduce_kernel(const float* __restrict__ x,
                           const float* __restrict__ u,
                           const float* __restrict__ s,
                           const float* __restrict__ w,
                           float* __restrict__ out, int clients,
                           long long nb, long long b) {
  const long long total = nb * b;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < total; j += stride) {
    const long long bucket = j / b;
    float acc = 0.0f;
    for (int c = 0; c < clients; ++c) {
      const long long at = c * total + j;
      const float sc = s[c * nb + bucket];
      const float y = __fdiv_rn(x[at], sc);
      const float f = floorf(y);
      const float up = u[at] < __fsub_rn(y, f) ? 1.0f : 0.0f;
      // clip by compares, so a NaN passes through as torch.clamp passes it
      float q = __fadd_rn(f, up);
      q = q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);
      acc = __fadd_rn(acc, __fmul_rn(w[c], __fmul_rn(q, sc)));
    }
    out[j] = acc;
  }
}

}  // namespace

// x, u: [clients, nb, b] f32; s: [clients, nb] f32; w: [clients] f32;
// out: [nb, b] f32; all contiguous on the device. Returns cudaGetLastError()
// after the launch.
extern "C" int nidt_quantize_reduce(const void* x, const void* u,
                                    const void* s, const void* w, void* out,
                                    int clients, long long nb, long long b,
                                    int blocks, void* stream) {
  if (clients < 1 || nb < 1 || b < 1 || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  quantize_reduce_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(s), static_cast<const float*>(w),
      static_cast<float*>(out), clients, nb, b);
  return static_cast<int>(cudaGetLastError());
}
