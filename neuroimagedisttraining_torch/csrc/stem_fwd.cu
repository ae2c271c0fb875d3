// The AlexNet3D stem stage's full-resolution forward in one pass: the phased
// stem conv, its bias, the 3x3x3/s3 max-pool and the per-(sample, channel)
// sum and sum of squares that feed GroupNorm.
//
// Replaces (one kernel for three pallas_call sites):
//   neuroimagedisttraining_tpu/ops/experimental/pallas_stem_fused.py
//     fused_stem_fwd (kernel): conv + pool + statistics partials;
//   neuroimagedisttraining_tpu/ops/experimental/pallas_stem_v3.py
//     fused_stem_fwd_v3 (kernel): the same three outputs, with bias;
//   neuroimagedisttraining_tpu/ops/experimental/pallas_stem.py
//     stem_conv_pallas (_kernel): the conv alone (pool and statistics off).
// In the port it is also the main path's stem: models/alexnet3d.py
// S2DStemStage (pool-first) runs it on every forward.
//
// What it computes, for x (B, D', H', 8, W') and w (F, 8, 3, 3, 3) in the
// working type T (bf16 or f32), with D = D'-2, H = H'-2, W = W'-2:
//   acc = sum over (dz, dy, p, dx) of x[b, d+dz, h+dy, p, w+dx] * w[f, p, dz,
//         dy, dx], in f32 (fmaf);
//   zs[b, d, h, w, f] = T(T(acc) + bias[f])  (rounded, then the bias added in
//         the working type and rounded again, as the reference spells it:
//         models/alexnet3d.py phased_stem_stage, pallas_stem_v3.ref);
//   pooled[b, pd, ph, pw, f] = max of the rounded zs over the window, floor
//         mode; the first of equal values in (d, h, w) order and NaN wins, as
//         torch's max-pool compares, so it equals max_pool3d(zs) bit for bit;
//   s1[b, f], s2[b, f] = sum of zs and of zs^2 over (d, h, w), of the ROUNDED
//         zs (what the model and both refs sum), accumulated in f64 and
//         rounded once to f32. Planes, rows and columns past the last whole
//         window are written to zs and counted in the statistics.
// zs and pooled are channels-last (F fastest): the reference's NDHWC, and a
// permute view away from NCDHW.
//
// Unlike the Pallas kernels, nothing here relies on blocks running in order:
// each output element is written by exactly one thread, and the statistics
// go through per-tile f64 partials [B, ntile, 2, F] and a second, fixed-order
// reduction (no atomics), so a run gives the same bits every time. The TPU
// kernels' ragged tail strip, overlap-row exclusion and fixed B = 8 / W <= 64
// limits are tiling artifacts and are not kept: any B, any D', H', W' >= 3,
// F a multiple of 8 up to 64.
//
// Bound, at the main path's shapes (B = 8, (61, 73, 8, 61), F = 64, bf16):
// bytes: x 34.8 MB read + zs 253.1 MB + pooled 8.5 MB written = 296 MB,
// 0.088 ms at 3.35 TB/s; operations: 27.3 G multiply-adds, 0.055 ms at the
// bf16 dense tensor-core peak (989 TFLOP/s). So the work is bytes-bound, as
// long as the multiply-adds run on the tensor cores: on the CUDA cores
// (FFMA) they alone take 0.81 ms at the 67 TFLOP/s peak.
//
// Two code paths, one contract:
// * bf16 with F = 16, 32 or 64 (the main path): stem_fwd_mma_kernel, the
//   conv on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate).
//   A tile is pool-aligned: 3 d-planes x 3 h-rows x 63 w-columns (21 pool
//   windows), all F channels. Per output row the conv is a product A (F x
//   224: the weights, taps in the reference's ((dz*3+dy)*3+dx)*8+p order,
//   one zero tap of padding) x B (224 x 64 positions). B is read in place
//   from the input halo in shared memory, stored with the 8 phases innermost
//   so that a position's 8 phases are one 16-byte row: ldmatrix loads four
//   B fragments at once, conflict-free.
//   Each row is rounded (bias added) into a bf16 output tile in shared
//   memory (channel stride padded by 8 against bank conflicts); then the
//   tile's zs goes out in 16-byte vectors, with its pool windows and its f64
//   statistics partial, from that tile. The full-size zs is written once and
//   never read back.
//   What bounded it on the H100 as one block per tile (3,840 at the main
//   path's shapes, two resident per SM), measured by scripts/stem_fwd_ab.py
//   (PERF.md): each block filled its halo with 52 two-byte loads per
//   thread, each waited on (the fill alone 0.32 of 0.69 ms), loaded its
//   weight fragments from device memory, and only then ran its products
//   (0.26 ms alone) and its epilogue (0.23 ms alone) in sequence.
//   So the kernel is persistent, one block per SM walking the tiles with a
//   fixed stride, and the block is two warp groups. The product group loads
//   the weight fragments and bias into registers once, fetches each tile's
//   halo one tile ahead by TMA (one thread, eight boxes of the (B, D', H',
//   8 W') view, an mbarrier counting the bytes) into a staging buffer,
//   transposes a landed halo shared to shared into the phases-innermost
//   layout and runs the products into one of two output tiles. The
//   epilogue group drains the other output tile meanwhile (mbarriers pass
//   the tiles between the groups). What is left of the time is the
//   products (mma.sync, each reading its 256-byte B fragment from shared
//   memory: 1 MB per tile) with the epilogue under them. The arithmetic, its
//   order and every output's bits are those of the block-per-tile kernel it
//   replaced.
// * f32, or bf16 with F = 8, 24, 40, 48 or 56: stem_fwd_kernel, the same
//   tile shape on the CUDA cores (FFMA in f32). The 216 x F weights (f32,
//   prepared once per call by stem_wprep_kernel) and the halo (5 x 5 x 8 x
//   (3 * 32 + 2), in T) sit in shared memory; thread (fg, wg) owns channels
//   8 fg .. 8 fg + 7 of pool-window column wg (wg fastest across lanes, so
//   a warp's weight loads are broadcasts) and, for each of the 9 (d, h)
//   rows, accumulates 8 x 3 outputs in registers, reusing each input value
//   for 8 channels and each weight for 3 columns; the whole pool window is
//   thread-local, written from registers.
// Tensor-core accumulation rounds differently from an FFMA chain; both
// agree with cuDNN's f32 conv within one ulp of bf16 except where the conv
// cancels to near zero (then within f32 round-off of its terms).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kFc = 8;          // channels per thread
constexpr int kWgTile = 32;     // pool-window columns per block
constexpr int kMaxF = 64;
constexpr int kTaps = 216;      // 3 * 3 * 8 * 3, ordered ((dz*3+dy)*8+p)*3+dx
constexpr int kMaxThreads = (kMaxF / kFc) * kWgTile;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive channels (values already representable in T) to 16 bytes.
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

// w (F, 8, 3, 3, 3) in T -> wt [216][F] f32, tap ((dz*3+dy)*8+p)*3+dx.
template <typename T>
__global__ void stem_wprep_kernel(const T* __restrict__ w,
                                  float* __restrict__ wt, int F) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kTaps * F) {
    return;
  }
  const int f = i % F;
  const int tap = i / F;
  const int dx = tap % 3;
  const int p = (tap / 3) % 8;
  const int dy = (tap / 24) % 3;
  const int dz = tap / 72;
  wt[i] = to_f(w[(((f * 8 + p) * 3 + dz) * 3 + dy) * 3 + dx]);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    stem_fwd_kernel(const T* __restrict__ x, const float* __restrict__ wt,
                    const T* __restrict__ bias, T* __restrict__ zs,
                    T* __restrict__ pooled, double* __restrict__ partials,
                    int Dp, int Hp, int Wp, int F, int nwg, int nwg_tile,
                    int nht, int nwt, int do_pool, int do_stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);
  unsigned char* tile = smem + kTaps * F * sizeof(float);
  T* x_s = reinterpret_cast<T*>(tile);
  const int D = Dp - 2, H = Hp - 2, W = Wp - 2;
  const int PD = D / 3, PH = H / 3, PW = W / 3;
  const int WS = 3 * nwg_tile + 2;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  // window columns fastest: the lanes of a warp read one or two weight
  // vectors (a broadcast) and neighbouring input columns
  const int wg = tid % nwg_tile;
  const int fg = tid / nwg_tile;
  const int b = blockIdx.y;
  int rest = blockIdx.x;
  const int wti = rest % nwt;
  rest /= nwt;
  const int ht = rest % nht;
  const int dt = rest / nht;
  const int d0 = 3 * dt, h0 = 3 * ht, wbase = 3 * nwg_tile * wti;

  // weights, then the input halo (zero past the volume's edge)
  const float4* wt4 = reinterpret_cast<const float4*>(wt);
  for (int i = tid; i < kTaps * F / 4; i += nthreads) {
    reinterpret_cast<float4*>(w_s)[i] = wt4[i];
  }
  const long long xb = static_cast<long long>(b) * Dp * Hp * 8 * Wp;
  for (int i = tid; i < 5 * 5 * 8 * WS; i += nthreads) {
    const int iw = i % WS;
    const int r = i / WS;
    const int p = r % 8;
    const int ih = (r / 8) % 5;
    const int id = r / 40;
    const int d = d0 + id, h = h0 + ih, w = wbase + iw;
    T v = from_f<T>(0.0f);
    if (d < Dp && h < Hp && w < Wp) {
      v = x[xb + ((static_cast<long long>(d) * Hp + h) * 8 + p) * Wp + w];
    }
    x_s[i] = v;
  }
  __syncthreads();

  const int gw = wti * nwg_tile + wg;  // this thread's pool-window column
  const bool active = gw < nwg;
  const int f0 = fg * kFc;
  const int w0 = 3 * gw;
  float bv[kFc];
#pragma unroll
  for (int f = 0; f < kFc; ++f) {
    bv[f] = bias != nullptr ? to_f(bias[f0 + f]) : 0.0f;
  }
  double s1[kFc], s2[kFc];
  float pm[kFc];
#pragma unroll
  for (int f = 0; f < kFc; ++f) {
    s1[f] = 0.0;
    s2[f] = 0.0;
    pm[f] = -INFINITY;
  }

  for (int ld = 0; ld < 3 && d0 + ld < D; ++ld) {
    for (int lh = 0; lh < 3 && h0 + lh < H; ++lh) {
      float acc[kFc][3];
#pragma unroll
      for (int f = 0; f < kFc; ++f) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          acc[f][j] = 0.0f;
        }
      }
#pragma unroll 1
      for (int dzy = 0; dzy < 9; ++dzy) {
        const int dz = dzy / 3, dy = dzy % 3;
        const T* xr = x_s + ((ld + dz) * 5 + (lh + dy)) * 8 * WS + 3 * wg;
        const float* wr = w_s + dzy * 24 * F + f0;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          float xv[5];
#pragma unroll
          for (int i = 0; i < 5; ++i) {
            xv[i] = to_f(xr[p * WS + i]);
          }
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4* wp =
                reinterpret_cast<const float4*>(wr + (p * 3 + dx) * F);
            const float4 wa = wp[0], wb = wp[1];
            const float wv[kFc] = {wa.x, wa.y, wa.z, wa.w,
                                   wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int f = 0; f < kFc; ++f) {
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                acc[f][j] = fmaf(wv[f], xv[j + dx], acc[f][j]);
              }
            }
          }
        }
      }
      // epilogue: round, bias, store, statistics, window maximum
      const long long row =
          ((static_cast<long long>(b) * D + d0 + ld) * H + h0 + lh) * W;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int w = w0 + j;
        if (!active || w >= W) {
          continue;
        }
        float v[kFc];
#pragma unroll
        for (int f = 0; f < kFc; ++f) {
          float r = to_f(from_f<T>(acc[f][j]));
          if (bias != nullptr) {
            r = to_f(from_f<T>(__fadd_rn(r, bv[f])));
          }
          v[f] = r;
          const double rd = static_cast<double>(r);
          s1[f] = __dadd_rn(s1[f], rd);
          s2[f] = __dadd_rn(s2[f], __dmul_rn(rd, rd));
          pm[f] = (r > pm[f] || isnan(r)) ? r : pm[f];
        }
        store8(zs + (row + w) * F + f0, v);
      }
    }
  }
  if (do_pool && active && dt < PD && ht < PH && gw < PW) {
    store8(pooled +
               (((static_cast<long long>(b) * PD + dt) * PH + ht) * PW + gw) *
                   F +
               f0,
           pm);
  }
  if (!do_stats) {
    return;
  }
  // per-block partials: fixed-order sum over the block's window columns
  __syncthreads();  // the halo is dead; reuse it
  double* red = reinterpret_cast<double*>(tile);
#pragma unroll
  for (int f = 0; f < kFc; ++f) {
    red[wg * F + f0 + f] = s1[f];
    red[(nwg_tile + wg) * F + f0 + f] = s2[f];
  }
  __syncthreads();
  const int nblk = gridDim.x;
  for (int i = tid; i < 2 * F; i += nthreads) {
    const int c = i / F, f = i % F;
    double a = 0.0;
    for (int g = 0; g < nwg_tile; ++g) {
      a = __dadd_rn(a, red[(c * nwg_tile + g) * F + f]);
    }
    partials[((static_cast<long long>(b) * nblk + blockIdx.x) * 2 + c) * F +
             f] = a;
  }
}

// s1/s2[b, f] = f32(sum over blocks, in block order, of the f64 partials)
__global__ void stem_stats_finalize_kernel(const double* __restrict__ partials,
                                           float* __restrict__ s1,
                                           float* __restrict__ s2, int nblk,
                                           int F) {
  const int b = blockIdx.x;
  const int c = threadIdx.x / F, f = threadIdx.x % F;
  double a = 0.0;
  for (int k = 0; k < nblk; ++k) {
    a = __dadd_rn(
        a, partials[((static_cast<long long>(b) * nblk + k) * 2 + c) * F + f]);
  }
  (c == 0 ? s1 : s2)[b * F + f] = __double2float_rn(a);
}

// ---- the bf16 tensor-core path (F = 16, 32 or 64) -------------------------

constexpr int kMmaTileW = 63;          // outputs per w-tile: 21 pool windows
constexpr int kMmaPos = 64;            // positions computed per row: 8 n-tiles
constexpr int kXCols = kMmaPos + 2;    // input columns of the halo
constexpr int kMmaK = 224;             // 28 taps x 8 phases; tap 27 is zero
constexpr int kKTiles = kMmaK / 16;

// w (F, 8, 3, 3, 3) bf16 -> wa [F][224] bf16, k = tap * 8 + p with
// tap = (dz * 3 + dy) * 3 + dx (the reference's (F, 216) order), then zeros.
__global__ void stem_wprep_mma_kernel(const __nv_bfloat16* __restrict__ w,
                                      __nv_bfloat16* __restrict__ wa, int F) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F * kMmaK) {
    return;
  }
  const int f = i / kMmaK, k = i % kMmaK;
  const int tap = k / 8, p = k % 8;
  if (tap >= 27) {
    wa[i] = __float2bfloat16_rn(0.0f);
    return;
  }
  const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
  wa[i] = w[(((f * 8 + p) * 3 + dz) * 3 + dy) * 3 + dx];
}

// A pure function of its registers: not volatile, so the compiler may
// schedule the products between the fragment loads.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- the halo's TMA fetch --------------------------------------------------
// x (B, D', H', 8, W') is read as the 4-D view (B, D', H', 8 W'): a row of
// the 5-D view is 2 W' bytes and need not start on a 16-byte boundary, but a
// (p, w) plane is 16 W' bytes, so this view's strides are legal for TMA. A
// tile's halo is one box of kBoxW x 5 x 5 x 1 per phase p. The box must
// start on a 16-byte boundary of the plane, so it starts at plane
// coordinate c & ~7, c = p W' + wbase, and phase p's column iw lies at
// (c & 7) + iw in it (columns past W' read the next phase, or zeros past
// the plane; the transpose zeroes them). Rows past D' or H' arrive as zeros.

constexpr int kBoxW = 80;                    // >= kXCols + 7, 160 bytes
constexpr int kBoxBytes = kBoxW * 5 * 5 * 2;  // 4000
constexpr int kBoxStride = 4096;             // kBoxBytes rounded up to 128
constexpr int kStageBytes = 8 * kBoxStride;
constexpr int kHaloBytes = 5 * 5 * kXCols * 8 * 2;

// One thread: expect the eight boxes' bytes on bar, then issue them.
__device__ __forceinline__ void fetch_halo(const CUtensorMap* xmap,
                                           uint32_t stage, uint32_t bar,
                                           int b, int d0, int h0, int wbase,
                                           int Wp) {
  mbar_expect_tx(bar, 8 * kBoxBytes);
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
            stage + p * kBoxStride),
        "l"(reinterpret_cast<uint64_t>(xmap)), "r"((p * Wp + wbase) & ~7),
        "r"(h0),
        "r"(d0), "r"(b), "r"(bar)
        : "memory");
  }
}

// The halo of tile t (sample-major, then dt, ht, wti, wti fastest).
__device__ __forceinline__ void fetch_tile(const CUtensorMap* xmap,
                                           uint32_t stage, uint32_t bar, int t,
                                           int nblk, int nht, int nwt,
                                           int Wp) {
  int rest = t % nblk;
  const int wti = rest % nwt;
  rest /= nwt;
  fetch_halo(xmap, stage, bar, t / nblk, 3 * (rest / nht), 3 * (rest % nht),
             kMmaTileW * wti, Wp);
}

// Four 8 x 8 b16 matrices from shared memory, one 16-byte row address per
// lane (lanes 8 q .. 8 q + 7 address matrix q): thread (g, c4) gets row g,
// elements 2 c4 and 2 c4 + 1 of each, an mma.sync B fragment where the rows
// are positions and the elements phases.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// A barrier among the n threads (a multiple of 32) of one warp group.
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The block is two warp groups of G = F / 16 x 64 threads each, which work
// on the tiles (b, dt, ht, wti) with a fixed stride of gridDim.x, one tile
// apart:
// * the product group (threads 0 .. G - 1) waits for a tile's halo (TMA,
//   issued one tile ahead by its thread 0 into a staging buffer), transposes
//   it shared to shared into x_s[id][ih][iw][p], issues the next tile's
//   halo, and runs the conv as a product per output row: A = weights (F x
//   224, row-major, in registers for the whole block), B = the halo read in
//   place (224 x 64 positions: phases are innermost, so four B fragments
//   are one ldmatrix), C = f32 accumulators; warp (mt, nh)
//   owns channels 16 mt .. 16 mt + 15 and positions 32 nh .. 32 nh + 31.
//   Each row is rounded, the bias added, into one of two output tiles o_s;
// * the epilogue group (threads G .. 2 G - 1) takes each output tile as it
//   fills: zs in 16-byte vectors, the pool windows and the tile's f64
//   statistics partial, then hands the tile back.
// Two mbarriers per output tile (full, empty) pass the tiles between the
// groups, so one tile's epilogue runs under the next tile's products. The
// epilogue group's thread-to-item mapping and reduction order are those of
// a block of G threads per tile, so the partials (and s1, s2) keep their
// bits.
__global__ void __launch_bounds__(512)
    stem_fwd_mma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __nv_bfloat16* __restrict__ wa,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ zs,
                        __nv_bfloat16* __restrict__ pooled,
                        double* __restrict__ partials, int B, int Dp, int Hp,
                        int Wp, int F, int nht, int nwt, int do_pool,
                        int do_stats) {
  extern __shared__ unsigned char smem_raw[];
  // the staging buffer's boxes start on 128-byte boundaries
  unsigned char* smem = smem_raw + ((128 - smem_addr(smem_raw) % 128) % 128);
  const uint32_t stage = smem_addr(smem);
  const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(smem);
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem + kStageBytes);
  const int FP = F + 8;  // padded channel stride of the output tiles
  const int o_len = 9 * kMmaPos * FP;
  __nv_bfloat16* o_s = x_s + 5 * 5 * kXCols * 8;  // two tiles of o_len
  const uint32_t bars = smem_addr(o_s + 2 * o_len);
  const uint32_t halo_full = bars;  // + 8 k: o_full[k], + 24 + 8 k: o_empty
  const int D = Dp - 2, H = Hp - 2, W = Wp - 2;
  const int PD = D / 3, PH = H / 3, PW = W / 3;
  const int G = blockDim.x / 2;
  const bool producer = static_cast<int>(threadIdx.x) < G;
  const int tid = producer ? threadIdx.x : threadIdx.x - G;
  const int warp = tid / 32, lane = tid % 32;
  const int nblk = ((Dp - 2 + 2) / 3) * nht * nwt;  // tiles per sample
  const int ntiles = B * nblk;

  if (threadIdx.x == 0) {
    mbar_init(halo_full, 1);
    for (int k = 0; k < 2; ++k) {
      mbar_init(bars + 8 + 8 * k, G);
      mbar_init(bars + 24 + 8 * k, G);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (producer) {
    if (tid == 0 && static_cast<int>(blockIdx.x) < ntiles) {
      fetch_tile(&xmap, stage, halo_full, blockIdx.x, nblk, nht, nwt, Wp);
    }
    const int g = lane / 4, c4 = lane % 4;
    const int nmt = F / 16;
    const int mt = warp % nmt, nh = warp / nmt;
    const int ch0 = 16 * mt + g, ch1 = ch0 + 8;
    uint32_t a[kKTiles][4];
    const uint32_t* wa32 = reinterpret_cast<const uint32_t*>(wa);
#pragma unroll
    for (int kt = 0; kt < kKTiles; ++kt) {
      a[kt][0] = wa32[ch0 * (kMmaK / 2) + kt * 8 + c4];
      a[kt][1] = wa32[ch1 * (kMmaK / 2) + kt * 8 + c4];
      a[kt][2] = wa32[ch0 * (kMmaK / 2) + kt * 8 + 4 + c4];
      a[kt][3] = wa32[ch1 * (kMmaK / 2) + kt * 8 + 4 + c4];
    }
    const float bv0 = bias != nullptr ? __bfloat162float(bias[ch0]) : 0.0f;
    const float bv1 = bias != nullptr ? __bfloat162float(bias[ch1]) : 0.0f;
    const bool q_odd = (lane / 8) % 2 == 1;
    const uint32_t x_row =
        smem_addr(x_s) + 16u * (32 * nh + 8 * (lane / 16) + lane % 8);
    int i = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
      int rest = t % nblk;
      const int wti = rest % nwt;
      rest /= nwt;
      const int d0 = 3 * (rest / nht), h0 = 3 * (rest % nht);
      const int wbase = kMmaTileW * wti;
      const int k = i & 1;
      __nv_bfloat16* o = o_s + k * o_len;

      // the halo, phases innermost: x_s[id][ih][iw][p], zero past W'
      mbar_wait(halo_full, i & 1);
      for (int j = tid; j < 5 * 5 * kXCols; j += G) {
        const int iw = j % kXCols, r = j / kXCols;
        uint4 u = make_uint4(0, 0, 0, 0);
        if (iw < Wp - wbase) {
          const __nv_bfloat16* s = st + r * kBoxW + iw;
          uint32_t v[8];
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            v[p] = __bfloat16_as_ushort(
                s[p * (kBoxStride / 2) + ((p * Wp + wbase) & 7)]);
          }
          u = make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                         v[4] | (v[5] << 16), v[6] | (v[7] << 16));
        }
        reinterpret_cast<uint4*>(x_s)[j] = u;
      }
      group_sync(1, G);
      if (tid == 0 && t + static_cast<int>(gridDim.x) < ntiles) {
        // into the staging buffer just read
        fetch_tile(&xmap, stage, halo_full, t + gridDim.x, nblk, nht, nwt,
                   Wp);
      }
      mbar_wait(bars + 24 + 8 * k, ((i >> 1) & 1) ^ 1);  // o is free

      for (int r = 0; r < 9; ++r) {
        const int ld = r / 3, lh = r % 3;
        if (d0 + ld >= D || h0 + lh >= H) {
          continue;
        }
        float acc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[nt][q] = 0.0f;
          }
        }
        // the 16-byte row (8 phases) that this lane addresses for
        // ldmatrix: position 32 nh + 8 (nt + q / 2) + j of matrix q = lane /
        // 8, row j = lane % 8, at tap t0 (q even) or t1 (q odd)
        const uint32_t row = x_row + 16u * ((ld * 5 + lh) * kXCols);
#pragma unroll
        for (int kt = 0; kt < kKTiles; ++kt) {
          const int t0 = 2 * kt;
          const int t1 = 2 * kt + 1 < 27 ? 2 * kt + 1 : 26;  // tap 27: zero
          const int o0 = ((t0 / 9) * 5 + (t0 / 3) % 3) * kXCols + t0 % 3;
          const int o1 = ((t1 / 9) * 5 + (t1 / 3) % 3) * kXCols + t1 % 3;
          const uint32_t at = row + 16u * (q_odd ? o1 : o0);
#pragma unroll
          for (int nt = 0; nt < 4; nt += 2) {
            // B fragments (t0, nt), (t1, nt), (t0, nt + 1), (t1, nt + 1)
            uint32_t b[4];
            ldmatrix_x4(b, at + 16u * 8 * nt);
            mma_bf16(acc[nt], a[kt], b[0], b[1]);
            mma_bf16(acc[nt + 1], a[kt], b[2], b[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int pos = 32 * nh + 8 * nt + 2 * c4;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float v = __bfloat162float(__float2bfloat16_rn(acc[nt][q]));
            if (bias != nullptr) {
              v = __fadd_rn(v, q < 2 ? bv0 : bv1);
            }
            o[(r * kMmaPos + pos + (q & 1)) * FP + (q < 2 ? ch0 : ch1)] =
                __float2bfloat16_rn(v);
          }
        }
      }
      mbar_arrive(bars + 8 + 8 * k);  // o is full
      group_sync(1, G);               // x_s is free
    }
    return;
  }

  // the epilogue group
  const int nch = F / kFc;
  const int chunk = tid % nch;
  int i = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
    const int b = t / nblk;
    const int tile = t % nblk;
    int rest = tile;
    const int wti = rest % nwt;
    rest /= nwt;
    const int ht = rest % nht;
    const int dt = rest / nht;
    const int d0 = 3 * dt, h0 = 3 * ht, wbase = kMmaTileW * wti;
    const int k = i & 1;
    const __nv_bfloat16* o = o_s + k * o_len;
    mbar_wait(bars + 8 + 8 * k, (i >> 1) & 1);

    // zs out in 16-byte vectors, and this thread's sums (fixed channel chunk)
    const int npos = W - wbase < kMmaTileW ? W - wbase : kMmaTileW;
    double s1[kFc], s2[kFc];
#pragma unroll
    for (int f = 0; f < kFc; ++f) {
      s1[f] = 0.0;
      s2[f] = 0.0;
    }
    for (int item = tid / nch; item < 9 * kMmaPos; item += G / nch) {
      const int r = item / kMmaPos, pos = item % kMmaPos;
      const int ld = r / 3, lh = r % 3;
      if (pos >= npos || d0 + ld >= D || h0 + lh >= H) {
        continue;
      }
      const uint4 u = *reinterpret_cast<const uint4*>(
          o + (r * kMmaPos + pos) * FP + chunk * kFc);
      *reinterpret_cast<uint4*>(
          zs + (((static_cast<long long>(b) * D + d0 + ld) * H + h0 + lh) * W +
                wbase + pos) * F + chunk * kFc) = u;
      const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 fv = __bfloat1622float2(hv[q]);
        const double e = fv.x, od = fv.y;
        s1[2 * q] = __dadd_rn(s1[2 * q], e);
        s2[2 * q] = __dadd_rn(s2[2 * q], __dmul_rn(e, e));
        s1[2 * q + 1] = __dadd_rn(s1[2 * q + 1], od);
        s2[2 * q + 1] = __dadd_rn(s2[2 * q + 1], __dmul_rn(od, od));
      }
    }

    // pool windows of this tile, in (d, h, w) order as torch compares
    if (do_pool && dt < PD && ht < PH) {
      for (int item = tid; item < (kMmaTileW / 3) * nch; item += G) {
        const int wp = item / nch, ck = item % nch;
        if (wbase / 3 + wp >= PW) {
          continue;
        }
        float m[kFc];
#pragma unroll
        for (int f = 0; f < kFc; ++f) {
          m[f] = -INFINITY;
        }
#pragma unroll 9
        for (int kk = 0; kk < 27; ++kk) {
          const int r = kk / 3, pos = 3 * wp + kk % 3;
          const uint4 u = *reinterpret_cast<const uint4*>(
              o + (r * kMmaPos + pos) * FP + ck * kFc);
          const __nv_bfloat162* hv =
              reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 fv = __bfloat1622float2(hv[q]);
            m[2 * q] = (fv.x > m[2 * q] || isnan(fv.x)) ? fv.x : m[2 * q];
            m[2 * q + 1] =
                (fv.y > m[2 * q + 1] || isnan(fv.y)) ? fv.y : m[2 * q + 1];
          }
        }
        store8(pooled + (((static_cast<long long>(b) * PD + dt) * PH + ht) *
                             PW +
                         wbase / 3 + wp) * F + ck * kFc,
               m);
      }
    }
    if (do_stats) {
      // lanes sharing a chunk, then warps, in a fixed order; the warps'
      // sums go to the start of this output tile, once all have read it
#pragma unroll
      for (int f = 0; f < kFc; ++f) {
        for (int off = nch; off < 32; off *= 2) {
          s1[f] = __dadd_rn(s1[f], __shfl_xor_sync(0xffffffffu, s1[f], off));
          s2[f] = __dadd_rn(s2[f], __shfl_xor_sync(0xffffffffu, s2[f], off));
        }
      }
      double* red = reinterpret_cast<double*>(o_s + k * o_len);
      group_sync(2, G);
      if (lane < nch) {
#pragma unroll
        for (int f = 0; f < kFc; ++f) {
          red[(warp * 2 + 0) * F + chunk * kFc + f] = s1[f];
          red[(warp * 2 + 1) * F + chunk * kFc + f] = s2[f];
        }
      }
      group_sync(2, G);
      const int nwarps = G / 32;
      for (int j = tid; j < 2 * F; j += G) {
        const int cc = j / F, f = j % F;
        double acc = 0.0;
        for (int wv = 0; wv < nwarps; ++wv) {
          acc = __dadd_rn(acc, red[(wv * 2 + cc) * F + f]);
        }
        partials[((static_cast<long long>(b) * nblk + tile) * 2 + cc) * F +
                 f] = acc;
      }
    }
    mbar_arrive(bars + 24 + 8 * k);  // o is free
  }
}

bool use_mma(int F, int bf16) {
  return bf16 && (F == 16 || F == 32 || F == 64);
}

struct Plan {
  int nwg, nwg_tile, ndt, nht, nwt;
};

Plan plan(int Dp, int Hp, int Wp, bool mma) {
  Plan p;
  p.nwg = (Wp - 2 + 2) / 3;
  p.nwg_tile = p.nwg < kWgTile ? p.nwg : kWgTile;
  p.ndt = (Dp - 2 + 2) / 3;
  p.nht = (Hp - 2 + 2) / 3;
  p.nwt = mma ? (Wp - 2 + kMmaTileW - 1) / kMmaTileW
              : (p.nwg + kWgTile - 1) / kWgTile;
  return p;
}

// The persistent launch: tiles, dynamic shared memory, blocks per SM (what
// the shared memory and registers allow) and the grid, min(tiles, that
// times the SMs).
// The persistent launch: tiles, threads (two warp groups), dynamic shared
// memory, blocks per SM (what the shared memory and registers allow) and
// the grid, min(tiles, that times the SMs).
struct MmaConfig {
  int tiles, threads, smem, per_sm, grid;
};

cudaError_t mma_config(int B, int Dp, int Hp, int Wp, int F, MmaConfig* c) {
  const Plan p = plan(Dp, Hp, Wp, true);
  c->tiles = B * p.ndt * p.nht * p.nwt;
  c->threads = 2 * (F / 16 * 64);
  // 128 bytes of slack to align the staging buffer, two output tiles and
  // five mbarriers
  c->smem = 128 + kStageBytes + kHaloBytes +
            2 * static_cast<int>(sizeof(__nv_bfloat16)) * 9 * kMmaPos *
                (F + 8) +
            5 * 8;
  cudaError_t err = cudaFuncSetAttribute(
      stem_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      c->smem);
  if (err != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &c->per_sm, stem_fwd_mma_kernel, c->threads, c->smem);
  if (err != cudaSuccess) {
    return err;
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) {
    return err;
  }
  if (c->per_sm < 1) {
    return cudaErrorInvalidConfiguration;
  }
  c->grid = c->tiles < c->per_sm * sms ? c->tiles : c->per_sm * sms;
  return cudaSuccess;
}

// The tensor map of x as the 4-D view (B, D', H', 8 W') in bf16, boxes of
// kBoxW x 5 x 5 x 1, zeros out of bounds. Returns a cudaError_t, or
// kTensorMapError + the CUresult when the encoding is refused.

int x_tensor_map(const void* x, int B, int Dp, int Hp, int Wp,
                 CUtensorMap* map) {
  EncodeTiledFn encode = nullptr;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const cuuint64_t plane = 8ull * static_cast<cuuint64_t>(Wp);
  const cuuint64_t dims[4] = {plane, static_cast<cuuint64_t>(Hp),
                              static_cast<cuuint64_t>(Dp),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2 * plane, 2 * plane * Hp,
                                 2 * plane * Hp * Dp};
  const cuuint32_t box[4] = {kBoxW, 5, 5, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(res);
}

int launch_mma(const void* x, const void* w, const void* bias, void* zs,
               void* pooled, void* partials, void* s1, void* s2,
               void* wscratch, int B, int Dp, int Hp, int Wp, int F,
               int do_pool, int do_stats, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return cudaErrorMisalignedAddress;  // TMA reads a 16-byte aligned base
  }
  const Plan p = plan(Dp, Hp, Wp, true);
  const int nblk = p.ndt * p.nht * p.nwt;
  MmaConfig c;
  cudaError_t err = mma_config(B, Dp, Hp, Wp, F, &c);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  CUtensorMap xmap;
  const int rc = x_tensor_map(x, B, Dp, Hp, Wp, &xmap);
  if (rc != 0) {
    return rc;
  }
  stem_wprep_mma_kernel<<<(F * kMmaK + 255) / 256, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(wscratch), F);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  stem_fwd_mma_kernel<<<c.grid, c.threads, c.smem, stream>>>(
      xmap, static_cast<const __nv_bfloat16*>(wscratch),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(zs), static_cast<__nv_bfloat16*>(pooled),
      static_cast<double*>(partials), B, Dp, Hp, Wp, F, p.nht, p.nwt,
      do_pool, do_stats);
  err = cudaGetLastError();
  if (err != cudaSuccess || !do_stats) {
    return static_cast<int>(err);
  }
  stem_stats_finalize_kernel<<<B, 2 * F, 0, stream>>>(
      static_cast<const double*>(partials), static_cast<float*>(s1),
      static_cast<float*>(s2), nblk, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* zs,
           void* pooled, void* partials, void* s1, void* s2, void* wscratch,
           int B, int Dp, int Hp, int Wp, int F, int do_pool, int do_stats,
           cudaStream_t stream) {
  const Plan p = plan(Dp, Hp, Wp, false);
  const int nblk = p.ndt * p.nht * p.nwt;
  stem_wprep_kernel<T><<<(kTaps * F + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(w), static_cast<float*>(wscratch), F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int WS = 3 * p.nwg_tile + 2;
  size_t tile = static_cast<size_t>(5 * 5 * 8 * WS) * sizeof(T);
  const size_t red = static_cast<size_t>(2 * p.nwg_tile * F) * sizeof(double);
  if (red > tile) {
    tile = red;
  }
  const size_t smem = kTaps * F * sizeof(float) + tile;
  err = cudaFuncSetAttribute(stem_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid(nblk, B);
  stem_fwd_kernel<T><<<grid, (F / kFc) * p.nwg_tile, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(wscratch),
      static_cast<const T*>(bias), static_cast<T*>(zs), static_cast<T*>(pooled),
      static_cast<double*>(partials), Dp, Hp, Wp, F, p.nwg, p.nwg_tile, p.nht,
      p.nwt, do_pool, do_stats);
  err = cudaGetLastError();
  if (err != cudaSuccess || !do_stats) {
    return static_cast<int>(err);
  }
  stem_stats_finalize_kernel<<<B, 2 * F, 0, stream>>>(
      static_cast<const double*>(partials), static_cast<float*>(s1),
      static_cast<float*>(s2), nblk, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tiles per sample of the statistics partials ([B, tiles, 2, F] f64), for
// phased extents (Dp, Hp, Wp), F channels and the working type.
extern "C" int nidt_stem_fwd_blocks(int Dp, int Hp, int Wp, int F, int bf16) {
  const Plan p = plan(Dp, Hp, Wp, use_mma(F, bf16));
  return p.ndt * p.nht * p.nwt;
}

// The tensor-core path's launch at these shapes (bf16, F = 16, 32 or 64):
// out = {grid, tiles, threads, dynamic shared memory bytes, blocks per SM}.
// Returns a cudaError_t.
extern "C" int nidt_stem_fwd_config(int B, int Dp, int Hp, int Wp, int F,
                                    int* out) {
  if (!use_mma(F, 1) || B < 1 || Dp < 3 || Hp < 3 || Wp < 3) {
    return cudaErrorInvalidValue;
  }
  MmaConfig c{};
  const cudaError_t err = mma_config(B, Dp, Hp, Wp, F, &c);
  out[0] = c.grid;
  out[1] = c.tiles;
  out[2] = c.threads;
  out[3] = c.smem;
  out[4] = c.per_sm;
  return static_cast<int>(err);
}

// x: (B, Dp, Hp, 8, Wp), w: (F, 8, 3, 3, 3), bias: (F,) or null, all in T
// (bf16 when bf16 != 0, else f32) and contiguous. Outputs, contiguous:
// zs (B, Dp-2, Hp-2, Wp-2, F) in T; pooled (B, D/3, H/3, W/3, F) in T when
// do_pool; partials [B, blocks, 2, F] f64 and s1, s2 (B, F) f32 when
// do_stats; wscratch [216, F] f32 (16-byte aligned, as zs and pooled; the
// tensor-core path uses 224 F bf16 of it; it also reads x by TMA, so x
// must start on a 16-byte boundary there).
// Returns the first CUDA error of the launches (0 when all were queued), or,
// when x's tensor map is refused, 10000 + the CUresult.
extern "C" int nidt_stem_fwd(const void* x, const void* w, const void* bias,
                             void* zs, void* pooled, void* partials, void* s1,
                             void* s2, void* wscratch, int B, int Dp, int Hp,
                             int Wp, int F, int bf16, int do_pool,
                             int do_stats, void* stream) {
  if (B < 1 || Dp < 3 || Hp < 3 || Wp < 3 || F < kFc || F > kMaxF ||
      F % kFc != 0 || (do_pool && pooled == nullptr) ||
      (do_stats && (partials == nullptr || s1 == nullptr || s2 == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_mma(F, bf16)) {
    return launch_mma(x, w, bias, zs, pooled, partials, s1, s2, wscratch, B,
                      Dp, Hp, Wp, F, do_pool, do_stats, st);
  }
  if (bf16) {
    return launch<__nv_bfloat16>(x, w, bias, zs, pooled, partials, s1, s2,
                                 wscratch, B, Dp, Hp, Wp, F, do_pool, do_stats,
                                 st);
  }
  return launch<float>(x, w, bias, zs, pooled, partials, s1, s2, wscratch, B,
                       Dp, Hp, Wp, F, do_pool, do_stats, st);
}
