#!/usr/bin/env python3
"""A kernel of the port against another version of itself, on one GPU.

    python3 scripts/stem_kernel_ab.py --kernel stem_fwd --other OTHER/stem_fwd.cu
    python3 scripts/stem_kernel_ab.py --kernel stem_bwd --other OTHER/stem_bwd.cu
    python3 scripts/stem_kernel_ab.py --kernel quantize_reduce \
        --other OTHER/quantize_reduce.cu

Builds ``neuroimagedisttraining_torch/csrc/<kernel>.cu`` (through
``kernels.build``) and ``--other`` (another version of the same source, for
example the parent commit's, unpacked with ``git archive``) side by side,
plus phase ablations of each: copies of the source with a phase cut out (or
a constant changed) by a textual patch, so that the time of what is left
can be read beside the whole. A patch whose anchor text is not in a source
is skipped and reported.

Prints one JSON line per shape: each version's outputs compared bitwise
with the other's and with a second launch of itself. At the main path's
shapes it also times the two versions in turns (other, this, this, other)
and every ablation: median of 30 CUDA-event timings, each queued behind a
device-side sleep. Then the ptxas report of each build, and the card's name
and power limit.

* ``stem_fwd``: ``zs``, ``pooled``, ``s1``, ``s2`` and the persistent
  launch, at seven phased shapes; the main one is 8 phased 121x145x121
  volumes, F = 64.
* ``stem_bwd``: ``dzs`` under both tie rules (bf16 and f32), and this
  version's bias gradient against the plain sum of its ``dzs`` (within one
  ulp, or 1e-5 of the channel's sum of magnitudes where it cancels), at
  eight ``zs`` shapes; the main one is the stem's ``zs`` (8, 59, 71, 59,
  64) bf16. There it also times the fused bias gradient against
  the kernel plus ``dzs.sum``, and a device-to-device copy of the bound's
  523 MB (half read, half written) as the practical ceiling.
* ``quantize_reduce``: the int8 wire's aggregate, against the other
  version and the plain version (and each variant against the plain one),
  at eight ``[C, nb, b]`` shapes (1 to 33 clients, b = 1000, 1001, 1024,
  262144, an all-zero bucket, a quarter of the values +0.0 or -0.0); the
  main one is ``[8, 10, 262144]``, timed on masked inputs (half the values
  zero, as a SalientGrads wire sends them) and on dense ones. There it
  also times this version's scalar path on the same inputs and a
  device-to-device copy of the bound's 178 MB. Either C entry is bound:
  this tree's (a bucket-aligned grid, one launch per 16 clients) or the
  grid-stride one before it.

Needs one GPU; exits 2 without one, 1 if any comparison differs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# -- stem_fwd: ablations of the block-per-tile kernel and the persistent one
_FILL = "  // the halo, phases innermost: x_s[id][ih][iw][p]\n"
_FILL_END = ("    x_s[((id * 5 + ih) * kXCols + iw) * 8 + p] = v;\n  }\n")
_PROD = ("  const uint32_t* x32 = reinterpret_cast<const uint32_t*>(x_s);\n"
         "  for (int r = 0; r < 9; ++r) {\n")
_PROD_END = ("        o_s[(r * kMmaPos + pos + (i & 1)) * FP + (i < 2 ? ch0 : "
             "ch1)] =\n            __float2bfloat16_rn(v);\n      }\n    }\n"
             "  }\n  __syncthreads();\n")
_EPI_CUT = ("  __syncthreads();\n  if (tid == 0) zs[blockIdx.x] = "
            "__hadd(x_s[blockIdx.x % 64], o_s[blockIdx.x % 64]);\n"
            "  return;\n")
_LOOP_EPI = ("    // zs out in 16-byte vectors, and this thread's sums (fixed "
             "channel chunk)\n    const int npos")
_SKIP_EPI = ("    if (F > 0) {\n      mbar_arrive(bars + 24 + 8 * k);\n"
             "      continue;\n    }\n")
_LOOP_PROD = "      for (int r = 0; r < 9; ++r) {\n        const int ld = r / 3"
_TRANSPOSE = "      for (int j = tid; j < 5 * 5 * kXCols; j += G) {"
_ZS_STORE = ("      *reinterpret_cast<uint4*>(\n          zs + (((static_cast"
             "<long long>(b)")
_STATS = "        const double e = fv.x, od = fv.y;"
_POOL = "    if (do_pool && dt < PD && ht < PH) {"
FWD_ABLATIONS = {
    # the block-per-tile kernel: one phase kept
    "fill_only": [(_PROD, "#if 0\n" + _PROD),
                  (_PROD_END, _PROD_END.replace("  __syncthreads();\n", "")
                   + "#endif\n" + _EPI_CUT)],
    "products_only": [(_FILL, "#if 0\n" + _FILL),
                      (_FILL_END, _FILL_END + "#endif\n"),
                      (_PROD_END, _PROD_END.replace("  __syncthreads();\n",
                                                    "") + _EPI_CUT)],
    "epilogue_only": [(_FILL, "#if 0\n" + _FILL),
                      (_FILL_END, _FILL_END + "#endif\n"),
                      (_PROD, "#if 0\n" + _PROD),
                      (_PROD_END, _PROD_END.replace("  __syncthreads();\n",
                                                    "")
                       + "#endif\n  __syncthreads();\n")],
    # the persistent two-group kernel: one phase cut
    "no_epilogue": [(_LOOP_EPI, _SKIP_EPI + _LOOP_EPI)],
    "no_products": [(_LOOP_PROD, _LOOP_PROD.replace("r < 9", "r < 0"))],
    "fetch_and_transpose_only": [
        (_LOOP_PROD, _LOOP_PROD.replace("r < 9", "r < 0")),
        (_LOOP_EPI, _SKIP_EPI + _LOOP_EPI)],
    "fetch_only": [
        (_TRANSPOSE, _TRANSPOSE.replace("j < 5 * 5 * kXCols", "j < 0")),
        (_LOOP_PROD, _LOOP_PROD.replace("r < 9", "r < 0")),
        (_LOOP_EPI, _SKIP_EPI + _LOOP_EPI)],
    "no_zs_store": [(_ZS_STORE, _ZS_STORE.replace(
        "      *", "      if (F < 0) *"))],
    "no_statistics": [(_STATS, _STATS + "\n        if (F > 0) continue;")],
    "no_pool": [(_POOL, _POOL.replace("if (", "if (F < 0 && "))],
}
FWD_SHAPES = (((8, 61, 73, 8, 61), 64), ((8, 38, 38, 8, 40), 64),
              ((2, 9, 10, 8, 140), 16), ((2, 10, 8, 8, 70), 32),
              ((3, 12, 14, 8, 13), 64), ((1, 8, 9, 8, 101), 64),
              ((1, 5, 5, 8, 5), 64))

# -- stem_bwd: ablations of the two-pass grid-stride kernel (pass 1 or pass
# 2 alone) and of the slab kernel (loads only; loads and the tie pass; loads
# and stores without the pool term), and variants of its constants (the
# stage reuse, ring depth, a register cap of two blocks per SM)
_P2 = ("    for (int k = 0; k < 27; ++k) {\n      const int d = 3 * cd + k / 9,"
       " h = 3 * ch + (k / 3) % 3,\n                w = 3 * cw + k % 3;\n"
       "      if (d >= D")
_P2_CUT = ("    if (F > 0) {\n      int sink = 0;\n"
           "      for (int f = 0; f < kFc; ++f) sink += 32 * count[f] + "
           "first[f];\n      if (sink == -12345) out[i % 64] = zs[0];\n"
           "      continue;\n    }\n")
_P1 = "    if (full) {\n      const long long at =\n"
_WAIT = "      mbar_wait_or_trap(full_bar + 8 * s, (i / S::kRing) & 1);\n"
_RELEASE = ("      if (F > 0) {\n        __syncwarp();\n"
            "        if (lane == 0) mbar_arrive(done_bar + 8 * s);\n"
            "        continue;\n      }\n")
_STORE = "        tma_store_5d(&omap,"
_NO_STORE = "        if (F < 0) tma_store_5d(&omap,"
_PASS2 = ("#pragma unroll\n        for (int k = 0; k < 27; ++k) {\n"
          "          const float2 v = P::f(z[k]);\n          const bool hit0")
_PASS1 = ("        if (full) {\n#pragma unroll\n          for (int k = 0; "
          "k < 27; ++k) {\n            const float2 v = P::f(z[k]);\n"
          "            const bool e0")
BWD_ABLATIONS = {
    "pass1_only": [(_P2, _P2_CUT + _P2)],
    "pass2_only": [(_P1, _P1.replace("(full)", "(full && F < 0)"))],
    "loads_only": [(_WAIT, _WAIT + _RELEASE), (_STORE, _NO_STORE)],
    "loads_and_tie_pass": [
        (_PASS2, "        if (first0 + first1 + count0 + count1 == -7) "
                 "zp[0] = z[0];\n" + _PASS2.replace("k < 27", "k < 0")),
        (_STORE, _NO_STORE)],
    "no_pool_term": [(_PASS1, _PASS1.replace("(full)", "(full && F < 0)"))],
    "defer_0": [("kDefer = 1;", "kDefer = 0;")],
    "stages_3": [("kStages = 4;", "kStages = 3;")],
    "stages_5": [("kStages = 4;", "kStages = 5;")],
    "stages_7": [("kStages = 4;", "kStages = 7;")],
    "register_cap": [("__launch_bounds__(kThreads)\n    stem_bwd_kernel("
                      "const __grid_constant__",
                      "__launch_bounds__(kThreads, 2)\n    stem_bwd_kernel("
                      "const __grid_constant__")],
}
#: zs shapes (B, D, H, W, F): the main path's, then D, H, W = 0, 1, 2 mod
#: 3, W spanning several w-chunks and a ragged one, one window, no window
BWD_SHAPES = ((8, 59, 71, 59, 64), (2, 9, 10, 11, 64), (2, 10, 11, 9, 16),
              (1, 11, 9, 99, 48), (2, 8, 7, 101, 64), (1, 3, 3, 3, 8),
              (1, 4, 5, 200, 8), (2, 2, 4, 5, 16))


def _patched(src: str, patches):
    for anchor, repl in patches:
        if src.count(anchor) != 1:
            return None
        src = src.replace(anchor, repl)
    return src


def _device_ms(fn, reps: int = 30, warmup: int = 3, label=None) -> float:
    """Median device time of ``fn`` in ms; with ``label``, also printed
    to stderr as it comes (a variant that faults leaves the others')."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    if label is not None:
        print(f"{label}: {statistics.median(times)}", file=sys.stderr,
              flush=True)
    return statistics.median(times)


def _same(xs, ys):
    return [None if a is None else bool(a.equal(b)) for a, b in zip(xs, ys)]


# -- stem_fwd -----------------------------------------------------------------

def _bind_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.nidt_stem_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                                  + [ctypes.c_void_p])
    lib.nidt_stem_fwd.restype = ctypes.c_int
    lib.nidt_stem_fwd_blocks.argtypes = [ctypes.c_int] * 5
    lib.nidt_stem_fwd_blocks.restype = ctypes.c_int
    return lib


def _run_fwd(lib, x, w, bias, pool=True, stats=True):
    """One launch of a built ``stem_fwd.cu`` through its C entry, as
    ``kernels.stem_fwd`` launches it."""
    import torch

    b, dp, hp, _, wp = x.shape
    f = w.shape[0]
    d, h, wd = dp - 2, hp - 2, wp - 2
    dev = x.device
    zs = torch.empty((b, d, h, wd, f), dtype=x.dtype, device=dev)
    pooled = (torch.empty((b, d // 3, h // 3, wd // 3, f), dtype=x.dtype,
                          device=dev) if pool else None)
    partials = s1 = s2 = None
    if stats:
        n = lib.nidt_stem_fwd_blocks(dp, hp, wp, f, 1)
        partials = torch.empty((b, n, 2, f), dtype=torch.float64, device=dev)
        s1 = torch.empty((b, f), device=dev)
        s2 = torch.empty((b, f), device=dev)
    wscr = torch.empty((216, f), device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.nidt_stem_fwd(
        x.data_ptr(), w.data_ptr(), ptr(bias), zs.data_ptr(), ptr(pooled),
        ptr(partials), ptr(s1), ptr(s2), wscr.data_ptr(), b, dp, hp, wp, f,
        1, int(pool), int(stats), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stem_fwd launch failed: {rc}")
    return zs, pooled, s1, s2


def _fwd_inputs(g, dev, shape, f):
    import torch

    bf = torch.bfloat16
    x = torch.randn(shape, generator=g, device=dev).to(bf)
    shift = (torch.rand(shape[0], generator=g, device=dev) < 0.5).to(bf)
    x += (shift * 1.5 - 0.75).reshape(-1, 1, 1, 1, 1)
    w = (0.05 * torch.randn((f, 8, 3, 3, 3), generator=g, device=dev)).to(bf)
    bias = (0.1 * torch.randn(f, generator=g, device=dev)).to(bf)
    return x, w, bias


def ab_fwd(libs) -> bool:
    import torch

    from neuroimagedisttraining_torch.ops import kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for shape, f in FWD_SHAPES:
        x, w, bias = _fwd_inputs(g, dev, shape, f)
        rec = {"shape": list(shape), "F": f}
        for label, kw, bb in (("with_bias", {}, bias),
                              ("conv_only", dict(pool=False, stats=False),
                               None)):
            mine = kernels.stem_fwd(x, w, bb, **kw)
            again = kernels.stem_fwd(x, w, bb, **kw)
            theirs = _run_fwd(libs["other"], x, w, bb, **kw)
            torch.cuda.synchronize()
            rec[label] = dict(bitwise_vs_other=_same(mine, theirs),
                              repeat_bitwise=_same(mine, again))
            ok &= all(v in (True, None) for v in
                      rec[label]["bitwise_vs_other"]
                      + rec[label]["repeat_bitwise"])
        rec["launch"] = kernels.stem_fwd_config(shape[0], shape[1],
                                                shape[2], shape[4], f)
        if (shape, f) == FWD_SHAPES[0]:
            ms = {}
            for lab, fn in (
                    ("other_a", lambda: _run_fwd(libs["other"], x, w, bias)),
                    ("this_a", lambda: kernels.stem_fwd(x, w, bias)),
                    ("this_b", lambda: kernels.stem_fwd(x, w, bias)),
                    ("other_b", lambda: _run_fwd(libs["other"], x, w, bias))):
                ms[lab] = _device_ms(fn)
            for name, lib in libs.items():
                if "/" in name:
                    ms[name] = _device_ms(
                        lambda lib=lib: _run_fwd(lib, x, w, bias))
            ms["this_conv_only"] = _device_ms(lambda: kernels.stem_fwd(
                x, w, None, pool=False, stats=False))
            ms["other_conv_only"] = _device_ms(lambda: _run_fwd(
                libs["other"], x, w, None, pool=False, stats=False))
            rec["ms"] = ms
        print(json.dumps(rec), flush=True)
    return ok


# -- stem_bwd -----------------------------------------------------------------

def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Either C entry: the slab kernel's (bias gradient, a config query) or
    the two-pass kernel's before it (a block count)."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "nidt_stem_bwd_config"):
        lib.nidt_stem_bwd.argtypes = [vp] * 8 + [i32] * 7 + [vp]
        lib.nidt_stem_bwd_config.argtypes = [i32] * 6 + [ctypes.POINTER(i32)]
        lib.nidt_stem_bwd_config.restype = i32
    else:
        lib.nidt_stem_bwd.argtypes = [vp] * 6 + [i32] * 8 + [vp]
    lib.nidt_stem_bwd.restype = i32
    return lib


def _run_bwd(lib, zs, pooled, gp, g1, g2, ties, bias_grad=False):
    """One launch of a built ``stem_bwd.cu`` through its C entry, as its
    version of ``kernels.stem_bwd`` launches it."""
    import torch

    b, d, h, w, f = zs.shape
    dev = zs.device
    out = torch.empty_like(zs)
    bf16 = int(zs.dtype == torch.bfloat16)
    split = int(ties == "split")
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "nidt_stem_bwd_config"):
        partials = dbias = None
        if bias_grad:
            cfg = (ctypes.c_int * 6)()
            rc = lib.nidt_stem_bwd_config(b, d, h, w, f, bf16, cfg)
            if rc != 0:
                raise RuntimeError(f"stem_bwd config failed: {rc}")
            partials = torch.empty((cfg[0], f), dtype=torch.float64,
                                   device=dev)
            dbias = torch.empty((f,), dtype=zs.dtype, device=dev)
        rc = lib.nidt_stem_bwd(
            zs.data_ptr(), pooled.data_ptr(), gp.data_ptr(), g1.data_ptr(),
            g2.data_ptr(), out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if dbias is None else dbias.data_ptr(), b, d, h, w, f, bf16,
            split, stream)
        res = (out, dbias) if bias_grad else out
    else:
        cells = b * (-(-d // 3)) * (-(-h // 3)) * (-(-w // 3)) * (f // 8)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rc = lib.nidt_stem_bwd(
            zs.data_ptr(), pooled.data_ptr(), gp.data_ptr(), g1.data_ptr(),
            g2.data_ptr(), out.data_ptr(), b, d, h, w, f, bf16, split,
            max(1, min(-(-cells // 256), 32 * sms)), stream)
        res = out
    if rc != 0:
        raise RuntimeError(f"stem_bwd launch failed: {rc}")
    return res


def _bwd_inputs(g, dev, shape, dtype):
    """zs with ties (values on a grid of 1/4), its max-pool, cotangents."""
    import torch
    import torch.nn.functional as F

    zs = (torch.round(4 * torch.randn(shape, generator=g, device=dev)) / 4
          ).to(dtype)
    b, d, h, w, f = shape
    if min(d, h, w) >= 3:
        pooled = F.max_pool3d(zs.permute(0, 4, 1, 2, 3), 3, 3).permute(
            0, 2, 3, 4, 1).contiguous()
    else:  # no whole window
        pooled = zs.new_empty((b, d // 3, h // 3, w // 3, f))
    gp = torch.randn(pooled.shape, generator=g, device=dev).to(dtype)
    g1 = torch.randn((shape[0], shape[4]), generator=g, device=dev)
    g2 = 1e-3 * torch.randn((shape[0], shape[4]), generator=g, device=dev)
    return zs, pooled, gp, g1, g2


def _main_bwd_inputs(g, dev):
    """The stem's zs at the main path's shapes (8 phased 121x145x121
    volumes, F = 64, bf16; the plain forward's, so that it needs no kernel
    of this tree), its pool, and cotangents."""
    import torch

    from neuroimagedisttraining_torch.ops import kernels

    x, w, bias = _fwd_inputs(g, dev, FWD_SHAPES[0][0], FWD_SHAPES[0][1])
    zs, pooled, s1, _ = kernels.stem_fwd_plain(x, w, bias)
    gp = torch.randn(pooled.shape, generator=g, device=dev).to(zs.dtype)
    g1 = torch.randn(s1.shape, generator=g, device=dev)
    g2 = 1e-3 * torch.randn(s1.shape, generator=g, device=dev)
    return zs, pooled, gp, g1, g2


def ab_bwd(libs, this_built: bool = True) -> bool:
    import torch

    from neuroimagedisttraining_torch.ops import kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    if not this_built:  # the other version and its ablations alone
        args = _main_bwd_inputs(g, dev)
        ms = {name: _device_ms(lambda lib=lib: _run_bwd(lib, *args, "first"))
              for name, lib in libs.items()}
        print(json.dumps({"shape": list(BWD_SHAPES[0]), "ms": ms}),
              flush=True)
        return False
    ok = True
    for shape in BWD_SHAPES:
        main = shape == BWD_SHAPES[0]
        for dtype in ((torch.bfloat16,) if main else
                      (torch.bfloat16, torch.float32)):
            args = (_main_bwd_inputs(g, dev) if main else
                    _bwd_inputs(g, dev, shape, dtype))
            rec = {"shape": list(shape), "dtype": str(dtype)}
            for ties in kernels.STEM_TIES:
                mine = kernels.stem_bwd(*args, ties=ties)
                again = kernels.stem_bwd(*args, ties=ties)
                theirs = _run_bwd(libs["other"], *args, ties)
                plain = kernels.stem_bwd_plain(*args, ties=ties)
                fused, dbias = kernels.stem_bwd(*args, ties=ties,
                                                bias_grad=True)
                _, dbias2 = kernels.stem_bwd(*args, ties=ties,
                                             bias_grad=True)
                torch.cuda.synchronize()
                ulp, worst = kernels.dbias_agreement(dbias, mine)
                rec[ties] = dict(
                    bitwise_vs_other=bool(mine.equal(theirs)),
                    bitwise_vs_plain=bool(mine.equal(plain)),
                    repeat_bitwise=bool(mine.equal(again)),
                    bias_grad_dzs_bitwise=bool(fused.equal(mine)),
                    dbias_repeat_bitwise=bool(dbias.equal(dbias2)),
                    dbias_max_ulp=ulp, dbias_err_over_magnitude=worst)
                ok &= all(v for k, v in rec[ties].items()
                          if isinstance(v, bool)) and worst <= 1e-5
            rec["launch"] = kernels.stem_bwd_config(*shape, dtype)
            print(json.dumps(rec), flush=True)
            if main:
                print(json.dumps({"shape": list(shape),
                                  "ms": _time_bwd(libs, args)}), flush=True)
    return ok


def _time_bwd(libs, args):
    import torch

    from neuroimagedisttraining_torch.ops import kernels

    zs = args[0]
    ms = {}
    for lab, fn in (
            ("other_a", lambda: _run_bwd(libs["other"], *args, "first")),
            ("this_a", lambda: kernels.stem_bwd(*args, ties="first")),
            ("this_b", lambda: kernels.stem_bwd(*args, ties="first")),
            ("other_b", lambda: _run_bwd(libs["other"], *args, "first"))):
        ms[lab] = _device_ms(fn)
    ms["this_split"] = _device_ms(lambda: kernels.stem_bwd(*args,
                                                           ties="split"))
    ms["this_bias_grad"] = _device_ms(lambda: kernels.stem_bwd(
        *args, ties="first", bias_grad=True))
    dzs = kernels.stem_bwd(*args, ties="first")
    ms["sum"] = _device_ms(lambda: dzs.sum(dim=(0, 1, 2, 3)))
    ms["this_then_sum"] = _device_ms(lambda: kernels.stem_bwd(
        *args, ties="first").sum(dim=(0, 1, 2, 3)))
    # the practical ceiling: the bound's bytes as one copy
    nbytes = 2 * (2 * zs.numel() + 2 * args[1].numel())
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=zs.device)
    dst = torch.empty_like(src)
    ms["copy_523MB"] = _device_ms(lambda: dst.copy_(src))
    ms["copy_bytes"] = nbytes
    del src, dst
    for name, lib in libs.items():
        if "/" in name:
            ms[name] = _device_ms(
                lambda lib=lib: _run_bwd(lib, *args, "first"), label=name)
    return ms


# -- quantize_reduce: variants of the bucket-aligned kernel -------------------
_QR_BLOCKS = "  return C <= 8 ? 2 : 1;"
_QR_DIV = ("  const bool z = x == 0.0f && fabsf(s) < INFINITY && s != 0.0f;"
           "\n  const float y = z ? __fmul_rn(x, s) : __fdiv_rn(z ? s : x, s);"
           "\n")
QR_ABLATIONS = {
    "groups_2": [("kGroups = 1;", "kGroups = 2;")],
    "threads_128": [("kThreads = 256;", "kThreads = 128;"),
                    (_QR_BLOCKS, "  return C <= 8 ? 4 : 2;")],
    "natural_registers": [(_QR_BLOCKS, "  return 1;")],
    "no_streaming_hint": [("xv[g][c] = __ldcs(", "xv[g][c] = __ldg("),
                          ("uv[g][c] = __ldcs(", "uv[g][c] = __ldg(")],
    # every zero numerator divided, down the division's slow path
    "no_zero_shortcut": [(_QR_DIV, "  const float y = __fdiv_rn(x, s);\n")],
    # not bitwise: how much of the time the IEEE division takes
    "no_divide": [(_QR_DIV, "  const float y = __fmul_rn(x, s);\n")],
}
#: the main shape's shares of zero values: the masked wire's (a SalientGrads
#: mask keeps half of every kernel leaf) and none
QR_ZERO_SHARES = (0.5, 0.0)
#: [C, nb, b]: the main path's, then b = 1000, 1001, 1024 and 262144 at 1 to
#: 33 clients
QR_SHAPES = ((8, 10, 262144), (8, 3, 1000), (8, 3, 1001), (1, 2, 1024),
             (3, 4, 1001), (16, 2, 262144), (17, 3, 4096), (33, 2, 1000))


def _bind_qr(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Either C entry: this tree's (one launch per client chunk on a
    bucket-aligned grid, a tile query) or the grid-stride one before it."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if hasattr(lib, "nidt_quantize_reduce_tile"):
        lib.nidt_quantize_reduce.argtypes = [vp] * 5 + [i32] * 8 + [vp]
        lib.nidt_quantize_reduce_tile.argtypes = []
        lib.nidt_quantize_reduce_tile.restype = i32
    else:
        lib.nidt_quantize_reduce.argtypes = [vp] * 5 + [i32, i64, i64, i32,
                                                        vp]
    lib.nidt_quantize_reduce.restype = i32
    return lib


def _run_qr(lib, x, w, u, s, vec=None):
    """One call of a built ``quantize_reduce.cu`` through its C entry, as
    its version of ``kernels.fused_quantize_reduce`` launches it; ``vec``
    overrides the plan's path (this tree's entry only)."""
    import torch

    from neuroimagedisttraining_torch.ops import kernels

    c, nb, b = x.shape
    out = torch.empty((nb, b), device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), u.data_ptr(), s.data_ptr(), w.data_ptr(),
            out.data_ptr())
    if hasattr(lib, "nidt_quantize_reduce_tile"):
        plan = kernels.quantize_reduce_plan(
            c, nb, b, [x.data_ptr(), u.data_ptr(), out.data_ptr()],
            tile=lib.nidt_quantize_reduce_tile())
        path = plan["vec"] if vec is None else vec
        for c0, chunk in plan["chunks"]:
            rc = lib.nidt_quantize_reduce(*ptrs, c, nb, b, c0, chunk,
                                          int(path), *plan["grid"], stream)
            if rc != 0:
                break
    else:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        rc = lib.nidt_quantize_reduce(
            *ptrs, c, nb, b, max(1, min(-(-(nb * b) // 256), 32 * sms)),
            stream)
    if rc != 0:
        raise RuntimeError(f"quantize_reduce launch failed: {rc}")
    return out


def _qr_inputs(g, dev, shape, zero_share=0.0):
    """Buckets with per-bucket scales spread over decades, bucket 0 all
    zero, a ``zero_share`` of the rest zero (+0.0 and -0.0, as a masked
    model sends them), uniforms, the wire's scales and normalised
    weights."""
    import torch

    from neuroimagedisttraining_torch.parallel import collectives as tc

    c, nb, b = shape
    x = torch.randn(shape, generator=g, device=dev) * torch.exp(
        2 * torch.randn((c, nb, 1), generator=g, device=dev))
    if zero_share:
        r = torch.rand(shape, generator=g, device=dev)
        x = torch.where(r < zero_share, torch.where(r < zero_share / 8,
                                                    -0.0, 0.0), x)
    x[:, 0] = 0.0
    u = torch.rand(shape, generator=g, device=dev)
    s = tc._int8_scale(x)[..., 0].contiguous()
    w = torch.rand(c, generator=g, device=dev)
    return x, w / w.sum(), u, s


def _qr_time(libs, args):
    """The two versions in turns (other, this, this, other), this
    version's scalar path and every variant, on ``args``."""
    from neuroimagedisttraining_torch.ops import kernels

    ms = {}
    for lab, fn in (
            ("other_a", lambda: _run_qr(libs["other"], *args)),
            ("this_a", lambda: kernels.fused_quantize_reduce(*args)),
            ("this_b", lambda: kernels.fused_quantize_reduce(*args)),
            ("other_b", lambda: _run_qr(libs["other"], *args))):
        ms[lab] = _device_ms(fn)
    ms["this_scalar_path"] = _device_ms(
        lambda: _run_qr(libs["this"], *args, vec=False))
    for name, lib in libs.items():
        if "/" in name:
            ms[name] = _device_ms(lambda lib=lib: _run_qr(lib, *args),
                                  label=name)
    return ms


def ab_qr(libs) -> bool:
    import torch

    from neuroimagedisttraining_torch.ops import kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ok = True
    cases = [(QR_SHAPES[0], share) for share in QR_ZERO_SHARES] + \
        [(shape, 0.25) for shape in QR_SHAPES[1:]]
    for shape, share in cases:
        args = _qr_inputs(g, dev, shape, share)
        x, w, u, s = args
        mine = kernels.fused_quantize_reduce(*args)
        again = kernels.fused_quantize_reduce(*args)
        scalar = _run_qr(libs["this"], *args, vec=False)
        theirs = _run_qr(libs["other"], *args)
        plain = kernels.quantize_reduce_plain(x, w, u, s)
        torch.cuda.synchronize()
        rec = {"shape": list(shape), "zero_share": share,
               "path": "16-byte" if kernels.quantize_reduce_plan(
                   *shape, [x.data_ptr(), u.data_ptr(), mine.data_ptr()]
               )["vec"] else "scalar",
               "bitwise_vs_other": bool(mine.equal(theirs)),
               "bitwise_vs_plain": bool(mine.equal(plain)),
               "scalar_path_bitwise": bool(scalar.equal(plain)),
               "repeat_bitwise": bool(mine.equal(again))}
        ok &= all(v for v in rec.values() if isinstance(v, bool))
        for name, lib in libs.items():
            if "/" in name and "no_divide" not in name:
                rec[f"bitwise_{name}"] = bool(_run_qr(lib, *args).equal(
                    plain))
        if shape == QR_SHAPES[0]:
            rec["ms"] = _qr_time(libs, args)
            if share == QR_ZERO_SHARES[0]:
                # the practical ceiling: the bound's bytes as one copy
                nbytes = 4 * (2 * x.numel() + mine.numel())
                src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
                dst = torch.empty_like(src)
                rec["ms"]["copy_bytes"] = nbytes
                rec["ms"]["copy"] = _device_ms(lambda: dst.copy_(src))
                del src, dst
        print(json.dumps(rec), flush=True)
    return ok


def _ptxas_by_entry(log: str):
    """``nvcc -Xptxas -v``'s register and spill lines, each after the name
    of the entry function it is for."""
    out = []
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            out.append(ln.split("'")[1] if "'" in ln else ln.strip())
        elif "registers" in ln or "spill" in ln:
            out.append(ln.strip())
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(KERNELS), default="stem_fwd")
    ap.add_argument("--other", required=True,
                    help="another version of csrc/<kernel>.cu")
    ap.add_argument("--out", default=str(ROOT / "neuroimagedisttraining_torch"
                                         / "_build" / "stem_ab"),
                    help="directory for the built variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stem_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    from neuroimagedisttraining_torch.ops import kernels

    ablations, bind = KERNELS[args.kernel]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    this_src = (kernels.CSRC / kernels.SOURCES[args.kernel]).read_text()
    sources = {"other": Path(args.other).read_text()}
    skipped = []
    for side, src in (("other", sources["other"]), ("this", this_src)):
        for name, patches in ablations.items():
            text = _patched(src, patches)
            if text is None:
                skipped.append(f"{side}/{name}")
            else:
                sources[f"{side}/{name}"] = text
    procs = {}
    for name, text in sources.items():
        cu = out / (args.kernel + "_" + name.replace("/", "_") + ".cu")
        cu.write_text(text)
        procs[name] = (cu, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
             "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    try:
        kernels.build()
    except RuntimeError as e:
        print(json.dumps({"build_failed": "this", "log": str(e)[-3000:]}),
              flush=True)
        failed.append("this")
    libs, ptxas = {}, {"this": kernels.BUILD_LOG.get(args.kernel, "")}
    for name, (cu, proc) in procs.items():
        o, e = proc.communicate()
        ptxas[name] = o + e
        if proc.returncode:
            print(json.dumps({"build_failed": name, "log": e[-3000:]}),
                  flush=True)
            failed.append(name)
            continue
        libs[name] = bind(ctypes.CDLL(str(cu.with_suffix(".so"))))
    if args.kernel == "stem_bwd":
        if "other" in failed:
            return 1
        ok = ab_bwd(libs, "this" not in failed)
    elif args.kernel == "stem_fwd":
        if failed:
            return 1
        ok = ab_fwd(libs)
    else:
        if "other" in failed or "this" in failed:
            return 1
        libs["this"] = bind(kernels._lib("quantize_reduce"))
        ok = ab_qr(libs)
    print(json.dumps({"ablations_skipped": skipped, "build_failed": failed,
                      "ptxas": {k: _ptxas_by_entry(v)
                                for k, v in ptxas.items()}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"all_bitwise": ok}), flush=True)
    return 0 if ok and not failed else 1


#: --kernel: its ablations and the binder of a built variant
KERNELS = {"stem_fwd": (FWD_ABLATIONS, _bind_fwd),
           "stem_bwd": (BWD_ABLATIONS, _bind_bwd),
           "quantize_reduce": (QR_ABLATIONS, _bind_qr)}


if __name__ == "__main__":
    sys.exit(main())
