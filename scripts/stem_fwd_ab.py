#!/usr/bin/env python3
"""The stem forward kernel against another version of itself, on one GPU.

    python3 scripts/stem_fwd_ab.py --other OTHER/stem_fwd.cu [--out DIR]

Builds ``neuroimagedisttraining_torch/csrc/stem_fwd.cu`` (through
``kernels.build``) and ``--other`` (another version of the same source, for
example the parent commit's, unpacked with ``git archive``) side by side,
plus phase ablations of each: copies of the source with a phase cut out by
a textual patch (the halo fill, the products, the epilogue or a part of
it), so that the time of what is left can be read beside the whole. A patch whose anchor text is not
in a source is skipped and reported.

Prints one JSON line per shape: each version's ``zs``, ``pooled``, ``s1``
and ``s2`` compared bitwise with the other's and with a second launch of
itself, and the persistent launch's grid, tiles and shared memory. At the
main path's shapes (8 phased 121x145x121 volumes, F = 64) it also times the
two versions in turns (other, this, this, other) and every ablation: median
of 30 CUDA-event timings, each queued behind a device-side sleep. Then the
ptxas report of each build, and the card's name and power limit. Needs one
GPU; exits 2 without one, 1 if any comparison differs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: phase ablations: variant -> (anchor, replacement) patches of the source
#: (the block-per-tile kernel that came before, and the persistent kernel)
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
ABLATIONS = {
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
SHAPES = (((8, 61, 73, 8, 61), 64), ((8, 38, 38, 8, 40), 64),
          ((2, 9, 10, 8, 140), 16), ((2, 10, 8, 8, 70), 32),
          ((3, 12, 14, 8, 13), 64), ((1, 8, 9, 8, 101), 64),
          ((1, 5, 5, 8, 5), 64))
MAIN = SHAPES[0]


def _patched(src: str, patches):
    for anchor, repl in patches:
        if src.count(anchor) != 1:
            return None
        src = src.replace(anchor, repl)
    return src


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.nidt_stem_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                                  + [ctypes.c_void_p])
    lib.nidt_stem_fwd.restype = ctypes.c_int
    lib.nidt_stem_fwd_blocks.argtypes = [ctypes.c_int] * 5
    lib.nidt_stem_fwd_blocks.restype = ctypes.c_int
    return lib


def _run(lib, x, w, bias, pool=True, stats=True):
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


def _same(xs, ys):
    return [None if a is None else bool(a.equal(b)) for a, b in zip(xs, ys)]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="another version of csrc/stem_fwd.cu")
    ap.add_argument("--out", default=str(ROOT / "neuroimagedisttraining_torch"
                                         / "_build" / "stem_ab"),
                    help="directory for the built variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stem_fwd_ab: CUDA is not available", file=sys.stderr)
        return 2
    from neuroimagedisttraining_torch.ops import kernels

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    this_src = (kernels.CSRC / "stem_fwd.cu").read_text()
    sources = {"other": Path(args.other).read_text()}
    skipped = []
    for side, src in (("other", sources["other"]), ("this", this_src)):
        for name, patches in ABLATIONS.items():
            text = _patched(src, patches)
            if text is None:
                skipped.append(f"{side}/{name}")
            else:
                sources[f"{side}/{name}"] = text
    procs = {}
    for name, text in sources.items():
        cu = out / (name.replace("/", "_") + ".cu")
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    kernels.build()
    libs, ptxas = {}, {"this": kernels.BUILD_LOG.get("stem_fwd", "")}
    for name, proc in procs.items():
        o, e = proc.communicate()
        ptxas[name] = o + e
        if proc.returncode:
            print(json.dumps({"build_failed": name, "log": e[-3000:]}),
                  flush=True)
            return 1
        libs[name] = _bind(out / (name.replace("/", "_") + ".so"))

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for shape, f in SHAPES:
        bf = torch.bfloat16
        x = torch.randn(shape, generator=g, device=dev).to(bf)
        shift = (torch.rand(shape[0], generator=g, device=dev) < 0.5).to(bf)
        x += (shift * 1.5 - 0.75).reshape(-1, 1, 1, 1, 1)
        w = (0.05 * torch.randn((f, 8, 3, 3, 3), generator=g,
                                device=dev)).to(bf)
        bias = (0.1 * torch.randn(f, generator=g, device=dev)).to(bf)
        rec = {"shape": list(shape), "F": f}
        for label, kw, bb in (("with_bias", {}, bias),
                              ("conv_only", dict(pool=False, stats=False),
                               None)):
            mine = kernels.stem_fwd(x, w, bb, **kw)
            again = kernels.stem_fwd(x, w, bb, **kw)
            theirs = _run(libs["other"], x, w, bb, **kw)
            torch.cuda.synchronize()
            rec[label] = dict(bitwise_vs_other=_same(mine, theirs),
                              repeat_bitwise=_same(mine, again))
            ok &= all(v in (True, None) for v in
                      rec[label]["bitwise_vs_other"]
                      + rec[label]["repeat_bitwise"])
        rec["launch"] = kernels.stem_fwd_config(shape[0], shape[1],
                                                shape[2], shape[4], f)
        if (shape, f) == MAIN:
            ms = {}
            for lab, fn in (
                    ("other_a", lambda: _run(libs["other"], x, w, bias)),
                    ("this_a", lambda: kernels.stem_fwd(x, w, bias)),
                    ("this_b", lambda: kernels.stem_fwd(x, w, bias)),
                    ("other_b", lambda: _run(libs["other"], x, w, bias))):
                ms[lab] = _device_ms(fn)
            for name, lib in libs.items():
                if "/" in name:
                    ms[name] = _device_ms(
                        lambda lib=lib: _run(lib, x, w, bias))
            ms["this_conv_only"] = _device_ms(lambda: kernels.stem_fwd(
                x, w, None, pool=False, stats=False))
            ms["other_conv_only"] = _device_ms(lambda: _run(
                libs["other"], x, w, None, pool=False, stats=False))
            rec["ms"] = ms
        print(json.dumps(rec), flush=True)
    print(json.dumps({"ablations_skipped": skipped, "ptxas": {
        k: [ln.strip() for ln in v.splitlines()
            if "registers" in ln or "spill" in ln]
        for k, v in ptxas.items()}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"all_bitwise": ok}), flush=True)
    return 0 if ok else 1


def _device_ms(fn, reps: int = 30, warmup: int = 3) -> float:
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
    return statistics.median(times)


if __name__ == "__main__":
    sys.exit(main())
