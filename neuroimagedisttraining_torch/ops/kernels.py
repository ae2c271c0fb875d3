"""Hand-written CUDA kernels of the training path, with their plain versions.

Counterpart of ``neuroimagedisttraining_tpu/ops/pallas_kernels.py``. Each
kernel's CUDA C++ source lives in ``neuroimagedisttraining_torch/csrc/``
(with a note on what it replaces, what bounds it and how it is laid out) and
is compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes``, on first use.

Every wrapper here:

* takes the plain PyTorch version for tensors on the CPU (the tests, and the
  oracle the kernel is held to on the card);
* launches the kernel for CUDA tensors, on the current stream, or raises —
  there is no fallback;
* adds one to ``LAUNCHES[name]`` for each call into the C entry that
  launched work on the card, and nowhere else.

One threshold "launch" is one search: a memset, 31 count passes and a
finishing grid on the stream (see ``csrc/threshold.cu``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from ..core.optim import sgd_momentum_step
from ..core.state import weighted_sum, weighted_tree_sum

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: kernel name -> CUDA source under csrc/
SOURCES = {
    "masked_sgd": "masked_sgd.cu",
    "threshold": "threshold.cu",
    "score_mask": "score_mask.cu",
    "mask_apply": "mask_apply.cu",
    "weighted_sum": "weighted_sum.cu",
    "quantize_reduce": "quantize_reduce.cu",
}
_HEADERS = ("leaf_table.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: leaves per launch of the leaf-table kernels (kMaxLeaves in leaf_table.cuh)
MAX_LEAVES = 32
#: count passes of the threshold search (kIters in threshold.cu)
SEARCH_ITERS = 31

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: nvcc's stderr (ptxas register/spill report) per kernel, from the last build
BUILD_LOG: Dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- build ------------------------------------------------------------------

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _lib_path(name: str) -> Path:
    """Build output named by a digest of the source, headers and flags, so
    an edited source never loads a stale library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every kernel not yet built (one ``nvcc`` per source, all
    started together) and load them all. Returns the seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        out = _lib_path(name)
        if name in _LIBS or out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        BUILD_LOG[name] = stdout + stderr
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{stderr}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    for name in SOURCES:
        if name not in _LIBS:
            _LIBS[name] = _bind(name, ctypes.CDLL(str(_lib_path(name))))
    return time.perf_counter() - t0


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    sizes = ctypes.POINTER(ctypes.c_longlong)
    if name == "masked_sgd":
        fn = lib.nidt_masked_sgd
        fn.argtypes = [i32, ptrs, ptrs, ptrs, ptrs, sizes, f32, f32, f32, i32,
                       vp]
    elif name == "threshold":
        fn = lib.nidt_threshold
        fn.argtypes = [vp, i64, i64, i32, vp, vp, i32, vp]
    elif name == "score_mask":
        fn = lib.nidt_score_mask
        fn.argtypes = [i32, ptrs, ptrs, sizes, vp, vp, vp]
    elif name == "mask_apply":
        fn = lib.nidt_mask_apply
        fn.argtypes = [i32, ptrs, ptrs, ptrs, sizes, vp]
    elif name == "weighted_sum":
        fn = lib.nidt_weighted_sum
        fn.argtypes = [i32, ptrs, ptrs, sizes, vp, i32, vp]
    else:
        fn = lib.nidt_quantize_reduce
        fn.argtypes = [vp, vp, vp, vp, vp, i32, i64, i64, i32, vp]
    fn.restype = ctypes.c_int
    return lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build()
    return _LIBS[name]


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptrs(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _sizes(ts: Sequence[torch.Tensor]):
    return (ctypes.c_longlong * len(ts))(*[t.numel() for t in ts])


def _require_cuda(name: str, ts: Sequence[torch.Tensor]) -> torch.device:
    dev = ts[0].device
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


def _is_cpu(ts: Sequence[torch.Tensor]) -> bool:
    return all(t.device.type == "cpu" for t in ts)


# -- masked SGD ---------------------------------------------------------------

def masked_sgd_plain(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                     mask: torch.Tensor, lr, momentum: float, wd: float,
                     mask_grads: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of one leaf's update: the reference kernel's
    arithmetic, each multiply-add rounded once
    (:func:`core.optim.sgd_momentum_step`)."""
    if mask_grads:
        g = g * mask
    (p_new,), (m_new,) = sgd_momentum_step([p], [m], [g], lr, momentum, wd)
    if not mask_grads:
        p_new = p_new * mask
    return p_new, m_new


def fused_masked_sgd_step(params: List[torch.Tensor],
                          momenta: List[torch.Tensor],
                          grads: List[torch.Tensor],
                          masks: List[torch.Tensor], lr, *,
                          momentum: float = 0.0, wd: float = 0.0,
                          mask_grads: bool = False) -> None:
    """Masked SGD over every leaf, updating ``params`` and ``momenta`` in
    place. ``mask_grads=False`` is SalientGrads (``p' *= mask`` after the
    step); ``True`` masks the gradient instead (DisPFL). ``lr`` is a float32
    value (a Python float or a 0-d float32 tensor on the CPU)."""
    leaves = list(params) + list(momenta) + list(grads) + list(masks)
    if not (len(params) == len(momenta) == len(grads) == len(masks)):
        raise ValueError("fused_masked_sgd_step: leaf lists differ in length")
    for p, m, g, k in zip(params, momenta, grads, masks):
        if not (p.shape == m.shape == g.shape == k.shape):
            raise ValueError("fused_masked_sgd_step: leaf shapes differ")
    if _is_cpu(leaves):
        with torch.no_grad():
            for p, m, g, k in zip(params, momenta, grads, masks):
                p_new, m_new = masked_sgd_plain(p, m, g, k, lr, momentum, wd,
                                                mask_grads)
                p.copy_(p_new)
                m.copy_(m_new)
        return
    dev = _require_cuda("fused_masked_sgd_step", leaves)
    fn = _lib("masked_sgd").nidt_masked_sgd
    lr_f = float(torch.as_tensor(lr, dtype=torch.float32))
    for s in range(0, len(params), MAX_LEAVES):
        sl = slice(s, s + MAX_LEAVES)
        ps, ms, gs, ks = params[sl], momenta[sl], grads[sl], masks[sl]
        rc = fn(len(ps), _ptrs(ps), _ptrs(ms), _ptrs(gs), _ptrs(ks),
                _sizes(ps), lr_f, float(momentum), float(wd),
                int(mask_grads), _stream(dev))
        _check("masked_sgd", rc)
        LAUNCHES["masked_sgd"] += 1


# -- threshold ----------------------------------------------------------------

def threshold_topk(av: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest value of each row of a non-negative f32 ``[C, n]``
    matrix; returns ``[C, 1]`` f32, bit-identical to
    :func:`ops.topk_select.exact_threshold` (its plain version). No cap on
    ``n``."""
    from .topk_select import exact_threshold

    if av.dim() != 2:
        raise ValueError(f"threshold_topk: expected [C, n], got {av.shape}")
    c, n = av.shape
    if not 1 <= k <= n:
        raise ValueError(f"threshold_topk: k={k} outside [1, {n}]")
    if av.device.type == "cpu":
        return exact_threshold(av, k)
    dev = _require_cuda("threshold_topk", [av])
    counts = torch.empty((c, SEARCH_ITERS), dtype=torch.int32, device=dev)
    out = torch.empty((c, 1), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(-(-n // 2048), 8 * sms))
    rc = _lib("threshold").nidt_threshold(
        av.data_ptr(), c, n, int(k), counts.data_ptr(), out.data_ptr(),
        blocks, _stream(dev))
    _check("threshold", rc)
    LAUNCHES["threshold"] += 1
    return out


# -- score mask ---------------------------------------------------------------

def score_mask_plain(s: torch.Tensor, norm: torch.Tensor,
                     thr: torch.Tensor) -> torch.Tensor:
    return (s / norm >= thr).to(torch.float32)


def fused_score_mask(scores: List[torch.Tensor], norm: torch.Tensor,
                     thr: torch.Tensor) -> List[torch.Tensor]:
    """``(s / norm >= thr)`` as f32 {0, 1} for every leaf of ``scores``.
    ``norm`` and ``thr`` are one-element f32 tensors on the scores' device."""
    norm = norm.reshape(())
    thr = thr.reshape(())
    if _is_cpu(list(scores) + [norm, thr]):
        return [score_mask_plain(s, norm, thr) for s in scores]
    dev = _require_cuda("fused_score_mask", list(scores) + [norm, thr])
    outs = [torch.empty_like(s) for s in scores]
    fn = _lib("score_mask").nidt_score_mask
    for s in range(0, len(scores), MAX_LEAVES):
        ss, os_ = scores[s:s + MAX_LEAVES], outs[s:s + MAX_LEAVES]
        rc = fn(len(ss), _ptrs(ss), _ptrs(os_), _sizes(ss), norm.data_ptr(),
                thr.data_ptr(), _stream(dev))
        _check("score_mask", rc)
        LAUNCHES["score_mask"] += 1
    return outs


# -- mask apply ---------------------------------------------------------------

def mask_apply_plain(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return p * m


def fused_mask_apply(tree: Dict[str, torch.Tensor],
                     mask: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``p * m`` for every leaf of ``tree`` against ``mask`` (same names and
    shapes), out of place, in one launch over all leaves."""
    names = list(tree)
    ps = [tree[k] for k in names]
    ks = [mask[k] for k in names]
    for k, p, m in zip(names, ps, ks):
        if p.shape != m.shape:
            raise ValueError(f"fused_mask_apply: {k} has shape {p.shape}, "
                             f"its mask {m.shape}")
    if _is_cpu(ps + ks):
        return {k: mask_apply_plain(p, m) for k, p, m in zip(names, ps, ks)}
    dev = _require_cuda("fused_mask_apply", ps + ks)
    outs = [torch.empty_like(p) for p in ps]
    fn = _lib("mask_apply").nidt_mask_apply
    for s in range(0, len(ps), MAX_LEAVES):
        sl = slice(s, s + MAX_LEAVES)
        rc = fn(len(ps[sl]), _ptrs(ps[sl]), _ptrs(ks[sl]), _ptrs(outs[sl]),
                _sizes(ps[sl]), _stream(dev))
        _check("mask_apply", rc)
        LAUNCHES["mask_apply"] += 1
    return dict(zip(names, outs))


# -- weighted sum -------------------------------------------------------------

def fused_weighted_sum(stacked: Dict[str, torch.Tensor],
                       weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``sum_c w[c] * x[c]`` over the leading client axis of every leaf, in
    static client order with one rounding per multiply and per add; its
    plain version is :func:`core.state.weighted_tree_sum`. Every f32 and
    bf16 aggregate contracts through it: the dense one over the parameter
    tree, the bucketed wires over one ``[C, nb, b]`` bucket tensor."""
    names = list(stacked)
    xs = [stacked[k] for k in names]
    c = xs[0].shape[0]
    if weights.shape != (c,) or any(x.shape[0] != c for x in xs):
        raise ValueError(f"fused_weighted_sum: weights {tuple(weights.shape)} "
                         f"against a client axis of {c}")
    if _is_cpu(xs + [weights]):
        return weighted_tree_sum(stacked, weights)
    dev = _require_cuda("fused_weighted_sum", xs + [weights])
    outs = [torch.empty(x.shape[1:], dtype=torch.float32, device=dev)
            for x in xs]
    fn = _lib("weighted_sum").nidt_weighted_sum
    for s in range(0, len(xs), MAX_LEAVES):
        sl = slice(s, s + MAX_LEAVES)
        rc = fn(len(xs[sl]), _ptrs(xs[sl]), _ptrs(outs[sl]), _sizes(outs[sl]),
                weights.data_ptr(), c, _stream(dev))
        _check("weighted_sum", rc)
        LAUNCHES["weighted_sum"] += 1
    return dict(zip(names, outs))


# -- int8 quantize + weighted reduce ------------------------------------------

def quantize_reduce_plain(buckets: torch.Tensor, weights: torch.Tensor,
                          uniforms: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """The plain version: the wire's own quantize
    (``parallel/collectives.py::_quantize_int8``) on the given uniforms and
    scales, dequantize, then the static-order client sum."""
    from ..parallel.collectives import _quantize_int8

    q, scale = _quantize_int8(buckets, uniforms, scales[..., None])
    return weighted_sum(q.to(torch.float32) * scale, weights)


def fused_quantize_reduce(buckets: torch.Tensor, weights: torch.Tensor,
                          uniforms: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """``out[b, j] = sum_c w[c] * dequant(int8(buckets[c, b, j]))`` for a
    ``[C, nb, b]`` f32 bucket tensor with its ``[C, nb, b]`` uniforms and
    ``[C, nb]`` scales; returns ``[nb, b]`` f32. Any bucket size."""
    if buckets.dim() != 3:
        raise ValueError(f"fused_quantize_reduce: expected [C, nb, b], got "
                         f"{tuple(buckets.shape)}")
    c, nb, b = buckets.shape
    if uniforms.shape != buckets.shape or scales.shape != (c, nb) or \
            weights.shape != (c,):
        raise ValueError(
            f"fused_quantize_reduce: buckets {tuple(buckets.shape)}, uniforms "
            f"{tuple(uniforms.shape)}, scales {tuple(scales.shape)}, weights "
            f"{tuple(weights.shape)}")
    ts = [buckets, uniforms, scales, weights]
    if _is_cpu(ts):
        return quantize_reduce_plain(buckets, weights, uniforms, scales)
    dev = _require_cuda("fused_quantize_reduce", ts)
    out = torch.empty((nb, b), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(-(-(nb * b) // 256), 32 * sms))
    rc = _lib("quantize_reduce").nidt_quantize_reduce(
        buckets.data_ptr(), uniforms.data_ptr(), scales.data_ptr(),
        weights.data_ptr(), out.data_ptr(), c, nb, b, blocks, _stream(dev))
    _check("quantize_reduce", rc)
    LAUNCHES["quantize_reduce"] += 1
    return out
