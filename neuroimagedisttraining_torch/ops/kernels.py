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
  launched work on the card, and nowhere else. A CUDA graph's replay of
  captured launches adds them through :func:`add_launches`. Every read and
  write of the counts holds one lock (:data:`_LAUNCH_LOCK`): the serving
  worker launches from its own thread while the training thread does, and
  an unguarded ``+= 1`` on a dict item can lose a count.

One threshold "launch" is one search: the memset of its scratch
(``torch.zeros``) and three radix digit passes on the stream (see
``csrc/threshold.cu``). One weighted-sum or quantize-reduce launch is one
grid per 16 clients (one at the port's cohorts of 8; the quantize-reduce
wrapper calls its C entry once per grid and counts the call once). One
``stem_fwd`` launch is the weight layout pass, the fused
conv/pool/statistics grid and, with statistics on, the fixed-order
reduction of its partials (``csrc/stem_fwd.cu``); one ``stem_bwd`` launch
is its grid and, with the bias gradient, the fixed-order reduction of its
partials (``csrc/stem_bwd.cu``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as nnf

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
    "stem_fwd": "stem_fwd.cu",
    "stem_bwd": "stem_bwd.cu",
}
_HEADERS = ("leaf_table.cuh", "tma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: leaves per launch of the leaf-table kernels (kMaxLeaves in leaf_table.cuh)
MAX_LEAVES = 32

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
#: launches of a kernel's branch since the last :func:`reset_launches`:
#: the masked SGD kernel's ``mask_grads`` branch (DisPFL's and SubAvg's
#: steps), also counted in ``LAUNCHES["masked_sgd"]``
BRANCH_LAUNCHES: Dict[str, int] = {"masked_sgd_mask_grads": 0}

#: held by every read and write of the two count dicts
_LAUNCH_LOCK = threading.Lock()

_LIBS: Dict[str, ctypes.CDLL] = {}
#: nvcc's stderr (ptxas register/spill report) per kernel, from the last build
BUILD_LOG: Dict[str, str] = {}


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for counts in (LAUNCHES, BRANCH_LAUNCHES):
            for name in counts:
                counts[name] = 0


def _counter(name: str) -> Dict[str, int]:
    return LAUNCHES if name in LAUNCHES else BRANCH_LAUNCHES


def snapshot_launches() -> Dict[str, int]:
    """Every count of :data:`LAUNCHES` and :data:`BRANCH_LAUNCHES`."""
    with _LAUNCH_LOCK:
        return {**LAUNCHES, **BRANCH_LAUNCHES}


def restore_launches(snapshot: Dict[str, int]) -> None:
    """Set the counts back to a :func:`snapshot_launches`."""
    with _LAUNCH_LOCK:
        for name, n in snapshot.items():
            _counter(name)[name] = n


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (keys of :func:`snapshot_launches`) to the counters:
    the launches a CUDA graph replays, which pass through no wrapper (the
    capture counted them, then took them back: a capture queues no
    work)."""
    with _LAUNCH_LOCK:
        for name, n in counts.items():
            _counter(name)[name] += n


def _count(name: str) -> None:
    """One launch of ``name`` (a kernel or a branch)."""
    with _LAUNCH_LOCK:
        _counter(name)[name] += 1


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
    started together) and load them all. Returns the seconds spent, which
    a live obs session records (``obs.compile``, ``kernel_build``)."""
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
    loaded = [name for name in SOURCES if name not in _LIBS]
    for name in loaded:
        _LIBS[name] = _bind(name, ctypes.CDLL(str(_lib_path(name))))
    seconds = time.perf_counter() - t0
    if loaded:
        from ..obs.compile import note_compile

        note_compile("kernel_build", seconds, count=len(procs))
    return seconds


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    sizes = ctypes.POINTER(ctypes.c_longlong)
    if name == "masked_sgd":
        fn = lib.nidt_masked_sgd
        fn.argtypes = [i32, ptrs, ptrs, ptrs, ptrs, sizes, f32, f32, f32, i32,
                       vp]
        by_ptr = lib.nidt_masked_sgd_lr_ptr
        by_ptr.argtypes = [i32, ptrs, ptrs, ptrs, ptrs, sizes, vp, f32, f32,
                           i32, vp]
        by_ptr.restype = ctypes.c_int
    elif name == "threshold":
        fn = lib.nidt_threshold
        fn.argtypes = [vp, i64, i64, i64, vp, vp, i32, vp]
        lib.nidt_threshold_scratch.argtypes = []
        lib.nidt_threshold_scratch.restype = ctypes.c_int
    elif name == "score_mask":
        fn = lib.nidt_score_mask
        fn.argtypes = [i32, ptrs, ptrs, sizes, vp, vp, vp]
    elif name == "mask_apply":
        fn = lib.nidt_mask_apply
        fn.argtypes = [i32, ptrs, ptrs, ptrs, sizes, vp]
    elif name == "weighted_sum":
        fn = lib.nidt_weighted_sum
        fn.argtypes = [i32, ptrs, ptrs, sizes, ctypes.POINTER(i32), vp, i32,
                       vp]
    elif name == "quantize_reduce":
        fn = lib.nidt_quantize_reduce
        fn.argtypes = [vp] * 5 + [i32] * 8 + [vp]
    elif name == "stem_fwd":
        fn = lib.nidt_stem_fwd
        fn.argtypes = [vp] * 9 + [i32] * 8 + [vp]
        lib.nidt_stem_fwd_blocks.argtypes = [i32] * 5
        lib.nidt_stem_fwd_blocks.restype = ctypes.c_int
        lib.nidt_stem_fwd_config.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
        lib.nidt_stem_fwd_config.restype = ctypes.c_int
    else:
        fn = lib.nidt_stem_bwd
        fn.argtypes = [vp] * 8 + [i32] * 7 + [vp]
        lib.nidt_stem_bwd_config.argtypes = [i32] * 6 + [ctypes.POINTER(i32)]
        lib.nidt_stem_bwd_config.restype = ctypes.c_int
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


def _require_cuda(name: str, ts: Sequence[torch.Tensor],
                  dtypes: Tuple[torch.dtype, ...] = (torch.float32,),
                  aligned: bool = False) -> torch.device:
    """The device of ``ts``, which must all lie on one CUDA device, be
    contiguous, of one of ``dtypes`` and, with ``aligned``, start on a
    16-byte boundary (the kernels that move 16-byte vectors)."""
    dev = ts[0].device
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got "
                             f"{t.device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: expected {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
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
    value: a Python float or a 0-d float32 tensor on the CPU, passed to the
    kernel by value; or a 0-d float32 tensor on the leaves' card, which the
    kernel reads there (the launch a CUDA graph can replay with a new
    rate)."""
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
    lib = _lib("masked_sgd")
    if isinstance(lr, torch.Tensor) and lr.is_cuda:
        if lr.shape != () or _require_cuda("fused_masked_sgd_step",
                                           [lr]) != dev:
            raise ValueError(f"fused_masked_sgd_step: lr on the card must "
                             f"be a 0-d float32 tensor on {dev}")
        fn, lr_arg = lib.nidt_masked_sgd_lr_ptr, lr.data_ptr()
    else:
        fn = lib.nidt_masked_sgd
        lr_arg = float(torch.as_tensor(lr, dtype=torch.float32))
    for s in range(0, len(params), MAX_LEAVES):
        sl = slice(s, s + MAX_LEAVES)
        ps, ms, gs, ks = params[sl], momenta[sl], grads[sl], masks[sl]
        rc = fn(len(ps), _ptrs(ps), _ptrs(ms), _ptrs(gs), _ptrs(ks),
                _sizes(ps), lr_arg, float(momentum), float(wd),
                int(mask_grads), _stream(dev))
        _check("masked_sgd", rc)
        _count("masked_sgd")
        if mask_grads:
            _count("masked_sgd_mask_grads")


# -- threshold ----------------------------------------------------------------

#: rows of one threshold search (the grid's y dimension)
THRESHOLD_MAX_ROWS = 65535


def threshold_topk(av: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest value of each row of a non-negative f32 ``[C, n]``
    matrix; returns ``[C, 1]`` f32, bit-identical to
    :func:`ops.topk_select.exact_threshold` (its plain version). On the
    card, a radix select in three digit passes (the algorithm of
    :func:`ops.topk_select.radix_threshold`). No cap on ``n``; at most
    THRESHOLD_MAX_ROWS rows."""
    from .topk_select import exact_threshold

    if av.dim() != 2:
        raise ValueError(f"threshold_topk: expected [C, n], got {av.shape}")
    c, n = av.shape
    if not 1 <= k <= n:
        raise ValueError(f"threshold_topk: k={k} outside [1, {n}]")
    if av.device.type == "cpu":
        return exact_threshold(av, k)
    dev = _require_cuda("threshold_topk", [av])
    if c > THRESHOLD_MAX_ROWS:
        raise ValueError(f"threshold_topk: {c} rows, at most "
                         f"{THRESHOLD_MAX_ROWS} (the grid's y)")
    lib = _lib("threshold")
    # per row: three histograms, their tickets, the digit state
    scratch = torch.zeros((c, lib.nidt_threshold_scratch()),
                          dtype=torch.int64, device=dev)
    out = torch.empty((c, 1), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # blocks per row: one per 8192 elements (four steps per thread, the
    # kernel's preload, so zeroing and flushing a block's 2048-bin histogram
    # stay a small share of its work), at most four per SM over all rows
    blocks = max(1, min(-(-n // 8192), 4 * sms // c))
    rc = lib.nidt_threshold(
        av.data_ptr(), c, n, int(k), scratch.data_ptr(), out.data_ptr(),
        blocks, _stream(dev))
    _check("threshold", rc)
    _count("threshold")
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
        _count("score_mask")
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
        _count("mask_apply")
    return dict(zip(names, outs))


# -- weighted sum -------------------------------------------------------------

def weighted_sum_vector_leaf(x: torch.Tensor) -> bool:
    """Whether a contiguous ``[C, ...]`` leaf takes the weighted-sum kernel's
    16-byte path: its base on a 16-byte boundary and ``n % 4 == 0`` for its
    per-client size ``n``, so that every client row is aligned too. Any
    other leaf (an odd size, an offset view) takes the scalar path of the
    same launch."""
    return x.data_ptr() % 16 == 0 and x[0].numel() % 4 == 0


def fused_weighted_sum(stacked: Dict[str, torch.Tensor],
                       weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``sum_c w[c] * x[c]`` over the leading client axis of every leaf, in
    static client order with one rounding per multiply and per add; its
    plain version is :func:`core.state.weighted_tree_sum`. Every f32 and
    bf16 aggregate contracts through it: the dense one over the parameter
    tree, the bucketed wires over one ``[C, nb, b]`` bucket tensor. On the
    card each leaf takes the kernel's 16-byte or scalar path
    (:func:`weighted_sum_vector_leaf`), one launch per 32 leaves."""
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
    vec = [weighted_sum_vector_leaf(x) for x in xs]
    fn = _lib("weighted_sum").nidt_weighted_sum
    for s in range(0, len(xs), MAX_LEAVES):
        sl = slice(s, s + MAX_LEAVES)
        flags = (ctypes.c_int * len(vec[sl]))(*vec[sl])
        rc = fn(len(xs[sl]), _ptrs(xs[sl]), _ptrs(outs[sl]), _sizes(outs[sl]),
                flags, weights.data_ptr(), c, _stream(dev))
        _check("weighted_sum", rc)
        _count("weighted_sum")
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


#: outputs per block along a bucket (kTile in csrc/quantize_reduce.cu), the
#: clients per launch (kMaxChunk) and the grid's y limit
QUANTIZE_REDUCE_TILE = 1024
QUANTIZE_REDUCE_MAX_CHUNK = 16
_MAX_GRID_Y = 65535


def quantize_reduce_plan(c: int, nb: int, b: int, ptrs: Sequence[int],
                         tile: int = QUANTIZE_REDUCE_TILE) -> Dict:
    """The quantize-reduce kernel's launches for ``c`` clients of ``nb``
    buckets of ``b`` values, with ``ptrs`` the data pointers of ``x``,
    ``u`` and ``out``: ``chunks``, the ``(first client, count)`` of each
    launch, 16 clients at most, in client order; ``vec``, whether the
    16-byte path is taken (``b % 4 == 0`` and every pointer on a 16-byte
    boundary; else the scalar path of the same kernel); ``grid``,
    ``(ceil(b / tile), min(nb, 65535))``, a block per tile of a bucket; and
    ``tile``, the outputs a block owns along its bucket."""
    if min(c, nb, b) < 1:
        raise ValueError(f"quantize_reduce_plan: c={c}, nb={nb}, b={b}")
    if b > 2 ** 31 - 1 - tile or nb > 2 ** 31 - 1:
        raise ValueError(f"quantize_reduce_plan: a bucket index or position "
                         f"(nb={nb}, b={b}) must fit in 32 bits")
    chunks = [(c0, min(QUANTIZE_REDUCE_MAX_CHUNK, c - c0))
              for c0 in range(0, c, QUANTIZE_REDUCE_MAX_CHUNK)]
    vec = b % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    return dict(chunks=chunks, vec=vec, grid=(-(-b // tile),
                                              min(nb, _MAX_GRID_Y)),
                tile=tile)


def fused_quantize_reduce(buckets: torch.Tensor, weights: torch.Tensor,
                          uniforms: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """``out[b, j] = sum_c w[c] * dequant(int8(buckets[c, b, j]))`` for a
    ``[C, nb, b]`` f32 bucket tensor with its ``[C, nb, b]`` uniforms and
    ``[C, nb]`` scales; returns ``[nb, b]`` f32. Any bucket size. On the
    card, the launches of :func:`quantize_reduce_plan`: one grid per 16
    clients, counted as one launch."""
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
    plan = quantize_reduce_plan(c, nb, b, [buckets.data_ptr(),
                                           uniforms.data_ptr(),
                                           out.data_ptr()])
    fn = _lib("quantize_reduce").nidt_quantize_reduce
    for c0, chunk in plan["chunks"]:
        rc = fn(buckets.data_ptr(), uniforms.data_ptr(), scales.data_ptr(),
                weights.data_ptr(), out.data_ptr(), c, nb, b, c0, chunk,
                int(plan["vec"]), *plan["grid"], _stream(dev))
        _check("quantize_reduce", rc)
    _count("quantize_reduce")
    return out


# -- stem stage: conv + max-pool + statistics, and its backward ---------------

#: the stem kernels take F, a multiple of 8, up to this many channels
STEM_MAX_F = 64
STEM_DTYPES = (torch.bfloat16, torch.float32)
#: how the stem backward routes a window's cotangent among tied maxima
STEM_TIES = ("first", "split")


def _check_stem_channels(name: str, f: int) -> None:
    if f % 8 or not 8 <= f <= STEM_MAX_F:
        raise ValueError(f"{name}: F = {f} channels; the stem kernels take a "
                         f"multiple of 8 up to {STEM_MAX_F}")


#: channel counts the bf16 stem forward runs on the tensor cores (others
#: take its CUDA-core kernel)
STEM_MMA_CHANNELS = (16, 32, 64)


def stem_fwd_config(b: int, dp: int, hp: int, wp: int, f: int
                    ) -> Dict[str, int]:
    """The tensor-core stem forward's persistent launch at these shapes, on
    the current CUDA device: ``grid`` blocks walk ``tiles`` tiles, each
    block ``threads`` threads and ``smem`` bytes of dynamic shared memory,
    ``blocks_per_sm`` resident on an SM."""
    if f not in STEM_MMA_CHANNELS:
        raise ValueError(f"stem_fwd_config: F = {f} is not on the tensor "
                         f"cores {STEM_MMA_CHANNELS}")
    out = (ctypes.c_int * 5)()
    _check("stem_fwd", _lib("stem_fwd").nidt_stem_fwd_config(
        b, dp, hp, wp, f, out))
    return dict(zip(("grid", "tiles", "threads", "smem", "blocks_per_sm"),
                    out))


def stem_stats_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type of the stem's statistics and of their cotangents: float32,
    or float64 for a float64 stage (the plain versions take any float type
    on the CPU; the kernels take bf16 and f32)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def stem_stats_plain(zs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) sum and sum of squares of a channels-last
    ``(B, D, H, W, F)`` tensor, accumulated in float64 and rounded once to
    :func:`stem_stats_dtype`, as the kernel accumulates them."""
    zd = zs.double()
    out = stem_stats_dtype(zs.dtype)
    return zd.sum((1, 2, 3)).to(out), (zd * zd).sum((1, 2, 3)).to(out)


def stem_fwd_plain(x: torch.Tensor, w: torch.Tensor, bias=None, *,
                   pool: bool = True, stats: bool = True):
    """The plain version of :func:`stem_fwd`: ``F.conv3d`` on the phased
    input, the bias added in the working type, ``max_pool3d`` and the
    float64-accumulated sums."""
    z = nnf.conv3d(x.permute(0, 3, 1, 2, 4), w)
    if bias is not None:
        z = z + bias.reshape(1, -1, 1, 1, 1)
    zs = z.permute(0, 2, 3, 4, 1).contiguous()
    pooled = (nnf.max_pool3d(z, 3, 3).permute(0, 2, 3, 4, 1).contiguous()
              if pool else None)
    s1, s2 = stem_stats_plain(zs) if stats else (None, None)
    return zs, pooled, s1, s2


def stem_fwd(x: torch.Tensor, w: torch.Tensor, bias=None, *,
             pool: bool = True, stats: bool = True):
    """The stem stage's full-resolution forward in one pass.

    ``x`` is the phased volume ``(B, D', H', 8, W')`` (read in place), ``w``
    the stem kernel ``(F, 8, 3, 3, 3)`` and ``bias`` ``(F,)`` or None, all in
    one working type (bf16 or f32). Returns ``(zs, pooled, s1, s2)``:

    * ``zs`` ``(B, D, H, W, F)`` channels-last, D = D'-2 etc.: the conv
      accumulated in f32, rounded to the working type, plus the bias in the
      working type;
    * ``pooled`` ``(B, D//3, H//3, W//3, F)``: the floor-mode 3x3x3/s3
      max-pool of ``zs`` (None with ``pool=False``);
    * ``s1``, ``s2`` ``(B, F)`` f32: the sum and sum of squares of ``zs``
      over ``(D, H, W)`` (None with ``stats=False``).

    Any B, D', H', W' >= 3; F a multiple of 8 up to 64."""
    if x.dim() != 5 or x.shape[3] != 8:
        raise ValueError(f"stem_fwd: expected a phased (B, D', H', 8, W') "
                         f"volume, got {tuple(x.shape)}")
    if w.dim() != 5 or tuple(w.shape[1:]) != (8, 3, 3, 3):
        raise ValueError(f"stem_fwd: expected an (F, 8, 3, 3, 3) kernel, got "
                         f"{tuple(w.shape)}")
    b, dp, hp, _, wp = x.shape
    f = w.shape[0]
    _check_stem_channels("stem_fwd", f)
    if min(dp, hp, wp) < 3:
        raise ValueError(f"stem_fwd: phased extents {(dp, hp, wp)} < 3")
    ts = [x, w] + ([] if bias is None else [bias])
    if not x.dtype.is_floating_point or any(t.dtype != x.dtype for t in ts):
        raise ValueError(f"stem_fwd: x, w and bias must share one float "
                         f"type, got {[t.dtype for t in ts]}")
    if bias is not None and tuple(bias.shape) != (f,):
        raise ValueError(f"stem_fwd: bias {tuple(bias.shape)}, want ({f},)")
    if _is_cpu(ts):
        return stem_fwd_plain(x, w, bias, pool=pool, stats=stats)
    dev = _require_cuda("stem_fwd", ts, STEM_DTYPES)
    if (x.dtype == torch.bfloat16 and f in STEM_MMA_CHANNELS
            and x.data_ptr() % 16):
        raise ValueError("stem_fwd: the bf16 tensor-core path reads x by TMA "
                         "and needs it on a 16-byte boundary")
    lib = _lib("stem_fwd")
    d, h, wd = dp - 2, hp - 2, wp - 2
    zs = torch.empty((b, d, h, wd, f), dtype=x.dtype, device=dev)
    pooled = (torch.empty((b, d // 3, h // 3, wd // 3, f), dtype=x.dtype,
                          device=dev) if pool else None)
    s1 = s2 = partials = None
    if stats:
        nblk = lib.nidt_stem_fwd_blocks(dp, hp, wp, f,
                                        int(x.dtype == torch.bfloat16))
        partials = torch.empty((b, nblk, 2, f), dtype=torch.float64,
                               device=dev)
        s1 = torch.empty((b, f), dtype=torch.float32, device=dev)
        s2 = torch.empty((b, f), dtype=torch.float32, device=dev)
    wscratch = torch.empty((216, f), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.nidt_stem_fwd(
        x.data_ptr(), w.data_ptr(), ptr(bias), zs.data_ptr(), ptr(pooled),
        ptr(partials), ptr(s1), ptr(s2), wscratch.data_ptr(), b, dp, hp, wp,
        f, int(x.dtype == torch.bfloat16), int(pool), int(stats),
        _stream(dev))
    _check("stem_fwd", rc)
    _count("stem_fwd")
    return zs, pooled, s1, s2


def stem_bwd_plain(zs: torch.Tensor, pooled: torch.Tensor,
                   g_pooled: torch.Tensor, g_s1: torch.Tensor,
                   g_s2: torch.Tensor, *, ties: str, bias_grad: bool = False):
    """The plain version of :func:`stem_bwd`: the same operations on whole
    tensors, each multiply and add rounded once in float32; with
    ``bias_grad``, also ``dzs.sum(dim=(0, 1, 2, 3))``."""
    b, d, h, w, f = zs.shape
    pd, ph, pw = d // 3, h // 3, w // 3
    zf = zs.to(g_s1.dtype)
    dense = g_s1[:, None, None, None, :] + \
        (2.0 * g_s2)[:, None, None, None, :] * zf
    term = torch.zeros_like(zf)
    if pd and ph and pw:
        core = zf[:, :3 * pd, :3 * ph, :3 * pw].reshape(b, pd, 3, ph, 3, pw,
                                                       3, f)
        m = pooled.to(zf.dtype)[:, :, None, :, None, :, None, :]
        g = g_pooled.to(zf.dtype)[:, :, None, :, None, :, None, :]
        eq = core == m
        if ties == "split":
            count = eq.sum((2, 4, 6), keepdim=True).to(zf.dtype)
            t = torch.where(eq, g / count.clamp(min=1.0), 0.0)
        else:
            # the first equal position of each window in (d, h, w) order
            k = eq.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, pd, ph, pw, f,
                                                           27)
            hit = k & (torch.cumsum(k, dim=-1) == 1)
            hit = hit.reshape(b, pd, ph, pw, f, 3, 3, 3).permute(
                0, 1, 5, 2, 6, 3, 7, 4)
            t = torch.where(hit, g, 0.0)
        term[:, :3 * pd, :3 * ph, :3 * pw] = t.reshape(b, 3 * pd, 3 * ph,
                                                       3 * pw, f)
    dzs = (dense + term).to(zs.dtype)
    return (dzs, dzs.sum(dim=(0, 1, 2, 3))) if bias_grad else dzs


def stem_bwd_config(b: int, d: int, h: int, w: int, f: int,
                    dtype: torch.dtype) -> Dict[str, int]:
    """The stem backward's persistent launch at zs ``(b, d, h, w, f)`` of
    ``dtype`` on the current CUDA device: ``grid`` blocks walk ``slabs``
    slabs through a ring of ``stages``, each block ``threads`` threads and
    ``smem`` bytes of dynamic shared memory, ``blocks_per_sm`` resident on
    an SM."""
    _check_stem_channels("stem_bwd_config", f)
    out = (ctypes.c_int * 6)()
    _check("stem_bwd", _lib("stem_bwd").nidt_stem_bwd_config(
        b, d, h, w, f, int(dtype == torch.bfloat16), out))
    return dict(zip(("grid", "slabs", "threads", "smem", "blocks_per_sm",
                     "stages"), out))


def stem_bwd(zs: torch.Tensor, pooled: torch.Tensor, g_pooled: torch.Tensor,
             g_s1: torch.Tensor, g_s2: torch.Tensor, *, ties: str,
             bias_grad: bool = False):
    """The cotangent of channels-last ``zs`` ``(B, D, H, W, F)`` through
    ``(max_pool3(zs), sum(zs), sum(zs^2))``, in one pass:
    ``dzs = g_s1 + 2 g_s2 zs + pool_term``, in ``zs``'s type.

    ``pooled`` and ``g_pooled`` are ``(B, D//3, H//3, W//3, F)`` in ``zs``'s
    type, ``g_s1`` and ``g_s2`` ``(B, F)`` f32. ``ties="first"`` routes each
    window's cotangent to its first maximum in (d, h, w) order (torch's
    max-pool backward); ``ties="split"`` splits it evenly among equal
    maxima (the reference kernel's contract).

    With ``bias_grad=True`` returns ``(dzs, dbias)``: ``dbias`` ``(F,)`` in
    ``zs``'s type is ``dzs`` summed per channel (the gradient of a bias
    added to ``zs``), on the card in the same pass, accumulated in f64 and
    rounded once; its plain version is ``dzs.sum(dim=(0, 1, 2, 3))``."""
    if ties not in STEM_TIES:
        raise ValueError(f"stem_bwd: ties={ties!r} not in {STEM_TIES}")
    if not isinstance(bias_grad, bool):
        raise ValueError(f"stem_bwd: bias_grad={bias_grad!r} is not a bool")
    if zs.dim() != 5:
        raise ValueError(f"stem_bwd: expected zs (B, D, H, W, F), got "
                         f"{tuple(zs.shape)}")
    b, d, h, w, f = zs.shape
    _check_stem_channels("stem_bwd", f)
    pshape = (b, d // 3, h // 3, w // 3, f)
    if tuple(pooled.shape) != pshape or tuple(g_pooled.shape) != pshape or \
            tuple(g_s1.shape) != (b, f) or tuple(g_s2.shape) != (b, f):
        raise ValueError(
            f"stem_bwd: zs {tuple(zs.shape)}, pooled {tuple(pooled.shape)}, "
            f"g_pooled {tuple(g_pooled.shape)}, g_s1 {tuple(g_s1.shape)}, "
            f"g_s2 {tuple(g_s2.shape)}")
    sdt = stem_stats_dtype(zs.dtype)
    if not zs.dtype.is_floating_point or pooled.dtype != zs.dtype or \
            g_pooled.dtype != zs.dtype or g_s1.dtype != sdt or \
            g_s2.dtype != sdt:
        raise ValueError(
            f"stem_bwd: zs, pooled, g_pooled in one float type and g_s1, "
            f"g_s2 in {sdt}, got {zs.dtype}, {pooled.dtype}, "
            f"{g_pooled.dtype}, {g_s1.dtype}, {g_s2.dtype}")
    ts = [zs, pooled, g_pooled, g_s1, g_s2]
    if _is_cpu(ts):
        return stem_bwd_plain(zs, pooled, g_pooled, g_s1, g_s2, ties=ties,
                              bias_grad=bias_grad)
    dev = _require_cuda("stem_bwd", [zs, pooled, g_pooled], STEM_DTYPES,
                        aligned=True)
    if _require_cuda("stem_bwd", [g_s1, g_s2]) != dev:
        raise ValueError(f"stem_bwd: g_s1, g_s2 must be on {dev}")
    lib = _lib("stem_bwd")
    out = torch.empty_like(zs)
    partials = dbias = None
    if bias_grad:
        grid = stem_bwd_config(b, d, h, w, f, zs.dtype)["grid"]
        partials = torch.empty((grid, f), dtype=torch.float64, device=dev)
        dbias = torch.empty((f,), dtype=zs.dtype, device=dev)
    rc = lib.nidt_stem_bwd(
        zs.data_ptr(), pooled.data_ptr(), g_pooled.data_ptr(),
        g_s1.data_ptr(), g_s2.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if dbias is None else dbias.data_ptr(), b, d, h, w, f,
        int(zs.dtype == torch.bfloat16), int(ties == "split"), _stream(dev))
    _check("stem_bwd", rc)
    _count("stem_bwd")
    return (out, dbias) if bias_grad else out


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in units in the last place between two bf16 or
    f32 tensors of one type (0 where bitwise equal; +0 and -0 are 0 apart),
    as int64. The stem forward's ``zs`` is held to its plain version within
    one ulp of the working type."""
    if a.dtype != b.dtype or a.dtype not in STEM_DTYPES:
        raise ValueError(f"ulp_distance: {a.dtype} vs {b.dtype}")
    if a.dtype == torch.bfloat16:
        ia, ib, mag = a.view(torch.int16), b.view(torch.int16), 0x7FFF
    else:
        ia, ib, mag = a.view(torch.int32), b.view(torch.int32), 0x7FFFFFFF

    def ordered(i):
        i = i.to(torch.int64)
        return torch.where(i < 0, -(i & mag), i)

    return (ordered(ia) - ordered(ib)).abs()


def dbias_agreement(dbias: torch.Tensor, dzs: torch.Tensor
                    ) -> Tuple[int, float]:
    """The stem backward's fused bias gradient against the plain per-channel
    sum ``dzs.sum(dim=(0, 1, 2, 3))``: the largest ulp distance, and the
    largest error over the channel's sum of magnitudes among the channels
    more than one ulp apart. The card holds the two within one ulp, or
    within 1e-5 of the magnitude where the sum cancels (the kernel sums in
    f64 in another order)."""
    want = dzs.sum(dim=(0, 1, 2, 3))
    ulp = ulp_distance(dbias, want)
    mag = dzs.double().abs().sum(dim=(0, 1, 2, 3))
    rel = (dbias.double() - want.double()).abs() / mag
    over = ulp > 1
    worst = float(rel[over].max()) if bool(over.any()) else 0.0
    return int(ulp.max()), worst
