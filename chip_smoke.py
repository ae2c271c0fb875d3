#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build   — compile every CUDA kernel from ``neuroimagedisttraining_torch/csrc``
   (one ``nvcc`` per source, all started together).
2. kernels — hold each kernel against its plain PyTorch version, bit for bit,
   at the shapes the training path gives it (full-width AlexNet3DS2D), and
   time both (CUDA events, median of 30 after warmup, each launch queued
   behind a device-side sleep so host enqueue time is not counted).
3. parity  — a narrow model, one SalientGrads round on the CPU (plain
   versions) and on the GPU (kernels) from the same parameters, mask and
   batch order: parameters and metrics must agree.
4. main    — the training path at full width through the library entry
   points: SalientGrads on AlexNet3DS2D, 8 clients x 40 phased 121x145x121
   volumes, batch 8, 5 local steps, bf16 compute, dropout 0.5, SNIP mask
   init, 3 rounds, then the global and personal eval. The launch counters
   are zeroed just before and read just after.

Then a ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Any failure raises and the
script exits non-zero; without CUDA it exits 2 before printing a result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

#: published H100 SXM peaks (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12  # f32 (and, as the CUDA-core rate, int32) ops

#: the JAX package's Pallas kernels these replace (file:line of pallas_call)
REPLACES = {
    "masked_sgd": "neuroimagedisttraining_tpu/ops/pallas_kernels.py:98",
    "threshold": "neuroimagedisttraining_tpu/ops/pallas_kernels.py:258",
    "score_mask": "neuroimagedisttraining_tpu/ops/pallas_kernels.py:424",
}

N_CLIENTS, SAMPLES, TEST, BATCH, STEPS, ROUNDS = 8, 40, 10, 8, 5, 3
VOLUME = (121, 145, 121)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms: each call is queued behind a
    ~10 ms device-side sleep, so the events bracket only its kernels."""
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


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(dev):
    """Each kernel vs its plain version at main-path shapes; returns the
    per-kernel measurements."""
    import torch

    from neuroimagedisttraining_torch.models import create_model, init_params
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.topk_select import exact_threshold

    g = torch.Generator(device=dev).manual_seed(1234)
    model = create_model("3dcnn_s2d").to(dev)
    params = init_params(model, g)
    shapes = [tuple(p.shape) for p in params.values()]
    n_params = sum(math.prod(s) for s in shapes)
    kernel_shapes = [tuple(v.shape) for k, v in params.items()
                     if k.endswith(".kernel")]
    n_kernel = sum(math.prod(s) for s in kernel_shapes)
    out = {}

    # -- masked SGD: all 24 leaves, both modes -------------------------------
    lr, mom, wd = 1e-3 * 0.998 ** 2, 0.9, 5e-4
    leaves = {}
    for mode in (False, True):
        ps = [p.clone() for p in params.values()]
        ms = [torch.randn(s, generator=g, device=dev) for s in shapes]
        gs = [torch.randn(s, generator=g, device=dev) for s in shapes]
        ks = [(torch.rand(s, generator=g, device=dev) < 0.5).float()
              for s in shapes]
        want = [kernels.masked_sgd_plain(p, m, gg, k, lr, mom, wd, mode)
                for p, m, gg, k in zip(ps, ms, gs, ks)]
        kernels.fused_masked_sgd_step(ps, ms, gs, ks, lr, momentum=mom,
                                      wd=wd, mask_grads=mode)
        torch.cuda.synchronize()
        err = max(max(float((a - p).abs().max()), float((b - m).abs().max()))
                  for (a, b), p, m in zip(want, ps, ms))
        same = all(torch.equal(a, p) and torch.equal(b, m)
                   for (a, b), p, m in zip(want, ps, ms))
        if not same:
            raise AssertionError(f"masked_sgd (mask_grads={mode}) differs "
                                 f"from its plain version: max err {err}")
        leaves[mode] = (ps, ms, gs, ks, err)
    ps, ms, gs, ks, _ = leaves[False]
    ms_kernel = device_ms(lambda: kernels.fused_masked_sgd_step(
        ps, ms, gs, ks, lr, momentum=mom, wd=wd))
    ms_plain = device_ms(lambda: [kernels.masked_sgd_plain(
        p, m, gg, k, lr, mom, wd, False) for p, m, gg, k in zip(ps, ms, gs,
                                                                ks)])
    b_ms, b_by = bound(24.0 * n_params, 7.0 * n_params)
    out["masked_sgd"] = dict(
        max_abs_err=max(leaves[m][4] for m in leaves), ms=ms_kernel,
        plain_ms=ms_plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{len(shapes)} leaves, {n_params} f32")

    # -- threshold: the SNIP row (n = all kernel entries, k = n/2) -----------
    n = n_kernel
    k = int(n * 0.5)
    row = torch.randn((1, n), generator=g, device=dev).abs()
    ties = torch.randint(0, 50, (1, n), generator=g, device=dev).float() / 7
    zeros = torch.zeros((1, n), device=dev)
    err = 0.0
    for name, av in (("random", row), ("ties", ties), ("zeros", zeros)):
        got = kernels.threshold_topk(av, k)
        want = exact_threshold(av, k)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"threshold ({name}) {got} != {want}")
        err = max(err, float((got - want).abs().max()))
    ms_kernel = device_ms(lambda: kernels.threshold_topk(row, k))
    ms_plain = device_ms(lambda: exact_threshold(row, k), reps=20)
    ms_lib = device_ms(lambda: torch.topk(row, k).values[..., -1], reps=20)
    b_ms, b_by = bound(4.0 * n + 4.0, 31.0 * n)
    out["threshold"] = dict(
        max_abs_err=err, ms=ms_kernel, plain_ms=ms_plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=ms_lib, shape=f"[1, {n}] f32, k={k}")

    # -- score mask: the seven kernel leaves ----------------------------------
    scores = [torch.rand(s, generator=g, device=dev) for s in kernel_shapes]
    norm = torch.cat([s.reshape(-1) for s in scores]).sum()
    flat = torch.cat([s.reshape(-1) for s in scores]) / norm
    thr = exact_threshold(flat[None], k).reshape(())
    got = kernels.fused_score_mask(scores, norm, thr)
    want = [kernels.score_mask_plain(s, norm, thr) for s in scores]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("score_mask differs from its plain version")
    density = sum(float(m.sum()) for m in got) / n
    if abs(density - 0.5) > 1e-3:
        raise AssertionError(f"score_mask density {density}")
    ms_kernel = device_ms(lambda: kernels.fused_score_mask(scores, norm, thr))
    ms_plain = device_ms(lambda: [kernels.score_mask_plain(s, norm, thr)
                                  for s in scores])
    b_ms, b_by = bound(8.0 * n + 8.0, 2.0 * n)
    out["score_mask"] = dict(
        max_abs_err=max(float((a - b).abs().max()) for a, b in zip(got, want)),
        ms=ms_kernel, plain_ms=ms_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=f"{len(scores)} leaves, {n} f32")
    return out


def small_parity(dev):
    """One narrow SalientGrads round on the CPU and on the GPU from the
    same parameters, mask and batch order."""
    import torch

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.core.trainer import epoch_permutations
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model, init_params
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    ss = phased_sample_shape((69, 69, 69))
    mk = dict(num_classes=1, widths=(8, 16, 16, 16, 16), dropout_rate=0.0,
              sample_shape=ss)
    data = make_synthetic_federated(seed=4, n_clients=3, samples_per_client=6,
                                    test_per_client=5, sample_shape=ss)
    hp = HyperParams(lr=0.01, momentum=0.9, weight_decay=5e-4,
                     grad_clip=10.0, local_epochs=1, steps_per_epoch=3,
                     batch_size=4)
    g = torch.Generator().manual_seed(0)
    params = init_params(create_model("3dcnn_s2d", **mk), g)
    nvals = [int(n) for n in data.n_train]
    perms = [epoch_permutations(g, n, 1, 12, n_rows=data.x_train.shape[1])
             for n in nvals]
    snip_idx = [torch.randint(0, n, (1, 4), generator=g) for n in nvals]
    runs = {}
    for label, device in (("cpu", "cpu"), ("gpu", dev)):
        algo = SalientGrads(create_model("3dcnn_s2d", **mk), data, hp,
                            loss_type="bce", dense_ratio=0.5, device=device)
        state = algo.init_state(
            generator=torch.Generator(device=device).manual_seed(1),
            params=params, snip_idx=snip_idx)
        own_mask = {k: v.cpu() for k, v in state.mask.items()}
        if label == "gpu":  # train from the CPU run's mask
            state.mask = {k: v.to(device) for k, v in runs["cpu"][1].items()}
        state, met = algo.run_round(state, 0, perms=perms)
        ev = algo.evaluate(state)
        runs[label] = (
            {k: v.cpu() for k, v in state.global_params.items()}, own_mask,
            float(met["train_loss"]), {k: float(v) for k, v in ev.items()
                                       if not k.startswith("acc_per")})
    (pc, mc, lc, ec), (pg, mg, lg, eg) = runs["cpu"], runs["gpu"]
    agree = sum(int((mc[k] == mg[k]).sum()) for k in mc) / \
        sum(v.numel() for v in mc.values())
    rel = max(float((pg[k] - pc[k]).norm() / pc[k].norm())
              for k in pc if k.endswith(".kernel"))
    res = {"phase": "parity", "mask_agreement": agree,
           "max_kernel_rel_err": rel, "train_loss_cpu": lc,
           "train_loss_gpu": lg, "eval_cpu": ec, "eval_gpu": eg}
    emit(res)
    if agree < 0.999 or rel > 1e-4 or abs(lc - lg) > 1e-4 * abs(lc) or \
            abs(ec["global_loss"] - eg["global_loss"]) > \
            1e-4 * abs(ec["global_loss"]):
        raise AssertionError(f"GPU round disagrees with the CPU round: {res}")


def main_path(dev):
    import torch

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import device_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    t0 = time.perf_counter()
    data = device_synthetic_federated(
        N_CLIENTS, SAMPLES, phased_sample_shape(VOLUME),
        torch.Generator(device=dev).manual_seed(0), test_per_client=TEST)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    hp = HyperParams(lr=1e-3, lr_decay=0.998, momentum=0.9,
                     weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                     steps_per_epoch=STEPS, batch_size=BATCH)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    model = create_model("3dcnn_s2d", num_classes=1,
                         sample_shape=phased_sample_shape(VOLUME))
    algo = SalientGrads(model, data, hp,
                        loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
                        itersnip_iterations=1, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    state = algo.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, history = algo.run(ROUNDS, eval_every=0, state=state)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)

    rounds = [h for h in history if h["round"] >= 0]
    final = history[-1]
    round_s = [h["round_time_s"] for h in rounds]
    res = {
        "phase": "main", "model": "3dcnn_s2d", "clients": N_CLIENTS,
        "samples_per_client": SAMPLES, "sample_shape":
            list(phased_sample_shape(VOLUME)), "batch": BATCH,
        "steps": STEPS, "rounds": ROUNDS, "compute_dtype": "bfloat16",
        "data_s": data_s, "init_snip_s": init_s, "round_s": round_s,
        "rounds_per_sec_after_first":
            (len(round_s) - 1) / sum(round_s[1:]),
        "first_round_s": round_s[0], "run_with_final_eval_s": run_s,
        "train_loss": [h["train_loss"] for h in rounds],
        "final_eval": final, "peak_mem_bytes": peak, "launches": launches,
    }
    emit(res)
    losses = res["train_loss"] + [final["global_loss"],
                                  final["personal_loss"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(final["mask_density"] - 0.5) > 1e-3:
        raise AssertionError(f"mask density {final['mask_density']}")
    want_sgd = ROUNDS * N_CLIENTS * STEPS * 1  # one launch per step
    if launches["masked_sgd"] != want_sgd or launches["threshold"] != 1 \
            or launches["score_mask"] != 1:
        raise AssertionError(f"launch counts {launches}, expected "
                             f"masked_sgd={want_sgd}, threshold=1, "
                             "score_mask=1")
    for p in state.global_params.values():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError("non-finite global parameters")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from neuroimagedisttraining_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "setup", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    build_s = kernels.build()
    emit({"phase": "build", "seconds": build_s,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in kernels.BUILD_LOG.items()}})

    measured = check_kernels(dev)
    emit({"phase": "kernels", **measured})
    small_parity(dev)
    launches = main_path(dev)

    emit({"kernels": [dict(
        name=name, route="cuda",
        source=f"neuroimagedisttraining_torch/csrc/{kernels.SOURCES[name]}",
        replaces=REPLACES[name], launches=launches[name],
        **{k: v for k, v in measured[name].items() if k != "shape"})
        for name in kernels.SOURCES]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
