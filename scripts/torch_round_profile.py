#!/usr/bin/env python3
"""Where one training round's device time goes, for the PyTorch/CUDA port.

    python3 scripts/torch_round_profile.py [--rounds-warm 1] [--fused]
        [--model 3dcnn_s2d|3dcnn]

Builds the main-path workload (SalientGrads, AlexNet3DS2D, 8 clients x 40
phased 121x145x121 volumes, batch 8, 5 steps, bf16, dropout 0.5; with
``--model 3dcnn`` the dense-stem AlexNet3D on the same volumes stored
``(121, 145, 121, 1)``, its stem conv on cuDNN), runs the
SNIP init and warm rounds unprofiled, then traces one round with
``torch.profiler`` (CPU + CUDA). Prints one JSON line: the round's wall
time, the summed device time and the device's busy share, device time by
kernel class (the stem kernels apart), the top kernels by self device time,
the top aten ops (device time including children) with their input shapes,
every aten op on a tensor of the stem's full-resolution shape (such as a
sum over the stem backward's ``dzs``; the dense stem's conv output
``(8, 64, 59, 71, 59)``), and the card's name and power
limit. With ``--fused`` it also traces the same round as one block of
``run_rounds_fused`` (the host's draws, one replay of the captured round
graph, the block's one metric fetch), after a block that captured it, and
the line holds both traces under ``eager`` and ``fused``. Needs one GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: kernel classes, matched in order against the lower-cased kernel name;
#: the stem kernels (csrc/stem_fwd.cu, csrc/stem_bwd.cu) are a class of
#: their own, the port's other kernels another
CLASSES = (
    ("stem_kernels", ("stem_fwd", "stem_bwd", "stem_wprep", "stem_stats")),
    ("port_kernels", ("masked_sgd_kernel", "threshold_", "score_mask_kernel",
                      "mask_apply_kernel", "weighted_sum_kernel",
                      "quantize_reduce_kernel")),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad",
              "fprop", "sm90", "cutlass", "gemm", "nchw", "ndhwc")),
    ("pool", ("max_pool", "pool")),
    ("reduce", ("reduce", "sum", "mean", "norm")),
    ("copy", ("copy", "memcpy", "memset", "cat", "index", "gather",
              "scatter")),
)


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise_other"


def trace(fn, zs_shape: str) -> dict:
    """``fn()`` (ending in a synchronize) under ``torch.profiler``: its wall
    time, device time in all, by class and by kernel, and the aten ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if dt > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dt / 1e3, ev.count))
    device_ms = sum(ms for _, ms, _ in rows)
    by_class = {}
    for name, ms, _ in rows:
        c = classify(name)
        by_class[c] = by_class.get(c, 0.0) + ms
    rows.sort(key=lambda t: -t[1])
    ops = []  # aten ops by device time, with their input shapes
    for ev in prof.key_averages(group_by_input_shape=True):
        dt = getattr(ev, "device_time_total",
                     getattr(ev, "cuda_time_total", 0.0))
        if ev.key.startswith("aten::") and dt > 0:
            shapes = str(ev.input_shapes)
            ops.append({"op": ev.key, "ms": dt / 1e3, "count": ev.count,
                        "shapes": shapes[:160],
                        "on_zs": shapes.startswith("[" + zs_shape)})
    ops.sort(key=lambda o: -o["ms"])
    return {
        "round_wall_ms": wall * 1e3, "device_ms": device_ms,
        "device_busy_share": device_ms / (wall * 1e3) if wall else None,
        "kernels": sum(c for _, _, c in rows),
        "by_class_ms": dict(sorted(by_class.items(), key=lambda t: -t[1])),
        "top": [{"kernel": n[:120], "ms": ms, "count": c}
                for n, ms, c in rows[:15]],
        "top_ops": ops[:12],
        # every aten op whose first input is the stem's full-resolution zs
        # or its cotangent (B, D, H, W, F) at batch 8
        "ops_on_zs": [o for o in ops if o["on_zs"]],
    }


def main() -> int:
    import torch

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import device_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds-warm", type=int, default=1)
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--model", choices=("3dcnn_s2d", "3dcnn"),
                    default="3dcnn_s2d")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_round_profile: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kernels.build()
    vol = (121, 145, 121)
    ss = phased_sample_shape(vol) if args.model == "3dcnn_s2d" else \
        vol + (1,)
    data = device_synthetic_federated(
        8, 40, ss, torch.Generator(device=dev).manual_seed(0),
        test_per_client=10)
    hp = HyperParams(lr=1e-3, lr_decay=0.998, momentum=0.9,
                     weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                     steps_per_epoch=5, batch_size=8)
    algo = SalientGrads(create_model(args.model, sample_shape=ss), data, hp,
                        loss_type="bce", dense_ratio=0.5,
                        compute_dtype="bfloat16")
    state = algo.init_state()
    for r in range(args.rounds_warm):
        state, met = algo.run_round(state, r)
        float(met["train_loss"])
    r = args.rounds_warm
    zs_shape = str([8, ss[0] - 2, ss[1] - 2, ss[3] - 2, 64]
                   if args.model == "3dcnn_s2d" else
                   [8, 64] + [(s - 5) // 2 + 1 for s in vol])

    def eager():
        float(algo.run_round(state, r)[1]["train_loss"])
        torch.cuda.synchronize()

    def fused():
        algo.run_rounds_fused(state, r, 1)[1].materialize()
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    out = {"eager": trace(eager, zs_shape)}
    if args.fused:
        fused()  # builds and captures the round graph
        out["fused"] = trace(fused, zs_shape)
    else:
        out = out["eager"]
    out.update(model=args.model, device=torch.cuda.get_device_name(0),
               name_power_limit=subprocess.run(
                   ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], capture_output=True,
                   text=True, timeout=60).stdout.strip())
    print(json.dumps(out), flush=True)
    traces = [out[k] for k in ("eager", "fused") if k in out] or [out]
    if not all(t["device_ms"] > 0 for t in traces):
        print("torch_round_profile: a trace holds no device time",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
