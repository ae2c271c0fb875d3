#!/usr/bin/env python3
"""One profiled round on a client mesh of several processes, for the
PyTorch/CUDA port's observability tier: the device time of its collectives
against its compute, as ``obs.devtrace`` attributes it.

    python3 scripts/torch_obs_mesh_trace.py [--ranks 4] [--rounds 2]
        [--device cuda|cpu] [--out PATH]

Spawns ``--ranks`` processes joined over a ``file://`` rendezvous: on
``cuda`` one a card over NCCL, each running the main configuration of
``chip_smoke.py`` at full width (SalientGrads on ``3dcnn_s2d``, 8 clients x
40 phased 121x145x121 bf16 volumes made on each card from seed 0, each rank
keeping its block, batch 8, 5 steps, bf16 compute, cuDNN deterministic);
on ``cpu`` gloo ranks at a narrow width (``small3dcnn`` on 8x8x8 volumes),
which is how the script is checked without cards. Every rank builds the
SNIP mask, then profiles one eager round (``utils.profiling.
trace_one_round``: a warm round, then the round under ``torch.profiler``;
rank 0 alone writes the trace) and runs ``--rounds`` rounds with an obs
session (``obs.export.ObsSession``: every rank records, rank 0 alone writes
the JSONL). Rank 0's profiled round is attributed by ``obs.devtrace``: busy
seconds, the collectives' (NCCL's kernels) seconds and share, their overlap
with compute. One card's NCCL communicator launches no kernel (NCCL copies
on one rank), so the collectives' share shows only with two ranks or more.

Prints one JSON line (the record; also written to ``--out``). Exits 1 when
a check fails: rank 0 alone wrote the JSONL and the trace, one line a
round; on the cards the trace holds NCCL kernels and their share is above
0.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data_and_algo(device, mesh):
    """The rank's block of the cohort and its SalientGrads."""
    import torch

    sys.path.insert(0, ROOT)
    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import (
        device_synthetic_federated,
        make_synthetic_federated,
    )
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.parallel.mesh import shard_federated

    if torch.device(device).type == "cuda":
        shape = phased_sample_shape((121, 145, 121))
        data = device_synthetic_federated(
            8, 40, shape, torch.Generator(device=device).manual_seed(0),
            test_per_client=10)
        model = create_model("3dcnn_s2d", num_classes=1, sample_shape=shape)
        hp = HyperParams(lr=1e-3, lr_decay=0.998, momentum=0.9,
                         weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                         steps_per_epoch=5, batch_size=8)
        kw = dict(compute_dtype="bfloat16")
    else:
        data = make_synthetic_federated(seed=0, n_clients=8,
                                        samples_per_client=16,
                                        test_per_client=4)
        model = create_model("small3dcnn", num_classes=1)
        hp = HyperParams(lr=0.01, momentum=0.9, local_epochs=1,
                         steps_per_epoch=2, batch_size=8)
        kw = {}
    return SalientGrads(model, shard_federated(data, mesh), hp,
                        loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
                        itersnip_iterations=1, **kw)


def rank_main(rank, world, directory, device, rounds):
    """One rank: SNIP, a profiled round, ``rounds`` recorded rounds; rank 0
    leaves its record in ``directory``."""
    import torch

    sys.path.insert(0, ROOT)
    from neuroimagedisttraining_torch.obs import devtrace
    from neuroimagedisttraining_torch.obs import export as obs_export
    from neuroimagedisttraining_torch.parallel.mesh import make_mesh
    from neuroimagedisttraining_torch.utils.profiling import trace_one_round
    from neuroimagedisttraining_torch.utils.records import DeferredRecords

    if device == "cuda":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    else:
        torch.set_num_threads(1)
    mesh = make_mesh(world, init_method="file://" + os.path.join(
        directory, "rdv"), rank=rank, device=device)
    algo = None
    try:
        algo = _data_and_algo(device, mesh)
        session = obs_export.ObsSession(
            jsonl_path=os.path.join(directory, "out", "mesh.obs.jsonl"),
            identity="mesh", comm=True)
        try:
            state = algo.init_state()
            prof = os.path.join(directory, "out", "prof")
            round_ms = trace_one_round(algo, state, prof, export=rank == 0)
            deferred = DeferredRecords(log=session.record_round, timed=True)
            for r in range(rounds):
                state, met = algo.run_round(state, r)
                deferred.push({"round": r, **met})
            deferred.flush()
            session.finish()
        finally:
            session.close()
        mesh.barrier()
        if rank == 0:
            summary = devtrace.analyze_profile_dir(prof)
            names = set()
            for path in devtrace.find_trace_files(prof):
                for e in devtrace.load_trace_doc(path)["traceEvents"]:
                    if e.get("cat") == devtrace.KERNEL_CAT and \
                            devtrace.is_collective(str(e.get("name"))):
                        names.add(e["name"])
            rec = {"ranks": world, "backend": mesh.backend,
                   "device": (torch.cuda.get_device_name(0)
                              if device != "cpu" else "cpu"),
                   "round_ms": round_ms, "present": summary["present"],
                   "totals": summary.get("totals"),
                   "top_collectives": summary.get("top_collectives"),
                   "nccl_kernels": sorted(names)}
            with open(os.path.join(directory, "rank0.json"), "w") as f:
                json.dump(rec, f)
        mesh.barrier()
    finally:
        if algo is not None:
            algo.release_graphs()
        mesh.destroy()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args()
    import torch
    import torch.multiprocessing as mp

    sys.path.insert(0, ROOT)
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"torch_obs_mesh_trace: {args.ranks} ranks need as many "
                  f"cards, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        from neuroimagedisttraining_torch.ops import kernels

        kernels.build()
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(rank_main, args=(args.ranks, d, args.device,
                                            args.rounds),
                           nprocs=args.ranks, join=True,
                           start_method="spawn")
        with open(os.path.join(d, "rank0.json")) as f:
            rec = json.load(f)
        out = os.path.join(d, "out")
        with open(os.path.join(out, "mesh.obs.jsonl")) as f:
            lines = sum(1 for _ in f)
        traces = [x for x in os.listdir(os.path.join(out, "prof"))]
    rec.update(jsonl_lines=lines, trace_files=len(traces))
    if args.device == "cuda":
        import subprocess

        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    ok = lines == args.rounds and len(traces) == 1
    if args.device == "cuda":
        ok = ok and rec["present"] and bool(rec["nccl_kernels"]) and \
            rec["totals"]["agg_share"] > 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
