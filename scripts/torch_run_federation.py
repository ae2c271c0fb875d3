"""The PyTorch port's multi-process federation launcher: one aggregator
and N site processes (counterpart of ``scripts/run_federation.py``).

Starts ``python -m neuroimagedisttraining_torch.experiments`` once per
role with ``subprocess`` (a fresh interpreter each: nothing is forked
after CUDA is up) over the native TCP transport, allocating free
loopback ports and wiring ``--fed_endpoints`` for every rank, and passes
``--device`` to every process: each runs on the card (CUDA, which must be
present) unless ``--device cpu`` is given. Everything after ``--`` is
forwarded verbatim to each process (the experiment config: algo, model,
dataset, rounds, fed mode/sites/buffer flags).

    # 2 sites on the card, synchronous rounds (bit-identical to the
    # in-process run), at full width
    python scripts/torch_run_federation.py --sites 2 -- \
        --algo fedavg --dataset synthetic_volume --layout s2d \
        --model 3dcnn --client_num_in_total 8 --frac 1.0 --batch_size 8 \
        --compute_dtype bfloat16 --comm_round 2 --final_finetune 0 \
        --fed_mode sync

    # buffered async on the CPU, flush at K=2, with a real straggling site
    python scripts/torch_run_federation.py --sites 3 --device cpu -- \
        --algo fedavg --dataset synthetic --model small3dcnn \
        --client_num_in_total 6 --fed_mode buffered --fed_buffer_k 2 \
        --fed_site_faults "3:straggle=1.0:6.0" --comm_round 4

Sites are started FIRST so their listeners are bound before the
aggregator's round-0 dispatch; the aggregator's ``send_with_retry``
backoff covers the residual connect race. The launcher's exit code is
the aggregator's; site processes are terminated if they outlive the
aggregator by ``--site_grace`` seconds (a deliberately-straggling site
may still be asleep in its handler when the federation finishes).

Prints one JSON line describing the launch (ports, exit codes, the
output directory).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time

RUNNER = ["-m", "neuroimagedisttraining_torch.experiments"]


def free_ports(n: int, host: str = "127.0.0.1"):
    """Bind-to-0 allocation: n distinct free ports, released at once so
    no two ranks are handed the same port."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind((host, 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--sites", type=int, required=True,
                   help="number of site processes (world = sites + 1)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--ports", type=str, default="",
                   help="comma-separated ports, rank-ordered "
                        "(aggregator first); default: auto-allocate")
    p.add_argument("--out", type=str, default="",
                   help="shared --fed_out directory (default: every "
                        "process derives the same identity-keyed dir)")
    p.add_argument("--site_grace", type=float, default=30.0,
                   help="seconds to let sites drain after the "
                        "aggregator exits before terminating them")
    p.add_argument("--device", type=str, default="cuda",
                   help="every process's --device: cuda (the default; "
                        "it must be present) or cpu")
    p.add_argument("--python", type=str, default=sys.executable)
    p.add_argument("runner_args", nargs=argparse.REMAINDER,
                   help="args after -- go to every runner process")
    args = p.parse_args(argv)

    passthrough = list(args.runner_args)
    if passthrough and passthrough[0] == "--":
        passthrough = passthrough[1:]
    if args.sites < 1:
        p.error("--sites must be >= 1")
    for flag in ("--fed_role", "--fed_site_rank", "--fed_endpoints",
                 "--fed_backend", "--fed_sites", "--device"):
        if flag in passthrough:
            p.error(f"{flag} is set by the launcher; remove it from "
                    "the runner args")

    world = args.sites + 1
    if args.ports:
        ports = [int(x) for x in args.ports.split(",") if x.strip()]
        if len(ports) != world:
            p.error(f"--ports needs {world} entries (got {len(ports)})")
    else:
        ports = free_ports(world, args.host)
    endpoints = ",".join(f"{args.host}:{port}" for port in ports)

    common = passthrough + [
        "--fed_backend", "tcp", "--fed_sites", str(args.sites),
        "--fed_endpoints", endpoints, "--device", args.device,
    ]
    if args.out:
        common += ["--fed_out", args.out]
    env = dict(os.environ)
    # the launcher's own directory is not the package's: run the port
    # from the checkout this script belongs to
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])

    procs = {}
    try:
        for rank in range(1, world):
            cmd = [args.python] + RUNNER + common + [
                "--fed_role", "site", "--fed_site_rank", str(rank)]
            procs[rank] = subprocess.Popen(cmd, env=env)
        agg_cmd = [args.python] + RUNNER + common + [
            "--fed_role", "aggregator"]
        agg = subprocess.Popen(agg_cmd, env=env)
        procs[0] = agg
        agg_rc = agg.wait()
        deadline = time.monotonic() + args.site_grace
        site_rcs = {}
        for rank in range(1, world):
            left = max(deadline - time.monotonic(), 0.0)
            try:
                site_rcs[rank] = procs[rank].wait(timeout=left)
            except subprocess.TimeoutExpired:
                procs[rank].terminate()
                try:
                    site_rcs[rank] = procs[rank].wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    procs[rank].kill()
                    site_rcs[rank] = procs[rank].wait()
        print(json.dumps({
            "launcher_ok": agg_rc == 0,
            "world": world, "ports": ports,
            "aggregator_rc": agg_rc,
            "site_rcs": {str(k): v for k, v in sorted(site_rcs.items())},
            "device": args.device,
            "out": args.out or "(identity-derived, see aggregator log)",
        }))
        return agg_rc
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass


if __name__ == "__main__":
    sys.exit(main())
