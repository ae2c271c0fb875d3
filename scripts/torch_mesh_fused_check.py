#!/usr/bin/env python3
"""Fused round blocks on a client mesh of several processes, for the
PyTorch/CUDA port: each block bitwise the same rounds run eagerly, and the
rates of both spellings; the robust tier's blocks, the seven other
algorithms' and the client store's likewise, and checkpoints resumed on the
mesh bitwise their uninterrupted runs.

    python3 scripts/torch_mesh_fused_check.py [--ranks 4] [--rounds 3]
        [--device cuda|cpu] [--cases all|plain|robust|baselines|store]
        [--out PATH]

Spawns ``--ranks`` processes joined over a ``file://`` rendezvous: on
``cuda`` one a card over NCCL (the main configuration of ``chip_smoke.py``
at full width: SalientGrads on ``3dcnn_s2d``, 8 clients x 40 phased
121x145x121 bf16 volumes made on each card from seed 0, each rank keeping
its block, batch 8, 5 steps, bf16 compute, cuDNN deterministic); on
``cpu`` gloo ranks at a narrow width (``small3dcnn`` on 8x8x8 volumes),
which is how the script is checked without cards. SNIP once, then for each
case of :data:`CASES` (wire, participation), from the SNIP state:

* ``--rounds`` eager rounds (``run_round``, the eval after each) and a
  fused block of the same rounds with the eval every round
  (``run_rounds_fused``): state, train losses and evals bitwise on every
  rank;
* the block again with the mesh's collectives counted where Python calls
  them (zero when no round captures a new graph: every collective then
  runs inside a graph's replay);
* rounds/s of each spelling, the slowest rank's (a barrier, then the
  synchronised host clock, then an ``all_reduce(MAX)``), in the order
  eager, fused, fused, eager, each pair on ``--rounds`` rounds that no
  block ran before (at partial participation new draws, so the fused
  block pays the graph captures a run pays; ``captures_in_timed_blocks``
  counts them).

``--cases robust`` (or ``all``) runs the same for each case of
:data:`ROBUST_CASES` (faults, the guard, a defense, ``robust_agg``, from
``tests/test_torch_port_mesh_robust.py``; SalientGrads from the SNIP
state, FedAvg from its own init), then the checkpoint check: the top-k
case's ``--rounds`` eager rounds with a checkpoint after round 0 (every
rank saving, rank 0 writing the single-process layout), and a fresh
algorithm restoring it and running the rest, bitwise the uninterrupted
rounds on every rank.

``--cases baselines`` (or ``all``) runs each of :data:`BASELINE_CASES`
(Local, Ditto, SubAvg, DPSGD, DisPFL, FedFomo, TurboAggregate, from their
own init): the same for the five with a fused loop; FedFomo and
TurboAggregate, whose host work reads the round's results, their eager
rounds and eager rates alone (FedFomo on the last tenth of each shard as
its validation rows). Then DisPFL's checkpoint check, as the top-k
case's.

``--cases store`` (or ``all``) runs each of :data:`STORE_CASES`
(SalientGrads on the top-k wire, FedAvg, Ditto) with a disk client store
over a population of :data:`STORE_CLIENTS` clients at ``frac``
:data:`STORE_FRAC` (``chip_smoke.py``'s state phase: 32 clients at 0.25 on
the cards; 8 on the CPU), each rank keeping its block of the volumes on
the host and of the rows in its store: ``--rounds`` eager streamed rounds
and a fused store block of the same rounds from a second algorithm (a
store of its own), the metrics, the global model and every stored row of
the rank's block bitwise; the block again from a fresh state with the
collectives counted; the captures the first block made (at partial
participation a round's spread over the ranks keys its graph); the rates
in pairs as above (no eval: a store's fused block evaluates between
blocks). Then the store-backed checkpoint check on SalientGrads' case: a
step after round 0 with the store's sidecar, resumed by a fresh algorithm
and store, bitwise the uninterrupted rounds in the state and the rows.

Rank 0 prints one JSON line per case and a last line with the cards' name
and power limit (``nvidia-smi``), and writes them all to ``--out``. Exits
1 when a block is not bitwise its eager rounds. Every rank notes each step
on its standard error; a collective waits at most ``COLLECTIVE_TIMEOUT_S``
(NCCL's watchdog), and a rank still running after ``STALL_S`` prints every
thread's stack and exits (a collective replayed from a graph is not
watched). It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: (agg_impl, frac): the wires whose reduce runs on the mesh, at full and
#: at partial participation (where the trained rows are gathered first)
CASES = (("dense", 1.0), ("int8", 1.0), ("hier", 1.0), ("dense", 0.5),
         ("int8", 0.5))
#: (name, algorithm, agg_impl, robust_agg, defense, fault spec, run seed)
ROBUST_CASES = (
    ("salientgrads_krum_weak_dp", "salientgrads", "dense", "krum", "weak_dp",
     "drop=0.3,nan=0.3,scale=0.3:10x,labelflip=0.3", 11),
    ("fedavg_int8_median_clip", "fedavg", "int8", "median",
     "norm_diff_clipping",
     "straggle=0.4,signflip=0.3,collude=0.4:5x,labelflip=0.4,nan=0.2", 0),
    ("salientgrads_topk_nan", "salientgrads", "topk", "none", None,
     "nan=0.34", 0),
)
#: the robust case the checkpoint check resumes
CKPT_CASE = "salientgrads_topk_nan"
#: (name, algorithm class, options): the seven algorithms besides
#: SalientGrads and FedAvg at ``chip_smoke.py``'s mesh configurations
BASELINE_CASES = (
    ("local", "LocalOnly", dict(frac=0.5)),
    ("ditto", "Ditto", dict()),
    ("subavg", "SubAvg", dict(frac=0.5, dense_ratio=0.5, epochs=2)),
    ("dpsgd", "DPSGD", dict(frac=0.5)),
    ("dispfl", "DisPFL", dict(frac=0.5, dense_ratio=0.5, total_rounds=10)),
    ("fedfomo", "FedFomo", dict()),
    ("turboaggregate", "TurboAggregate", dict()),
)
#: the baseline the checkpoint check resumes, and FedFomo's validation
#: share of each shard
BASELINE_CKPT, FOMO_VAL_FRACTION = "dispfl", 0.1
#: (name, algorithm, agg_impl) with a disk client store; the population
#: (on the cards; 8 clients on the CPU), its sampled fraction and a store's
#: hot rows; the case the store's checkpoint check resumes
STORE_CASES = (("store_salientgrads_topk", "salientgrads", "topk"),
               ("store_fedavg", "fedavg", "dense"),
               ("store_ditto", "ditto", "dense"))
STORE_CLIENTS, STORE_FRAC, STORE_HOT = 32, 0.25, 8
STORE_CKPT = "store_salientgrads_topk"
N_CLIENTS, SAMPLES, TEST, BATCH, STEPS = 8, 40, 10, 8, 5
VOLUME = (121, 145, 121)
COLLECTIVE_TIMEOUT_S = 120
STALL_S = 240


def _note(rank: int, what: str) -> None:
    print(f"[rank {rank} {time.strftime('%H:%M:%S')}] {what}",
          file=sys.stderr, flush=True)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _clock(dev, mesh, t0=None):
    """The host clock at a barrier (``t0`` None), else the slowest rank's
    seconds since ``t0``."""
    import torch
    import torch.distributed as dist

    _sync(dev)
    if t0 is None:
        mesh.barrier()
        _sync(dev)
        return time.perf_counter()
    t = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                     device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t)


def _cohort(dev, mesh, clients=N_CLIENTS, host=False):
    """The cohort (``clients`` of them), its model and hyperparameters:
    full width on the card, narrow on the CPU; this rank's block of it
    (on the host with ``host``)."""
    import torch

    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import device_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.parallel.mesh import shard_federated

    g = torch.Generator(device=dev).manual_seed(0)
    if dev.type == "cuda":
        shape = phased_sample_shape(VOLUME)
        data = device_synthetic_federated(clients, SAMPLES, shape, g,
                                          test_per_client=TEST)
        hp = HyperParams(lr=1e-3, lr_decay=0.998, momentum=0.9,
                         weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                         steps_per_epoch=STEPS, batch_size=BATCH)

        def model():
            return create_model("3dcnn_s2d", num_classes=1,
                                sample_shape=shape)
    else:
        data = device_synthetic_federated(clients, 8, (8, 8, 8, 1), g,
                                          test_per_client=4)
        hp = HyperParams(lr=1e-3, lr_decay=0.998, momentum=0.9,
                         weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                         steps_per_epoch=2, batch_size=4)

        def model():
            return create_model("small3dcnn", num_classes=1,
                                dropout_rate=0.5)
    if host:
        data = data.to("cpu")
    return shard_federated(data, mesh, host=host), model, hp


def _trees(state):
    import dataclasses

    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), dict)}


def _bitwise(a_state, a_mets, a_evals, b_state, ys):
    import torch

    host = ys.materialize()
    if any(float(host["train_loss"][i]) != float(m["train_loss"])
           for i, m in enumerate(a_mets)):
        return False
    if any(float(host["eval"][k][i]) != float(ev[k])
           for i, ev in enumerate(a_evals) for k in host["eval"]):
        return False
    b = _trees(b_state)
    return all(torch.equal(t[k], b[f][k]) for f, t in _trees(a_state).items()
               for k in t)


def _case(algo, state, rounds, dev, mesh, note):
    """One case on this rank: the eager rounds and the fused block, the
    block counted, the rates in pairs."""
    s, mets, evals = algo.clone_state(state), [], []
    for r in range(rounds):
        s, met = algo.run_round(s, r)
        mets.append(met)
        evals.append({k: v for k, v in algo.evaluate(s).items()
                      if not k.startswith("acc_per")})
        _sync(dev)
        note(f"eager round {r}")
    sf, ys = algo.run_rounds_fused(state, 0, rounds, eval_every=1)
    bitwise = _bitwise(s, mets, evals, sf, ys)
    note(f"fused block, bitwise {bitwise}")
    calls = {"all_gather": 0, "all_reduce": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    for name in calls:
        setattr(mesh, name, counted(name, getattr(mesh, name)))
    captured = algo._fused.evicted + len(algo._fused.rounds)
    algo.run_rounds_fused(state, 0, rounds, eval_every=1)[1].materialize()
    captures = algo._fused.evicted + len(algo._fused.rounds) - captured
    for name in calls:
        delattr(mesh, name)

    def eager(start):
        t0, st = _clock(dev, mesh), state
        for r in range(start, start + rounds):
            st, _ = algo.run_round(st, r)
            algo.evaluate(st)
        return rounds / _clock(dev, mesh, t0)

    def fused(start):
        t0 = _clock(dev, mesh)
        algo.run_rounds_fused(state, start, rounds, eval_every=1)[1] \
            .materialize()
        return rounds / _clock(dev, mesh, t0)

    # each pair on rounds no block has run yet: at partial participation
    # their draws are new, so a fused block pays the captures a run pays
    rates = {"eager": [], "fused": []}
    timed_captures = 0
    for i, kind in enumerate(("eager", "fused", "fused", "eager")):
        start = rounds * (1 + i // 2)
        before = algo._fused.evicted + len(algo._fused.rounds)
        rates[kind].append(eager(start) if kind == "eager" else fused(start))
        timed_captures += algo._fused.evicted + len(algo._fused.rounds) \
            - before
    note("rates")
    return {"bitwise": bitwise, "collective_calls_in_block": calls,
            "captures_in_block": captures,
            "captures_in_timed_blocks": timed_captures,
            "graphs": len(algo._fused.rounds),
            "rounds_per_sec_eager": rates["eager"],
            "rounds_per_sec_fused": rates["fused"]}


def _robust_algo(case, data, model, hp, dev):
    """The algorithm of a :data:`ROBUST_CASES` entry."""
    from neuroimagedisttraining_torch.algorithms import FedAvg, SalientGrads
    from neuroimagedisttraining_torch.robust import RobustAggregator

    _, name, impl, robust, defense, spec, seed = case
    kw = dict(loss_type="bce", frac=1.0, seed=seed, compute_dtype="bfloat16",
              agg_impl=impl, robust_agg=robust, fault_spec=spec,
              defense=(RobustAggregator(defense, 5.0, 0.025) if defense
                       else None), device=dev)
    if name == "salientgrads":
        return SalientGrads(model(), data, hp, dense_ratio=0.5,
                            itersnip_iterations=1, **kw)
    return FedAvg(model(), data, hp, **kw)


def _robust_state(algo, case, state0):
    import dataclasses

    from neuroimagedisttraining_torch.core.state import zeros_like_tree

    if case[1] != "salientgrads":
        return algo.init_state()
    return dataclasses.replace(
        algo.clone_state(state0),
        agg_residual=(zeros_like_tree(state0.personal_params)
                      if case[2] == "topk" else None))


def _baseline_algo(case, data, model, hp, dev):
    """The algorithm of a :data:`BASELINE_CASES` entry (bf16 compute, run
    seed 0; FedFomo on its validation split)."""
    import dataclasses

    import torch

    from neuroimagedisttraining_torch import algorithms

    _, cls_name, opts = case
    kw = {k: v for k, v in opts.items() if k != "epochs"}
    if "epochs" in opts:
        hp = dataclasses.replace(hp, local_epochs=opts["epochs"])
    if cls_name == "FedFomo":
        n = data.x_train.shape[1]
        nv = max(1, int(FOMO_VAL_FRACTION * n))
        c = len(data.n_train)
        data = dataclasses.replace(
            data, x_train=data.x_train[:, :n - nv],
            y_train=data.y_train[:, :n - nv],
            n_train=torch.full((c,), n - nv, dtype=torch.int32),
            x_val=data.x_train[:, n - nv:], y_val=data.y_train[:, n - nv:],
            n_val=torch.full((c,), nv, dtype=torch.int32))
    return getattr(algorithms, cls_name)(
        model(), data, hp, loss_type="bce", seed=0,
        compute_dtype="bfloat16", device=dev, **kw)


def _eager_case(algo, state, rounds, dev, mesh, note):
    """An algorithm without a fused loop on this rank: its eager rounds
    with the eval after each, timed twice (the slowest rank's rate)."""
    rates = []
    for _ in range(2):
        t0, s = _clock(dev, mesh), state
        for r in range(rounds):
            s, _ = algo.run_round(s, r)
            algo.evaluate(s)
        rates.append(rounds / _clock(dev, mesh, t0))
        note("eager rounds")
    return {"bitwise": True, "fused": False, "rounds_per_sec_eager": rates}


def _ckpt_check(case, data, model, hp, dev, state0, rounds, directory,
                note, build=None):
    """The checkpoint check (module docstring): whether the resumed rounds
    are bitwise the uninterrupted ones on this rank, and the save's and
    the restore's seconds; a baseline's (``build`` its algorithm) from its
    own init."""
    import torch

    from neuroimagedisttraining_torch.utils.checkpoint import \
        CheckpointManager

    build = build or _robust_algo
    a = build(case, data, model, hp, dev)
    mgr = CheckpointManager(os.path.join(directory, "ck_" + case[0]),
                            layout=a)
    s = (a.init_state() if build is not _robust_algo
         else _robust_state(a, case, state0))
    save_s = None
    for r in range(rounds):
        s, _ = a.run_round(s, r)
        if r == 0:
            t0 = time.perf_counter()
            mgr.save(1, s)
            save_s = time.perf_counter() - t0
    note("checkpoint: uninterrupted rounds")
    b = build(case, data, model, hp, dev)
    mgr_b = CheckpointManager(os.path.join(directory, "ck_" + case[0]),
                              layout=b)
    t0 = time.perf_counter()
    r_state, step = mgr_b.restore_latest(b.init_state())
    _sync(dev)
    restore_s = time.perf_counter() - t0
    for r in range(step, rounds):
        r_state, _ = b.run_round(r_state, r)
    note("checkpoint: resumed rounds")
    a_trees, b_trees = _trees(s), _trees(r_state)
    same = step == 1 and all(torch.equal(t[k], b_trees[f][k])
                             for f, t in a_trees.items() for k in t)
    return {"case": case[0], "checkpoint_resumed_bitwise": same,
            "save_s": save_s, "restore_s": restore_s,
            "save_failures": mgr.save_failures}


def _store_algo(case, data, model, hp, dev, store_dir):
    """The algorithm of a :data:`STORE_CASES` entry with its disk store
    under ``store_dir``."""
    from neuroimagedisttraining_torch import algorithms

    _, name, impl = case
    cls = {"salientgrads": "SalientGrads", "fedavg": "FedAvg",
           "ditto": "Ditto"}[name]
    kw = dict(dense_ratio=0.5, itersnip_iterations=1) \
        if name == "salientgrads" else {}
    return getattr(algorithms, cls)(
        model(), data, hp, loss_type="bce", frac=STORE_FRAC, seed=0,
        compute_dtype="bfloat16", agg_impl=impl, client_store="disk",
        store_hot_clients=STORE_HOT, store_dir=store_dir, device=dev, **kw)


def _store_rows(algo):
    """The rows this rank's store holds, by field (staged rows committed
    first), on the host."""
    algo.store_flush()
    return {f: algo._store.gather_all(f) for f in algo._store.field_names()}


def _store_same(a_state, a_rows, b_state, b_rows):
    import torch

    a, b = _trees(a_state), _trees(b_state)
    return a.keys() == b.keys() and all(
        torch.equal(t[k], b[f][k]) for f, t in a.items() for k in t) and \
        a_rows.keys() == b_rows.keys() and all(
            torch.equal(t[k], b_rows[f][k]) for f, t in a_rows.items()
            for k in t)


def _store_case(make, rounds, dev, mesh, note):
    """A store case on this rank (module docstring)."""
    a = make("eager")
    s, mets = a.init_state(), []
    for r in range(rounds):
        s, met = a.run_round(s, r)
        mets.append(met)
        _sync(dev)
        note(f"eager round {r}")
    b = make("fused")
    sf, ys = b.run_rounds_fused(b.init_state(), 0, rounds)
    host = ys.materialize()
    bitwise = all(float(host[k][i]) == float(m[k])
                  for i, m in enumerate(mets) for k in host) and \
        _store_same(s, _store_rows(a), sf, _store_rows(b))
    captures = b._fused.evicted + len(b._fused.rounds)
    note(f"fused block, bitwise {bitwise}, {captures} captures")
    calls = {"all_gather": 0, "all_reduce": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    s2 = b.init_state()  # the store starts over; the graphs stay
    for name in calls:
        setattr(mesh, name, counted(name, getattr(mesh, name)))
    before = b._fused.evicted + len(b._fused.rounds)
    s2, _ = b.run_rounds_fused(s2, 0, rounds)
    again = b._fused.evicted + len(b._fused.rounds) - before
    for name in calls:
        delattr(mesh, name)
    bitwise = bitwise and _store_same(s, _store_rows(a), s2, _store_rows(b))

    def eager(start):
        t0, st = _clock(dev, mesh), s
        for r in range(start, start + rounds):
            st, _ = a.run_round(st, r)
        return rounds / _clock(dev, mesh, t0)

    def fused(start):
        t0 = _clock(dev, mesh)
        b.run_rounds_fused(sf, start, rounds)[1].materialize()
        return rounds / _clock(dev, mesh, t0)

    rates = {"eager": [], "fused": []}
    timed_captures = 0
    for i, kind in enumerate(("eager", "fused", "fused", "eager")):
        start = rounds * (1 + i // 2)
        before = b._fused.evicted + len(b._fused.rounds)
        rates[kind].append(eager(start) if kind == "eager" else fused(start))
        timed_captures += b._fused.evicted + len(b._fused.rounds) - before
    note("rates")
    evictions = b._fused.evicted
    # NCCL keeps a communicator while a graph holding its collectives
    # lives: drop them before the mesh goes
    b.release_graphs()
    return {"bitwise": bitwise, "collective_calls_in_block": calls,
            "captures_in_block": captures,
            "captures_in_second_block": again,
            "captures_in_timed_blocks": timed_captures,
            "evictions": evictions, "store_stats": a._store.stats(),
            "rounds_per_sec_eager": rates["eager"],
            "rounds_per_sec_fused": rates["fused"]}


def _store_ckpt_check(make, rounds, dev, directory, note):
    """The store-backed checkpoint check (module docstring): whether the
    resumed rounds are bitwise the uninterrupted ones in the state and
    this rank's rows, the save's and the restore's seconds."""
    from neuroimagedisttraining_torch.utils.checkpoint import \
        CheckpointManager

    a = make("ck_run")
    mgr = CheckpointManager(os.path.join(directory, "ck_store"), layout=a)
    s = a.init_state()
    save_s = None
    for r in range(rounds):
        s, _ = a.run_round(s, r)
        if r == 0:
            t0 = time.perf_counter()
            mgr.save(1, s, store=a._store)
            save_s = time.perf_counter() - t0
    note("store checkpoint: uninterrupted rounds")
    b = make("ck_resumed")
    template = b.init_state()
    _sync(dev)
    t0 = time.perf_counter()
    r_state, step = CheckpointManager(
        os.path.join(directory, "ck_store"), layout=b).restore_latest(
            template, store=b._store)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    for r in range(step, rounds):
        r_state, _ = b.run_round(r_state, r)
    note("store checkpoint: resumed rounds")
    same = step == 1 and _store_same(s, _store_rows(a), r_state,
                                     _store_rows(b))
    return {"case": STORE_CKPT, "checkpoint_resumed_bitwise": same,
            "save_s": save_s, "restore_s": restore_s,
            "sidecar_bytes": os.path.getsize(os.path.join(
                directory, "ck_store", "run", "store_1.npz")),
            "save_failures": mgr.save_failures}


def _rank(rank, world, directory, device, rounds, which="all"):
    import faulthandler

    import torch
    import torch.distributed as dist

    faulthandler.dump_traceback_later(STALL_S, exit=True)

    def note(what):
        _note(rank, what)

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.parallel.mesh import make_mesh

    if device == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    mesh = make_mesh(world, rank=rank, device=dev,
                     init_method="file://" + os.path.join(directory, "rdv"),
                     timeout=datetime.timedelta(
                         seconds=COLLECTIVE_TIMEOUT_S))
    try:
        note(f"mesh of {world} ({mesh.backend})")
        data = None
        if which != "store":
            data, model, hp = _cohort(dev, mesh)
            note("cohort")

        def algo(impl, frac):
            return SalientGrads(model(), data, hp, loss_type="bce",
                                frac=frac, seed=0, dense_ratio=0.5,
                                itersnip_iterations=1,
                                compute_dtype="bfloat16", agg_impl=impl,
                                device=dev)

        state0 = snip_s = None
        if which not in ("baselines", "store"):  # from their own init
            t0 = _clock(dev, mesh)
            state0 = algo("dense", 1.0).init_state()
            snip_s = _clock(dev, mesh, t0)
            note(f"SNIP {snip_s:.3f} s")
        out = []
        todo = [] if which not in ("all", "plain") else [
            ((impl, frac), lambda impl=impl, frac=frac: algo(impl, frac),
             None) for impl, frac in CASES]
        if which in ("all", "robust"):
            todo += [((c[0], 1.0),
                      lambda c=c: _robust_algo(c, data, model, hp, dev), c)
                     for c in ROBUST_CASES]
        if which in ("all", "baselines"):
            todo += [((c[0], c[2].get("frac", 1.0)),
                      lambda c=c: _baseline_algo(c, data, model, hp, dev),
                      c) for c in BASELINE_CASES]
        for (impl, frac), make, case in todo:
            a = make()
            baseline = case is not None and case in BASELINE_CASES
            start = (a.clone_state(state0) if case is None
                     else a.init_state() if baseline
                     else _robust_state(a, case, state0))
            run = (_case if not baseline or a.supports_fused
                   else _eager_case)
            rec = run(a, start, rounds, dev, mesh,
                      lambda w: note(f"{impl} {frac}: {w}"))
            # NCCL keeps a communicator while a graph holding its
            # collectives lives: drop them before the mesh goes
            a.release_graphs()
            flags = torch.tensor([int(rec["bitwise"])], device=dev)
            dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=mesh.group)
            rec.update(agg_impl=(impl if case is None else None if baseline
                                 else case[2]),
                       case=None if case is None else case[0],
                       frac=frac, ranks=world,
                       backend=mesh.backend, rounds=rounds, snip_s=snip_s,
                       bitwise_every_rank=bool(flags.item()),
                       block=[a._lo, a._hi])
            out.append(rec)
        checks = []
        if which in ("all", "robust"):
            checks.append((dict((c[0], c) for c in ROBUST_CASES)[CKPT_CASE],
                           None))
        if which in ("all", "baselines"):
            checks.append((dict((c[0], c) for c in BASELINE_CASES)
                           [BASELINE_CKPT], _baseline_algo))
        for case, build in checks:
            rec = _ckpt_check(case, data, model, hp, dev, state0, rounds,
                              directory, lambda w: note(w), build)
            flags = torch.tensor([int(rec["checkpoint_resumed_bitwise"])],
                                 device=dev)
            dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=mesh.group)
            rec.update(ranks=world, backend=mesh.backend, rounds=rounds,
                       bitwise_every_rank=bool(flags.item()))
            out.append(rec)
        if which in ("all", "store"):
            data = model = None  # the population takes the host's room
            sdata, smodel, hp = _cohort(
                dev, mesh, STORE_CLIENTS if dev.type == "cuda" else N_CLIENTS,
                host=True)
            note("store population")
            for case in STORE_CASES:
                def make(tag, case=case):
                    return _store_algo(case, sdata, smodel, hp, dev,
                                       os.path.join(directory, tag, case[0]))
                rec = _store_case(make, rounds, dev, mesh,
                                  lambda w, c=case: note(f"{c[0]}: {w}"))
                flags = torch.tensor([int(rec["bitwise"])], device=dev)
                dist.all_reduce(flags, op=dist.ReduceOp.MIN,
                                group=mesh.group)
                rec.update(case=case[0], agg_impl=case[2], frac=STORE_FRAC,
                           clients=len(sdata.n_train), ranks=world,
                           backend=mesh.backend, rounds=rounds,
                           bitwise_every_rank=bool(flags.item()),
                           block=list(mesh.block(len(sdata.n_train))))
                out.append(rec)
            case = dict((c[0], c) for c in STORE_CASES)[STORE_CKPT]
            rec = _store_ckpt_check(
                lambda tag: _store_algo(case, sdata, smodel, hp, dev,
                                        os.path.join(directory, tag)),
                rounds, dev, directory, lambda w: note(w))
            flags = torch.tensor([int(rec["checkpoint_resumed_bitwise"])],
                                 device=dev)
            dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=mesh.group)
            rec.update(ranks=world, backend=mesh.backend, rounds=rounds,
                       bitwise_every_rank=bool(flags.item()))
            out.append(rec)
        if dev.type == "cuda":
            peak = torch.tensor([torch.cuda.max_memory_allocated(dev)],
                                device=dev)
            dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=mesh.group)
            for rec in out:
                rec["peak_mem_bytes_max_rank"] = int(peak.item())
        if rank == 0:
            with open(os.path.join(directory, "out.json"), "w") as f:
                json.dump(out, f)
        mesh.barrier()
        note("done")
    except Exception:
        # the other ranks may wait in a collective: leave at once, without
        # tearing the group down (the parent then stops them)
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    mesh.destroy()
    note("mesh torn down")


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cases", choices=("all", "plain", "robust",
                                        "baselines", "store"),
                    default="all")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"torch_mesh_fused_check: {args.ranks} ranks need as many "
                  f"cards, {torch.cuda.device_count()} present",
                  file=sys.stderr)
            return 2
        from neuroimagedisttraining_torch.ops import kernels

        kernels.build()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank, args=(args.ranks, d, args.device, args.rounds,
                              args.cases),
                 nprocs=args.ranks, join=True)
        with open(os.path.join(d, "out.json")) as f:
            out = json.load(f)
    card = ("cpu" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    for rec in out:
        print(json.dumps(rec), flush=True)
    print(json.dumps({"device": card}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"cases": out, "device": card}, f, indent=1)
    return 0 if all(r["bitwise_every_rank"] for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
