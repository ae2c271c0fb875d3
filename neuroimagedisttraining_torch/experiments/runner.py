"""Experiment runner: flags -> data -> model -> algorithm -> round loop
(counterpart of ``neuroimagedisttraining_tpu/experiments/runner.py``, its
single-process path for the algorithms of :data:`PORTED_ALGOS`).

The run writes what the JAX CLI writes for the same command line: the
per-run log ``<log_dir>/<identity>.log`` and the ``stat_info`` pickle (plus
its ``.json``) at ``<results_dir>/<dataset>/<identity>``, with the same
top-level keys. It runs on ``--device`` (CUDA by default, with no fallback).

``--mesh_devices N`` shards the clients over a mesh of ``N`` ranks, one
process a device (:func:`run_experiment`): fitted to the devices there are
and to the cohort, as the JAX CLI fits it; rank 0 writes the log and the
results. Every algorithm runs there, with ``--fuse_rounds`` (on the
cards each round one CUDA graph holding its NCCL collectives),
``--eval_cache``, ``--eval_clients``, ``--stratified_sampling``, the robust
tier (``--fault_spec``, ``--guard``, ``--defense_type``, ``--robust_agg``),
the state tier (``--checkpoint_dir``, ``--resume``, ``--watchdog``: a step
holds the single-process layout, rank 0 writes it, every rank restores it,
so a lineage resumes at any mesh width) and the client store
(``--client_store host|disk``: each rank's store holds its block of
clients' rows, and its host memory its block's volumes).

With ``--checkpoint_dir`` every round (every block under ``--fuse_rounds``)
is saved in the port's torch format (``utils/checkpoint.py``) under the
JAX CLI's checkpoint identity, and ``--resume`` continues the newest step;
``--client_store host|disk`` streams the per-client rows
(``core/client_store.py``).

``--obs 1`` runs the in-process observability tier (``obs/``) as the JAX CLI
does: the per-round JSONL ``<results_dir>/<dataset>/<identity>.obs.jsonl``
(``--obs_jsonl``), the ``.metrics.json`` beside it and the registry snapshot
in ``stat_info["obs_metrics"]``, the host spans' Chrome trace
(``--trace_dir``), the memory watermark every ``--obs_sample_every`` rounds
(with the client store's gauges), the round numerics (``--obs_numerics``),
the wire-cost model and the aggregation probe (``--obs_comm``), the SLO
engine and its events stream (``--slo_spec``, ``--slo_enforce``), the run
catalog (``--obs_catalog``), the flight recorder (``--flight_recorder``,
``--flight_window``, ``--flight_profile``) and ``--profile_dir`` (one
eager round under ``torch.profiler``, its attribution in
``<identity>.devtrace.json`` with ``--obs_comm``). None of it enters the
identity, and the training is bitwise the same with it off. On a client mesh
every rank records and rank 0 writes.

A flag of a feature the port has not got (the wire, telemetry, the spatial
axis, ...) ends the run
before any work with ``SystemExit`` naming the flag and the ROADMAP item
that ports it (:func:`refuse_unported`). A knob that leaves the JAX
package's results bit-identical (``--client_chunk``, ``--donate_state``,
``--agg_overlap``, ``--agg_kernels``, ...) is accepted, and the run logs once
that it has no effect here.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import logging
import os
import pickle
import random
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import MODELS_2D
from .config import parse_args, run_identity
from .logging_utils import (
    add_run_file_logger,
    configure_console,
    remove_run_file_logger,
)

logger = logging.getLogger(__name__)

#: the algorithms the port runs: every one of the JAX package's
PORTED_ALGOS = ("fedavg", "salientgrads", "dispfl", "subavg", "ditto",
                "local", "dpsgd", "fedfomo", "turboaggregate")

# phased-stem twins of the reference models, with each stem's
# (kernel, pad) decomposition spec (ops/s2d.py)
S2D_TWINS = {"3dcnn": "3dcnn_s2d", "3dresnet": "3dresnet_s2d",
             "small3dcnn": "small3dcnn_s2d"}
S2D_SPECS = {"3dcnn_s2d": (5, 0), "3dresnet_s2d": (3, 3),
             "small3dcnn_s2d": (3, 1)}

#: flag attribute -> ROADMAP item of the feature it drives, refused at any
#: value but its default
_UNPORTED = {
    # 15: multi-process and spatial sharding
    "multihost": 15, "coordinator_address": 15, "num_processes": 15,
    "process_id": 15, "multihost_timeout_s": 15, "multihost_retries": 15,
    "mesh_space": 15,
}
#: attribute -> the values of it the port runs, where that is not just the
#: parser's default (1 depth shard is the default's behavior)
_ALLOWED = {"mesh_space": (0, 1)}
#: the algorithms with a central aggregate the guard, the faults and the
#: robust statistics act on (the JAX CLI's list; the port runs all three)
_CENTRAL = ("fedavg", "salientgrads", "ditto")
#: knobs that leave the JAX package's results bit-identical, and why the
#: port has nothing for them to change
_INERT = {
    "client_chunk": "clients train one after another",
    "donate_state": "a round never writes into its input state",
    "agg_overlap": "each leaf group's collective is issued right after its "
                   "own contraction, on the mesh as off it, and the results "
                   "are bit-identical either way",
    "agg_kernels": "the aggregation always runs the CUDA kernels",
    "fused_kernels": "the optimizer update always runs the CUDA kernel",
    "gpu": "--device names the card",
    "type": "it is dead code in the original too",
}
#: the models sized by the per-sample shape: the first dense layer's width
#: (the 3D models), the input channels too (the 2D image models)
_SIZED_MODELS = ("3dcnn", "3dcnn_deeper", "3dcnn_regression", "3dcnn_s2d",
                 "3dresnet", "3dresnet_s2d") + MODELS_2D


def seed_everything(seed: int) -> None:
    """Python, numpy and torch seeding, and cuDNN's deterministic
    algorithms with its autotuner off, as the original does
    (``main_sailentgrads.py:263-267``): with its default algorithms cuDNN's
    weight gradients sum in another order from run to run, so two runs of
    one command line would differ in the last bits. The cuDNN flags are
    process-wide. The algorithm draws from its own generator, seeded by
    ``--seed`` as well."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _mesh_devices_asked(args: argparse.Namespace) -> int:
    """The ranks the flags ask the client mesh for, before it is fitted to
    the cohort: ``--mesh_devices`` (0: every device) capped at the devices
    there are, which on the card are its GPUs and on ``--device cpu`` the
    gloo processes asked for (0 there means 1)."""
    asked = int(getattr(args, "mesh_devices", 0) or 0)
    if getattr(args, "device", "cuda") == "cpu":
        return max(asked, 1)
    avail = torch.cuda.device_count()
    return min(asked or avail, avail)


def client_mesh_size(args: argparse.Namespace, algo_name: str) -> int:
    """The ranks of the run's client mesh, sized as the JAX CLI's
    ``maybe_shard`` sizes it: the largest count up to the devices asked for
    (:func:`_mesh_devices_asked`) that divides ``--client_num_in_total``; 1
    is no mesh. Every algorithm, and the client store, runs there."""
    from ..parallel.mesh import fit_client_devices

    return fit_client_devices(args.client_num_in_total,
                              _mesh_devices_asked(args))


#: the port's own dataset name: the synthetic stand-in at the ABCD volume,
#: made on ``--device`` (:func:`build_data`)
VOLUME_SYNTH = "synthetic_volume"
#: its volume and shard: the headline workload's (``bench_torch.py``)
VOLUME_SYNTH_SHAPE = (121, 145, 121)
VOLUME_SYNTH_SAMPLES, VOLUME_SYNTH_TEST = 40, 10


def _is_abcd_h5(dataset: str) -> bool:
    """The cohort-file datasets whose loaders take a ``layout`` (the
    synthetic stand-ins always store NDHWC)."""
    return dataset.lower() in ("abcd", "abcd_site", "abcd_rescale")


def _model_key(args: argparse.Namespace) -> str:
    if getattr(args, "layout", "channels") == "s2d":
        return S2D_TWINS.get(args.model, args.model)
    return args.model


@functools.lru_cache(maxsize=None)
def _default(attr: str):
    from .config import build_parser

    return build_parser().get_default(attr)


def refuse_invalid(args: argparse.Namespace, algo_name: str) -> None:
    """The JAX CLI's own refusals of flag combinations that the port has
    the features for, with its messages, in its order (the client store,
    the faults, the guard, the robust statistic, the eval cache, the round
    numerics and the wire model on other algorithms, the aggregation
    wire, the defense, the watchdog in fused blocks, fused
    blocks of an algorithm with data-dependent host work, the SLO engine
    without a session, its enforcement without a spec, the flight
    recorder's ``slo`` trigger without the engine)."""
    store_mode = getattr(args, "client_store", "device")
    if store_mode != "device":
        if algo_name not in _CENTRAL:
            raise SystemExit(
                f"--client_store {store_mode} streams the per-client "
                "state rows (personal stack / topk residual) through "
                "the central round entry; only fedavg/salientgrads/"
                f"ditto thread the streamed slab ({algo_name} does not)")
        if args.frac >= 1.0:
            raise SystemExit(
                f"--client_store {store_mode} exists to keep only the "
                "SAMPLED cohort device-resident; full participation "
                "(--frac 1.0) touches every row every round — run "
                "device-resident instead")
        if getattr(args, "eval_clients", 0):
            raise SystemExit(
                f"--client_store {store_mode} routes personal eval "
                "through the store-backed cache; the sampled-eval "
                "subset (--eval_clients) composes poorly with it — "
                "use one or the other")
        if not getattr(args, "track_personal", 1) and \
                getattr(args, "agg_impl", "dense") != "topk":
            raise SystemExit(
                f"--client_store {store_mode} with --track_personal 0 "
                "has no per-client rows to store: the personal stack "
                "is untracked and no topk error-feedback residual "
                "exists (--agg_impl is not 'topk'). Drop "
                "--client_store (nothing scales with C) or track "
                "something per-client")
        if max(1, getattr(args, "fuse_rounds", 1) or 1) > 1 and \
                getattr(args, "frequency_of_the_test", 0):
            raise SystemExit(
                f"--client_store {store_mode} with --fuse_rounds K "
                "runs block-union slabs; the fused IN-GRAPH eval "
                "(--frequency_of_the_test > 0) needs the full resident "
                "[C] personal stack — pass --frequency_of_the_test 0 "
                "(eval at the end) or --fuse_rounds 1")
    if (getattr(args, "fault_spec", "") or getattr(args, "guard", 0)) \
            and algo_name not in _CENTRAL:
        raise SystemExit(
            "--fault_spec/--guard protect the CENTRAL aggregation round "
            f"(fedavg/salientgrads/ditto); {algo_name} has no central "
            "aggregate to guard")
    if getattr(args, "robust_agg", "none") != "none" and \
            algo_name not in _CENTRAL:
        raise SystemExit(
            f"--robust_agg {args.robust_agg} replaces the CENTRAL "
            f"weighted mean (fedavg/salientgrads/ditto); {algo_name} "
            "has no central aggregate to robustify")
    if getattr(args, "eval_cache", 0):
        if algo_name not in ("fedavg", "salientgrads"):
            raise SystemExit(
                "--eval_cache caches the per-client personal-eval "
                "terms in algorithm state; only fedavg/salientgrads "
                f"carry the personal stack it indexes ({algo_name} "
                "does not)")
        if not getattr(args, "track_personal", 1):
            raise SystemExit(
                "--eval_cache needs the personal stack; it cannot "
                "combine with --track_personal 0")
        if getattr(args, "eval_clients", 0):
            raise SystemExit(
                "--eval_cache indexes the full cohort; the sampled-"
                "eval subset (--eval_clients) composes poorly with it "
                "— use one or the other")
    if getattr(args, "obs_numerics", 0) and \
            algo_name not in ("fedavg", "salientgrads"):
        raise SystemExit(
            "--obs_numerics threads the in-jit numerics telemetry "
            "through the central-aggregate round outputs "
            f"(fedavg/salientgrads); {algo_name} does not thread them")
    if getattr(args, "obs_comm", 0):
        if not getattr(args, "obs", 0):
            raise SystemExit(
                "--obs_comm rides the obs session (per-round JSONL + "
                "registry); pass --obs 1")
        if algo_name not in _CENTRAL:
            raise SystemExit(
                "--obs_comm models the CENTRAL aggregation wire "
                f"(fedavg/salientgrads/ditto); {algo_name} has no "
                "central aggregate to price")
    agg_impl = getattr(args, "agg_impl", "dense")
    if agg_impl != "dense" and algo_name not in _CENTRAL:
        raise SystemExit(
            f"--agg_impl {agg_impl} routes the CENTRAL weighted mean "
            f"(fedavg/salientgrads/ditto); {algo_name} has no central "
            "aggregate")
    if agg_impl == "sparse" and algo_name != "salientgrads":
        raise SystemExit(
            "--agg_impl sparse needs a static sparsity mask; only "
            "salientgrads (fixed SNIP mask) supports it")
    if agg_impl == "topk" and algo_name not in ("fedavg", "salientgrads"):
        raise SystemExit(
            "--agg_impl topk carries an error-feedback residual in "
            "algorithm state; only fedavg/salientgrads thread it "
            f"({algo_name} does not)")
    if agg_impl == "hier" and \
            getattr(args, "agg_hier_wire", "bf16") == "sparse" and \
            algo_name != "salientgrads":
        raise SystemExit(
            "--agg_hier_wire sparse compresses the cross-slice hop to a "
            "static mask's live coordinates; only salientgrads (fixed "
            "SNIP mask) supports it")
    if getattr(args, "defense_type", "none") != "none" and \
            algo_name not in ("fedavg", "salientgrads"):
        raise SystemExit(
            f"--defense_type {args.defense_type} guards the global "
            "aggregation of fedavg/salientgrads; "
            f"{algo_name} has no central aggregate to defend")
    if getattr(args, "watchdog", 0) and \
            max(1, getattr(args, "fuse_rounds", 1) or 1) > 1:
        raise SystemExit(
            "--watchdog rolls rounds back and retries them — "
            "per-round host control that --fuse_rounds removes; "
            "use --fuse_rounds 1 (or --watchdog 0)")
    if max(1, getattr(args, "fuse_rounds", 1) or 1) > 1:
        from ..algorithms import ALGORITHMS

        if not ALGORITHMS[algo_name].supports_fused:
            raise SystemExit(
                f"--fuse_rounds: {algo_name} has data-dependent "
                "per-round host work (FedFomo's accumulated-weight-"
                "biased neighbor draw / TurboAggregate's interactive "
                "share protocol); supported: fedavg, salientgrads, "
                "ditto, local, dpsgd, dispfl(--static)")
    # the serving and federation roles arm the SLO engine on their own
    # streams, without the in-process obs session (as the JAX CLI does)
    if getattr(args, "slo_spec", "") and not getattr(args, "obs", 0) \
            and not getattr(args, "serve_role", "") \
            and not getattr(args, "fed_role", ""):
        raise SystemExit(
            "--slo_spec rides the obs session (per-round record "
            "hook, events stream, registry); pass --obs 1")
    if getattr(args, "slo_enforce", 0) and \
            not getattr(args, "slo_spec", ""):
        raise SystemExit(
            "--slo_enforce needs objectives to enforce; pass "
            "--slo_spec (inline DSL or a spec file)")
    if getattr(args, "flight_recorder", ""):
        from ..obs.recorder import parse_triggers

        if parse_triggers(args.flight_recorder)["slo"] and \
                not getattr(args, "slo_spec", ""):
            raise SystemExit(
                "--flight_recorder slo captures SLO breach/burn/"
                "FAILING events; pass --slo_spec to arm the "
                "engine that emits them")


def refuse_unported(args: argparse.Namespace, algo_name: str) -> None:
    """``SystemExit`` for a combination the JAX CLI refuses too
    (:func:`refuse_invalid`), else naming the first flag of a feature the
    port has not got, set to anything but its default, and the ROADMAP item
    that ports it."""
    refuse_invalid(args, algo_name)
    if algo_name not in PORTED_ALGOS:
        raise SystemExit(f"--algo {algo_name}: the port runs "
                         f"{', '.join(PORTED_ALGOS)}")

    for attr, item in _UNPORTED.items():
        if not hasattr(args, attr):
            continue
        v = getattr(args, attr)
        ok = _ALLOWED.get(attr, (_default(attr),))
        if v not in ok:
            raise SystemExit(
                f"--{attr} {v!r}: not ported to PyTorch yet (ROADMAP item "
                f"{item}); drop the flag, or run the JAX package's CLI")
    client_mesh_size(args, algo_name)


def refuse_fused(algo, algo_name: str) -> None:
    """``--fuse_rounds`` > 1 refused for the built algorithm, as the JAX
    CLI refuses it: evolving masks (dynamic DisPFL, SubAvg), whose cost is
    priced each round. (An algorithm without a fused loop is refused before
    any work, :func:`refuse_invalid`.)"""
    if algo.masks_evolve:
        raise SystemExit(
            f"--fuse_rounds: {algo_name}'s per-round cost "
            "accounting snapshots evolving masks; use "
            "--fuse_rounds 1")


def _dataset_augmentable(dataset: str) -> bool:
    """Whether this dataset's loader declares the reference's RandomCrop and
    flip train transform (the lineage guard needs it before the data
    loads)."""
    from ..data import dataset_is_augmentable

    return dataset_is_augmentable(dataset)


def _check_augment_consistency(args, algo) -> None:
    """After the build: the lineage guard's guess of the augmentation
    (``--augment`` on an augmentable dataset name) against what the built
    algorithm has (its loader's ``aug_pad_value``, wired by
    ``augment="auto"``), so checkpoint metadata never contradicts the
    guard."""
    expected = bool(getattr(args, "augment", 1)) \
        and _dataset_augmentable(args.dataset)
    actual = getattr(algo, "augment_fn", None) is not None
    if expected != actual and args.checkpoint_dir:
        raise SystemExit(
            f"augmentability mapping drift: the lineage guard assumed "
            f"augment={int(expected)} for dataset {args.dataset!r} but the "
            f"built algorithm has augment={int(actual)} — update "
            "data.AUGMENTABLE_DATASETS to match the loader")


def _resolve_lineage_semantics(args, meta: dict, last: int,
                               directory: str,
                               algo_name: str = "") -> None:
    """This run's training semantics (the batching mode, the
    augmentation, SalientGrads' personal stack) reconciled with an
    existing checkpoint lineage before the algorithm is built, as the JAX
    CLI does: on a resume a defaulted knob takes the lineage's value (with
    a warning); an explicit mismatch, or a fresh run that would overwrite
    the lineage round by round, is refused. A sidecar value of None is a
    lineage older than the knob's entry, which pins its semantics."""
    def _adopt_or_refuse(knob, lineage_val, here_val, explicit,
                         provenance, fix):
        if lineage_val == here_val:
            return
        if args.resume and not explicit:
            logger.warning(
                "lineage has %s=%s (%s); continuing with those semantics "
                "instead of the current default", knob, lineage_val,
                provenance)
            setattr(args, knob, lineage_val)
            return
        action = ("resuming it" if args.resume
                  else "a fresh run overwriting it round by round")
        raise SystemExit(
            f"checkpoint dir {directory} holds a {knob}={lineage_val} "
            f"lineage up to round {last}; {action} with {knob}={here_val} "
            f"would mix training semantics. {fix}")

    lineage_b = meta.get("batching") or "replacement"  # None = pre-round-3
    _adopt_or_refuse(
        "batching", lineage_b, getattr(args, "batching", "epoch"),
        getattr(args, "batching_explicit", True),
        "recorded" if meta.get("batching") else
        "pre-round-3 sidecar-less, the only semantics it can have",
        f"Pass --batching {lineage_b} to continue it, or start a fresh "
        "lineage (--tag or a different --checkpoint_dir).")

    pa = meta.get("augment")
    lineage_a = int(bool(pa))  # None = pre-round-4 lineage: un-augmented
    here_a = int(bool(getattr(args, "augment", 1))
                 and _dataset_augmentable(args.dataset))
    _adopt_or_refuse(
        "augment", lineage_a, here_a,
        getattr(args, "augment_explicit", True),
        "recorded" if pa is not None else
        "pre-round-4 sidecar-less, the only semantics it can have",
        f"Pass --augment {lineage_a} to continue it, or start a fresh "
        "lineage (--tag or a different --checkpoint_dir).")

    if algo_name == "salientgrads":
        tp = meta.get("track_personal")
        _adopt_or_refuse(
            "track_personal", int(bool(tp)),  # None = pre-r5: no stack
            int(bool(getattr(args, "track_personal", 1))),
            getattr(args, "track_personal_explicit", True),
            "recorded" if tp is not None else
            "pre-round-5 sidecar-less: its states have no personal stack",
            "Resume WITHOUT --track_personal to continue it under the "
            "lineage's own protocol, or start a fresh lineage (--tag or "
            "a different --checkpoint_dir) for the other mode.")


def _log_inert(args: argparse.Namespace) -> None:
    for attr, why in _INERT.items():
        v = getattr(args, attr, None)
        if v is not None and v != _default(attr):
            logger.info("--%s %s has no effect in the PyTorch port: %s",
                        attr, v, why)


def _volume_synth(args: argparse.Namespace):
    """``--dataset synthetic_volume``, the port's own: the JAX CLI's
    synthetic stand-ins are 8^3 volumes, and its full-size runs read an
    ABCD cohort file (``h5py``). This one is a full-width cohort made on
    ``--device`` from the split seed (``data.device_synthetic_federated``):
    ``--client_num_in_total`` clients of 40 training and 10 test
    121x145x121 volumes in bf16 (the headline workload's shard), stored as
    the model reads them: phase-decomposed for an s2d-stem model under
    ``--layout s2d``, else with a channel axis. Every process building it
    from the same flags on the same kind of device holds the same
    cohort."""
    from ..data import device_synthetic_federated
    from ..ops.s2d import phased_sample_shape

    if getattr(args, "layout", "channels") == "s2d":
        shape = phased_sample_shape(VOLUME_SYNTH_SHAPE,
                                    *S2D_SPECS[_model_key(args)])
    else:  # build_algorithm refuses every other layout but channels
        shape = VOLUME_SYNTH_SHAPE + (1,)
    dev = torch.device(getattr(args, "device", "cuda"))
    return device_synthetic_federated(
        args.client_num_in_total, VOLUME_SYNTH_SAMPLES, shape,
        torch.Generator(device=dev).manual_seed(42),
        test_per_client=VOLUME_SYNTH_TEST)


def build_data(args: argparse.Namespace):
    from ..data import load_federated_data

    if args.dataset.lower() == VOLUME_SYNTH:
        return _volume_synth(args)
    kwargs: Dict[str, Any] = {}
    if args.dataset.lower() in ("synthetic", "abcd_synth"):
        # CI-scale default; real ABCD shapes come from the .h5 itself
        kwargs["sample_shape"] = (8, 8, 8, 1)
        kwargs["samples_per_client"] = max(args.batch_size, 16)
    elif _is_abcd_h5(args.dataset):
        kwargs["layout"] = getattr(args, "layout", "channels")
        if kwargs["layout"] == "s2d":
            # decompose for the stem the resolved model actually has
            kwargs["s2d_spec"] = S2D_SPECS.get(_model_key(args))
    return load_federated_data(
        args.dataset,
        data_dir=args.data_dir,
        client_number=args.client_num_in_total,
        partition_method=args.partition_method,
        partition_alpha=args.partition_alpha,
        val_fraction=getattr(args, "val_fraction", 0.0),
        seed=42,  # the original's fixed split seed
        **kwargs,
    )


def infer_loss_type(args: argparse.Namespace, class_num: int) -> str:
    """The ABCD/3D path uses BCE-with-logits, the image path CE."""
    if args.model.startswith("3d") and class_num == 2:
        return "bce"
    if args.dataset.lower().startswith(("abcd", "synthetic")) and \
            class_num == 2:
        return "bce"
    return "ce"


def build_algorithm(args: argparse.Namespace, algo_name: str, mesh=None):
    """The algorithm the flags describe, on ``--device``; returns
    ``(algo, data)``, the data as the algorithm holds it (on the device,
    moved there once after the ``--data_dtype`` cast). On a client ``mesh``
    every rank builds the whole cohort and keeps its block
    (``parallel.mesh.shard_federated``)."""
    from ..algorithms import ALGORITHMS
    from ..core.state import HyperParams
    from ..models import create_model
    from ..robust import RobustAggregator

    refuse_unported(args, algo_name)
    # the layout/dataset/model coupling, checked before any data IO
    layout = getattr(args, "layout", "channels")
    model_key = args.model
    if layout != "channels" and not (_is_abcd_h5(args.dataset) or (
            layout == "s2d" and args.dataset.lower() == VOLUME_SYNTH)):
        raise SystemExit(
            f"--layout {layout} requires an ABCD cohort dataset "
            "(abcd | abcd_site | abcd_rescale); other loaders store NDHWC")
    if layout == "s2d":
        model_key = S2D_TWINS.get(model_key, model_key)
        if model_key not in S2D_SPECS:
            raise SystemExit(
                f"--layout s2d feeds phase-decomposed input that only the "
                f"s2d-stem models consume; --model {model_key} would "
                "misread the phase axis. Use --model "
                f"{'/'.join(S2D_TWINS)} (auto-mapped) or drop --layout s2d")
    elif model_key in S2D_SPECS:
        raise SystemExit(
            f"--model {model_key} consumes phase-decomposed input; pair it "
            f"with --layout s2d (got --layout {layout})")
    if getattr(args, "client_optimizer", "sgd") != "sgd":
        raise SystemExit(
            f"--client_optimizer {args.client_optimizer!r}: only 'sgd' is "
            "implemented (the original crashes on anything else too)")
    data = build_data(args)
    ddt = getattr(args, "data_dtype", "")
    if ddt:
        dt = getattr(torch, ddt)
        data = dataclasses.replace(
            data, x_train=data.x_train.to(dt), x_test=data.x_test.to(dt),
            x_val=None if data.x_val is None else data.x_val.to(dt))
    if mesh is not None:
        from ..parallel.mesh import shard_federated

        if data.num_clients % mesh.size:
            raise SystemExit(
                f"--mesh_devices: the cohort has {data.num_clients} clients, "
                f"which do not divide over the {mesh.size}-rank mesh sized "
                f"by --client_num_in_total {args.client_num_in_total}")
        # a client store keeps the rank's block on the host: each round
        # moves its cohort to the card
        data = shard_federated(data, mesh, host=getattr(
            args, "client_store", "device") != "device")
    loss_type = infer_loss_type(args, data.class_num)
    num_outputs = 1 if loss_type == "bce" else data.class_num
    # --layout flat stores the cohort channel-less; the apply injects it
    channel_inject = layout == "flat" and _is_abcd_h5(args.dataset)
    sample_shape = tuple(data.sample_shape) + ((1,) if channel_inject
                                               else ())
    model_kw = ({"sample_shape": sample_shape}
                if model_key in _SIZED_MODELS else {})
    model = create_model(model_key, num_classes=num_outputs, **model_kw)

    counts = np.asarray(data.n_train)
    batching = getattr(args, "batching", "epoch")
    if batching == "epoch":
        # each client iterates ceil(n_i/batch) shuffled batches per epoch;
        # the step count is the largest client's, and the smaller clients'
        # extra steps are masked no-ops (core/trainer.py)
        steps_per_epoch = max(1, -(-int(np.max(counts)) // args.batch_size))
    else:  # with-replacement draws: the mean shard's step count
        steps_per_epoch = max(1, int(np.mean(counts)) // args.batch_size)
    hp = HyperParams(
        lr=args.lr, lr_decay=args.lr_decay, momentum=args.momentum,
        weight_decay=args.wd, grad_clip=args.grad_clip,
        local_epochs=args.epochs, steps_per_epoch=steps_per_epoch,
        batch_size=args.batch_size, batching=batching,
    )
    common = dict(
        loss_type=loss_type, frac=args.frac, seed=args.seed,
        compute_dtype=getattr(args, "compute_dtype", "") or None,
        agg_impl=getattr(args, "agg_impl", "dense"),
        agg_bucket_size=getattr(args, "agg_bucket_size", 0),
        agg_topk_density=getattr(args, "agg_topk_density", 0.1),
        agg_topk_sample=getattr(args, "agg_topk_sample", 0),
        agg_hier_wire=getattr(args, "agg_hier_wire", "bf16"),
        agg_hier_inner=getattr(args, "agg_hier_inner", 0),
        eval_clients=getattr(args, "eval_clients", 0),
        channel_inject=channel_inject,
        remat_local=bool(getattr(args, "remat", 0)),
        fault_spec=getattr(args, "fault_spec", ""),
        # None: the algorithm resolves it (on iff faults are injected)
        guard=(bool(args.guard)
               if getattr(args, "guard", None) is not None else None),
        robust_agg=getattr(args, "robust_agg", "none"),
        robust_trim=getattr(args, "robust_trim", 0.2),
        robust_krum_f=getattr(args, "robust_krum_f", 0),
        # norm_krum's clip bound is --norm_bound
        robust_norm_bound=getattr(args, "norm_bound", 5.0),
        # the population client store: bitwise the resident run, so it
        # never enters the run identity
        client_store=getattr(args, "client_store", "device"),
        store_hot_clients=getattr(args, "store_hot_clients", 64),
        # "auto" applies only to datasets whose loader set aug_pad_value
        # (cifar10/100, tiny): the original's always-on train transform
        augment="auto" if getattr(args, "augment", 1) else False,
        # the round numerics (obs/numerics.py): a readout, never identity
        obs_numerics=bool(getattr(args, "obs_numerics", 0)),
        device=(mesh.device if mesh is not None
                else getattr(args, "device", "cuda")),
    )
    defense = None
    if getattr(args, "defense_type", "none") != "none":
        defense = RobustAggregator(
            defense_type=args.defense_type,
            norm_bound=args.norm_bound, stddev=args.stddev)
    central = dict(defense=defense,
                   track_personal=bool(getattr(args, "track_personal", 1)),
                   eval_cache=bool(getattr(args, "eval_cache", 0)))
    extra: Dict[str, Any] = {}
    if algo_name == "salientgrads":
        extra = dict(
            dense_ratio=args.dense_ratio,
            itersnip_iterations=args.itersnip_iteration,
            snip_mask=bool(getattr(args, "snip_mask", 1)),
            stratified_sampling=bool(getattr(args, "stratified_sampling",
                                             0)),
            stratified_mode=getattr(args, "stratified_mode", "exact"),
            **central)
    elif algo_name == "fedavg":
        extra = central
    elif algo_name == "dispfl":
        extra = dict(dense_ratio=args.dense_ratio,
                     anneal_factor=args.anneal_factor,
                     neighbor_mode=args.cs, active=args.active,
                     static_masks=bool(args.static),
                     total_rounds=args.comm_round,
                     erk_power_scale=args.erk_power_scale,
                     sparsity_distribution=(
                         "uniform" if getattr(args, "uniform", False)
                         else "erk"),
                     different_initial=getattr(args, "different_initial",
                                               False),
                     diff_spa=getattr(args, "diff_spa", False),
                     dis_gradient_check=getattr(args, "dis_gradient_check",
                                                False),
                     # --frequency_of_the_test 0 drops every eval, the
                     # per-round local tests too
                     record_local_tests=bool(
                         getattr(args, "frequency_of_the_test", 1)))
    elif algo_name == "dpsgd":
        extra = dict(neighbor_mode=args.cs)
    elif algo_name == "subavg":
        extra = dict(each_prune_ratio=args.each_prune_ratio,
                     dist_thresh=args.dist_thresh,
                     acc_thresh=args.acc_thresh,
                     dense_ratio=args.dense_ratio)
    elif algo_name == "ditto":
        personal_hp = None
        if getattr(args, "local_epochs", 0):
            personal_hp = dataclasses.replace(hp,
                                              local_epochs=args.local_epochs)
        extra = dict(lamda=args.lamda, personal_hp=personal_hp)
    elif algo_name == "turboaggregate":
        extra = dict(n_groups=args.n_groups)
    algo = ALGORITHMS[algo_name](model, data, hp, **common, **extra)
    return algo, algo.data


def save_stat_info(args: argparse.Namespace, identity: str,
                   history, final_eval, extras=None, cost=None,
                   avg_inference_flops: float = 0.0,
                   fault_counters=None, obs_metrics=None) -> Optional[str]:
    """End-of-run artifact: the ``stat_info`` pickle, and its JSON sidecar,
    under ``<results_dir>/<dataset>/<identity>``; ``extras`` (DisPFL's
    final masks and mask distances) go into the pickle only;
    ``obs_metrics`` is the obs session's registry snapshot."""
    if not args.results_dir:
        return None
    out_dir = os.path.join(args.results_dir, args.dataset)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, identity)
    stat_info = {
        "config": vars(args),
        "history": history,
        "final_eval": {k: float(v) for k, v in final_eval.items()
                       if np.ndim(v) == 0},
        "global_test_acc": [h.get("global_acc") for h in history
                            if "global_acc" in h],
        "person_test_acc": [h.get("personal_acc") for h in history
                            if "personal_acc" in h],
        # DisPFL's local-test series around local training
        "old_mask_test_acc": [h["old_mask_test_acc"] for h in history
                              if "old_mask_test_acc" in h],
        "new_mask_test_acc": [h["new_mask_test_acc"] for h in history
                              if "new_mask_test_acc" in h],
        "sum_training_flops": getattr(cost, "sum_training_flops", 0.0),
        "sum_comm_params": getattr(cost, "sum_comm_params", 0),
        "avg_inference_flops": avg_inference_flops,
    }
    if fault_counters is not None:
        stat_info["fault_recovery"] = dict(fault_counters)
    if obs_metrics is not None:
        stat_info["obs_metrics"] = obs_metrics
    json_keys = list(stat_info)
    stat_info.update(extras or {})
    with open(path, "wb") as f:
        pickle.dump(stat_info, f)
    with open(path + ".json", "w") as f:
        json.dump({k: stat_info[k] for k in json_keys}, f, default=str,
                  indent=1)
    return path


def _ckpt_metadata(args, algo, cost):
    """The checkpoint's metadata sidecar, shared by the per-round and the
    block-boundary saves (a key the lineage reconciliation or the cost
    restore reads must be in both, or fused and unfused lineages could
    not resume each other)."""
    return {"cost": cost.snapshot_totals(),
            "batching": getattr(args, "batching", "epoch"),
            "augment": getattr(algo, "augment_fn", None) is not None,
            "track_personal": bool(getattr(args, "track_personal", 1)),
            # diagnostic only: the wire, the cache and the residency that
            # wrote the lineage's states
            "agg_impl": algo.agg_impl,
            "eval_cache": bool(getattr(algo, "eval_cache", False)),
            "client_store": getattr(algo, "client_store", "device")}


def _cost_round_record(algo, cost, samples_per_client, state):
    """One round's cost record (shared by the unfused and fused loops): with
    fixed masks round 0's count repeats (no device-to-host pull after it);
    evolving masks (DisPFL, SubAvg) are priced anew each round, on the
    representative client of :meth:`FedAlgorithm.cost_snapshot`."""
    if cost.per_round and not algo.masks_evolve:
        return cost.record_repeat()
    return cost.record_round(
        *algo.cost_snapshot(state),
        n_clients=algo.cost_trained_clients_per_round(),
        samples_per_client=samples_per_client)


def _run_fused_rounds(algo, algo_name, state, start_round, total, block,
                      ev_every, cost, samples_per_client, history, counters,
                      ckpt_mgr=None, args=None, obs_session=None,
                      obs_fault_counts=None, flight=None):
    """The runner's fused round loop (``--fuse_rounds K``): the shared block
    loop (``FedAlgorithm._fused_block_loop``) plus the cost accounting.
    The masks are static, so one snapshot prices every round: that of the
    state after the run's first round, as in the unfused loop. (A later
    state can differ in its nonzero pattern: a conv bias ahead of a
    GroupNorm has a gradient of pure round-off, which can be exactly zero
    in the first round and not in the second.)

    Checkpoints are saved at block boundaries: the same (round, state)
    pairs the unfused loop saves, so fused and unfused lineages resume each
    other, a resume starting at the last saved boundary. With an obs
    session the records, already on the host at the block's flush, go to
    the flight recorder and the session, and carry ``round_time_s`` (the
    block's time split evenly)."""
    first = {}

    def on_record(r, rec, state_out):
        crec = _cost_round_record(algo, cost, samples_per_client,
                                  first.pop("state", state_out))
        rec["sum_training_flops"] = crec["sum_training_flops"]
        rec["sum_comm_params"] = crec["sum_comm_params"]
        counters.update(rec)
        history.append(rec)
        if flight is not None:
            # before record_round: the SLO trigger's bundles must find
            # this round in the window
            flight.observe_record(rec)
        if obs_session is not None:
            obs_session.record_round(
                rec, extra=(obs_fault_counts(r)
                            if obs_fault_counts is not None and r >= 0
                            else None))
        logger.info("%s round %d: %s", algo_name, r, rec)

    def on_block(end_round, state_out):
        if ckpt_mgr is not None:
            # a store-backed lineage's staged rows ride the same boundary
            # as its store_<step>.npz sidecar
            ckpt_mgr.save(end_round, state_out,
                          metadata=_ckpt_metadata(args, algo, cost),
                          store=algo._store)

    def on_first_round(state_out):
        first["state"] = state_out

    return algo._fused_block_loop(
        state, start_round, total, block, ev_every, on_record,
        on_block=on_block, timed=obs_session is not None,
        # a resumed run's counters continue from the lineage's totals
        on_first_round=None if cost.per_round else on_first_round)


def store_stats_by_rank(store, mesh=None) -> List[Dict[str, float]]:
    """The client store's gauges under the JAX store's names
    (``mem_host_cache_bytes``, ``mem_store_*``, ``store_gather_ms``), one
    dict a rank in rank order: on a client mesh every rank takes part (one
    ``all_gather``), off it the one store's."""
    stats = store.stats()
    if mesh is None:
        return [stats]
    keys = sorted(stats)
    rows = mesh.all_gather(torch.tensor(
        [stats[k] for k in keys], dtype=torch.float64, device=mesh.device))
    return [dict(zip(keys, (float(v) for v in r))) for r in rows.tolist()]


def _mesh_rank(rank: int, args: argparse.Namespace, algo_name: str,
               n: int, directory: str, threads: int) -> None:
    """One rank of a client-mesh run (:func:`run_experiment`): joins the
    group over a ``file://`` rendezvous in ``directory``, runs, and on rank
    0 leaves the result there; the group is torn down whatever happens. A
    CPU rank computes on ``threads`` threads (its share of the parent's)."""
    from ..parallel.mesh import make_mesh

    device = "cpu"
    if getattr(args, "device", "cuda") != "cpu":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    else:
        torch.set_num_threads(threads)
    mesh = make_mesh(n, init_method="file://" + os.path.join(
        directory, "rendezvous"), rank=rank, device=device)
    try:
        out = run_experiment(args, algo_name, mesh=mesh)
        if rank == 0:
            out["state"] = None  # each rank holds its block of the state
            with open(os.path.join(directory, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
        mesh.barrier()
    finally:
        mesh.destroy()


def _run_on_mesh(args: argparse.Namespace, algo_name: str,
                 n: int) -> Dict[str, Any]:
    """Spawn the ``n`` ranks of a client-mesh run (``spawn``, never
    ``fork``) and return rank 0's result, whose ``state`` is None: the
    per-client rows live in the ranks. On the card the kernels are built
    here first, so the ranks only load them. A rank that raises fails the
    run."""
    import torch.multiprocessing as mp

    if getattr(args, "device", "cuda") != "cpu":
        from ..ops import kernels

        kernels.build()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_mesh_rank, args=(args, algo_name, n, d,
                                   max(1, torch.get_num_threads() // n)),
                 nprocs=n, join=True)
        with open(os.path.join(d, "result.pkl"), "rb") as f:
            return pickle.load(f)


def _obs_session(args: argparse.Namespace, algo_name: str, identity: str):
    """The run's ``obs.export.ObsSession``: the JSONL path
    (``--obs_jsonl``, else ``<results_dir>/<dataset>/<identity>.obs.jsonl``),
    the trace dir, the sampling cadence, TensorBoard, the wire metrics,
    the SLO engine and its events stream beside the JSONL, and the catalog
    entry, as the JAX CLI builds them."""
    from ..obs.export import ObsSession

    jsonl = getattr(args, "obs_jsonl", "") or os.path.join(
        args.results_dir or ".", args.dataset, identity + ".obs.jsonl")
    slo_engine = None
    if getattr(args, "slo_spec", ""):
        from ..obs.slo import SloEngine, load_slo_spec

        slo_engine = SloEngine(load_slo_spec(args.slo_spec))
    cat_path, cat_info = "", None
    if getattr(args, "obs_catalog", 1) and args.results_dir:
        from ..obs import catalog as obs_catalog
        from ..obs.regress import git_sha

        cat_path = obs_catalog.catalog_path(args.results_dir)
        cat_info = {
            "config": vars(args),
            "checkpoint_identity": run_identity(args, algo_name,
                                                for_checkpoint=True),
            "git_sha": git_sha(),
            "stat_json": os.path.join(args.results_dir, args.dataset,
                                      identity + ".json"),
        }
    session = ObsSession(
        jsonl_path=jsonl, trace_dir=getattr(args, "trace_dir", ""),
        identity=identity,
        sample_every=getattr(args, "obs_sample_every", 1),
        tb_dir=getattr(args, "obs_tb_dir", ""),
        comm=bool(getattr(args, "obs_comm", 0)), slo=slo_engine,
        # beside the round stream, from the JSONL path (an explicit
        # --obs_jsonl keeps the two streams together)
        events_path=((jsonl[:-len(".obs.jsonl")]
                      if jsonl.endswith(".obs.jsonl") else jsonl)
                     + ".events.jsonl" if slo_engine is not None else ""),
        catalog_path=cat_path, catalog_info=cat_info)
    logger.info("obs: per-round JSONL -> %s", jsonl)
    if slo_engine is not None:
        logger.info("obs slo: %d objective(s) armed, events -> %s",
                    len(slo_engine.objectives), session.events_path)
    return session


def _obs_comm(algo, state, obs_session):
    """``--obs_comm``: the wire-cost model of the run's aggregate and one
    probe of it (``obs.comm``), their ``comm_*`` metrics joined onto every
    JSONL line; returns the model."""
    from ..obs import comm as obs_comm

    wire_model = obs_comm.WireCostModel.from_algorithm(algo, state)
    metrics = wire_model.round_metrics()
    probe = obs_comm.probe_aggregate(algo, state=state,
                                     registry=obs_session.registry)
    metrics["comm_agg_ms"] = probe["agg_ms"]
    for ck, mk in (("flops", "comm_agg_flops"),
                   ("bytes_accessed", "comm_agg_bytes_accessed")):
        if isinstance(probe.get(ck), (int, float)):
            metrics[mk] = float(probe[ck])
    obs_session.set_comm_metrics(metrics)
    logger.info("obs comm: %s wire %.2f MB/agg (density %.3f), probed agg "
                "%.2f ms", algo.agg_impl, metrics["comm_bytes_wire"] / 1e6,
                metrics["comm_density"], metrics["comm_agg_ms"])
    return wire_model


def _obs_profile(algo, state, args, identity, obs_session, wire_model,
                 lead: bool) -> None:
    """``--profile_dir``: one eager round under ``torch.profiler``
    (``utils.profiling.trace_one_round``, on a copy of the state; on a
    client mesh every rank runs it and rank 0 writes it); with the wire
    model, its device-time attribution (``obs.devtrace``) as the
    ``<identity>.devtrace.json`` sidecar beside the JSONL. The attribution
    is best-effort: a trace it cannot read never ends the run."""
    from ..utils.profiling import trace_one_round

    trace_one_round(algo, state, args.profile_dir, export=lead)
    if wire_model is None or not lead:
        return
    from ..obs import devtrace as obs_devtrace

    try:
        summary = obs_devtrace.analyze_profile_dir(
            args.profile_dir,
            modeled_bytes=wire_model.bytes_for(algo.agg_impl))
        if summary.get("present") and obs_session.exports and \
                obs_session.jsonl_path:
            path = obs_devtrace.write_summary(summary, os.path.join(
                os.path.dirname(obs_session.jsonl_path) or ".",
                identity + ".devtrace.json"))
            obs_session.registry.gauge("comm_devtrace_agg_share").set(
                summary["totals"]["agg_share"])
            logger.info("obs comm: devtrace %.1f%% collective -> %s",
                        100 * summary["totals"]["agg_share"], path)
    except Exception:
        logger.warning("devtrace attribution failed", exc_info=True)


def _slo_verdict(args, identity: str, obs_session) -> None:
    """The SLO engine's end state logged; ``--slo_enforce`` turns a FAILING
    run into ``SystemExit`` (every artifact is on disk already)."""
    from ..obs import slo as slo_mod

    health = obs_session.slo.health
    if health != slo_mod.OK:
        logger.warning("obs slo: run ended %s (breached: %s)",
                       health.upper(),
                       ", ".join(obs_session.slo.breached)
                       or "none currently")
    if getattr(args, "slo_enforce", 0) and health == slo_mod.FAILING:
        raise SystemExit(
            f"--slo_enforce: run {identity} ended FAILING (error budget "
            f"exhausted; see {obs_session.events_path or 'the events stream'}"
            " and metrics.json slo_* gauges)")


def run_experiment(args: argparse.Namespace,
                   algo_name: Optional[str] = None,
                   mesh=None) -> Dict[str, Any]:
    """The run the flags describe; returns its identity, history, final
    eval, ``stat_info`` path, final state, ``client_mesh_devices`` and, with
    a client store, ``store_stats`` (:func:`store_stats_by_rank`). With
    a client mesh of more than one rank (:func:`client_mesh_size`) the run
    is spawned, one process a rank (``mesh`` is the rank's mesh inside
    one): the eager loop or, with ``--fuse_rounds``, the fused one
    (:func:`_run_fused_rounds`), the same on every rank, with the
    checkpoints (every rank saves and restores together, rank 0 writes) and
    the watchdog (rank 0's verdict on every rank) and the client store
    (each rank's holds its block's rows)."""
    from .. import resolve_device
    from ..convert import to_reference_layout
    from ..robust import recovery
    from ..robust.recovery import RoundWatchdog
    from ..utils.checkpoint import CheckpointManager
    from ..utils.flops import CostTracker, avg_inference_flops
    from ..obs import trace as obs_trace
    from ..utils.records import DeferredRecords, RunCounters, to_float

    algo_name = algo_name or getattr(args, "algo", "fedavg")
    refuse_unported(args, algo_name)
    try:
        resolve_device(getattr(args, "device", "cuda"))
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}")
    if getattr(args, "serve_role", ""):
        # the serving plane (serve/): the checkpoint-streaming inference
        # worker / publisher pair, its own lifecycle, obs session and
        # refusals; dispatched before the federation (the two roles refuse
        # each other), as the JAX CLI does
        from ..serve.runtime import run_serving

        configure_console()
        seed_everything(args.seed)
        return run_serving(args, algo_name)
    if getattr(args, "fed_role", ""):
        # the distributed federation (fed/): its own round loop, obs
        # streams and lifecycle, dispatched before the mesh, checkpoint
        # and obs setup, as the JAX CLI does; it refuses the in-process
        # features it cannot honor
        from ..fed.runtime import run_federated

        configure_console()
        seed_everything(args.seed)
        return run_federated(args, algo_name)
    n_mesh = mesh.size if mesh is not None else client_mesh_size(
        args, algo_name)
    if mesh is None and n_mesh > 1:
        out = _run_on_mesh(args, algo_name, n_mesh)
        out["client_mesh_devices"] = n_mesh
        return out
    # on a mesh, rank 0 alone writes the log and the results
    lead = mesh is None or mesh.rank == 0
    log_handler = None
    ckpt_mgr = None
    algo = None
    obs_session = None
    try:
        # the lineage's semantics first: a knob a defaulted resume adopts
        # enters the run identity below
        if args.checkpoint_dir:
            ckpt_mgr = CheckpointManager(
                args.checkpoint_dir,
                run_identity(args, algo_name, for_checkpoint=True))
            last = ckpt_mgr.latest_step()
            if last is not None:
                _resolve_lineage_semantics(
                    args, ckpt_mgr.load_metadata(last) or {}, last,
                    ckpt_mgr.directory, algo_name)
        identity = run_identity(args, algo_name)
        if lead:
            configure_console()
            log_handler = add_run_file_logger(
                args.log_dir, getattr(args, "logfile", "") or identity)
        logger.info("run identity: %s", identity)
        _log_inert(args)
        if mesh is not None:
            logger.info("sharding clients over mesh %s", mesh.shape)
        elif int(getattr(args, "mesh_devices", 0) or 0) > 1:
            logger.info(
                "--mesh_devices %d fitted to %d device(s) for %d clients: no "
                "mesh", args.mesh_devices, n_mesh, args.client_num_in_total)
        seed_everything(args.seed)
        if getattr(args, "obs", 0):
            # built after the identity is fixed (no obs knob enters it) and
            # inside a mesh rank's process group (rank 0 alone exports)
            obs_session = _obs_session(args, algo_name, identity)

        with obs_trace.span("build"):
            algo, data = build_algorithm(args, algo_name, mesh=mesh)
        if ckpt_mgr is not None and mesh is not None:
            # the steps hold the single-process layout: the rows gathered
            # to rank 0 on a save, each rank's block kept on a restore
            ckpt_mgr.layout = algo
        _check_augment_consistency(args, algo)
        fuse = max(1, getattr(args, "fuse_rounds", 1) or 1)
        if fuse > 1:
            refuse_fused(algo, algo_name)
        if obs_session is not None and algo._store is not None:
            # the client store's residency ledger joins the memory
            # watermark's samples (JSONL and registry)
            obs_session.memory.attach_extra(algo._store.stats)
        # the fault-count stamper (obs/health.py): the round's effective
        # stragglers and attackers replayed host-side from its fault draws,
        # on the JSONL line only
        obs_fault_counts = None
        if obs_session is not None and getattr(args, "fault_spec", ""):
            from ..obs.health import make_fault_counts_fn

            obs_fault_counts = make_fault_counts_fn(
                args.fault_spec, args.seed, algo.num_clients,
                algo.clients_per_round)
        flight = None
        if getattr(args, "flight_recorder", "") and lead:
            from ..obs.recorder import FlightRecorder

            flight = FlightRecorder(
                os.path.join(args.results_dir or ".", args.dataset),
                identity, spec=args.flight_recorder,
                window=getattr(args, "flight_window", 16),
                profile_retry=bool(getattr(args, "flight_profile", 0)),
                num_clients=algo.num_clients,
                clients_per_round=algo.clients_per_round)
            logger.info("flight recorder armed -> %s", flight.dir)
            if obs_session is not None and \
                    obs_session.event_bus is not None:
                obs_session.event_bus.subscribe(flight.observe_event)
        state = None
        start_round = 0
        if ckpt_mgr is not None and args.resume:
            hints = []
            if getattr(args, "agg_impl", "dense") == "topk":
                hints.append(
                    "(agg_impl='topk' states carry the error-feedback "
                    "residual stack; topk lineages live under their own "
                    "'aggtopk' checkpoint identity and are not "
                    "interchangeable with other impls')")
            if getattr(args, "eval_cache", 0):
                hints.append(
                    "(--eval_cache states carry the per-client eval "
                    "cache; evcache lineages live under their own "
                    "checkpoint identity and are not interchangeable "
                    "with cache-less ones)")
            if algo._store is not None:
                hints.append(
                    "(--client_store lineages keep the per-client rows "
                    "in a store_<step>.npz sidecar next to each step; "
                    "a step without a loadable sidecar is skipped)")
            # init_state registers the store's fields, whose rows the
            # step's snapshot then replaces
            restored = ckpt_mgr.restore_latest(
                algo.init_state(), schema_hint=" ".join(hints),
                store=algo._store)
            if restored is not None:
                state, start_round = restored
                logger.info("resumed from round %d", start_round)
                if obs_session is not None and start_round > 0:
                    # the SLO engine's state rebuilt from the run's own
                    # JSONL (its events are on disk already)
                    replayed = obs_session.slo_replay_from_stream(
                        start_round)
                    if replayed:
                        logger.info(
                            "obs slo: rebuilt engine state from %d "
                            "recorded round(s) (health=%s)", replayed,
                            obs_session.slo.health)
        if state is None:
            with obs_trace.span("init_state"):
                state = algo.init_state()
        wire_model = None
        if obs_session is not None and getattr(args, "obs_comm", 0):
            wire_model = _obs_comm(algo, state, obs_session)
        if args.profile_dir:
            _obs_profile(algo, state, args, identity, obs_session,
                         wire_model, lead)

        # per-round cost accounting (stat_info's sum_training_flops /
        # sum_comm_params): with epoch batching each client consumes its
        # own n_i samples per epoch, the cohort mean standing in for the
        # sampled subset; with replacement, steps x batch
        cost = CostTracker(model=algo.model,
                           sample_shape=algo.init_sample_shape)
        samples_per_client = algo.hp.local_steps * algo.hp.batch_size
        if algo.hp.batching == "epoch":
            samples_per_client = algo.hp.local_epochs * int(
                np.mean(np.asarray(data.n_train)))
        if start_round > 0:
            # the totals the lineage saved (exact for evolving masks too),
            # else an estimate of the earlier rounds from the restored state
            meta = ckpt_mgr.load_metadata(start_round) or {}
            cost_meta = meta.get("cost") or {}
            if "sum_training_flops" in cost_meta:
                cost.restore_totals(cost_meta)
            else:
                cost.record_round(
                    *algo.cost_snapshot(state),
                    n_clients=algo.cost_trained_clients_per_round(),
                    samples_per_client=samples_per_client)

        history = []
        final_eval = None
        counters = RunCounters(
            registry=obs_session.registry if obs_session else None)
        # obs-only enrichment by round (the per-site eval vector), joined
        # to the JSONL line at the flush
        obs_extra: Dict[int, Dict[str, Any]] = {}

        def _obs_extra_for(rec):
            r = rec.get("round")
            extra = obs_extra.pop(r, None)
            if obs_fault_counts is not None and isinstance(r, int) \
                    and r >= 0:
                extra = dict(extra or {})
                # a retried round's accepted attempt trained the re-drawn
                # cohort
                extra.update(obs_fault_counts(
                    r, retry=int(rec.get("rounds_retried") or 0)))
            return extra

        def _emit(rec):
            counters.update(rec)
            if flight is not None:
                flight.observe_record(rec)
            if obs_session is not None:
                obs_session.record_round(rec, extra=_obs_extra_for(rec))
            logger.info("%s round %s: %s", algo_name, rec["round"], rec)

        watchdog = None
        if getattr(args, "watchdog", 0):
            # the host-side divergence watchdog with rollback-retry
            # (robust/recovery.py; refuse_invalid refused fused blocks)
            retries = getattr(args, "max_round_retries", 2)
            if algo.clients_per_round == algo.num_clients and retries:
                # full participation has no other cohort to draw, and a
                # round is deterministic in (state, round): a retry would
                # re-run the failed round; go straight to the skip
                logger.info(
                    "watchdog: full participation — retries are "
                    "deterministic re-runs, short-circuiting to skip")
                retries = 0
            watchdog = RoundWatchdog(
                max_retries=retries,
                backoff_s=getattr(args, "retry_backoff_s", 0.0),
                loss_threshold=getattr(args, "watchdog_loss", 0.0),
                norm_threshold=getattr(args, "watchdog_norm", 0.0),
                ckpt_mgr=ckpt_mgr, template_fn=algo.init_state,
                store=algo._store, mesh=mesh)
        if fuse > 1:
            # K-round fused blocks (FedAlgorithm.run_rounds_fused): on the
            # card one graph replay per round, one metric fetch per block;
            # the final eval is taken once below
            state = _run_fused_rounds(
                algo, algo_name, state, start_round,
                max(start_round, args.comm_round), fuse,
                args.frequency_of_the_test or 0, cost, samples_per_client,
                history, counters, ckpt_mgr=ckpt_mgr, args=args,
                obs_session=obs_session, obs_fault_counts=obs_fault_counts,
                flight=flight)
        else:
            # round r's record is converted and logged after round r+1 is
            # queued (utils/records.py); with obs on it carries
            # round_time_s, stamped at those flushes
            deferred = DeferredRecords(log=_emit,
                                       timed=obs_session is not None)
            try:
                r = start_round
                while r < args.comm_round:
                    nonce = 0
                    if watchdog is not None:
                        # a retry re-samples the cohort (nonce 0 = the
                        # reference's draw)
                        nonce = watchdog.retries_at(r)
                        algo.set_retry_nonce(nonce)
                    prof_dir = (flight.take_retry_profile(r)
                                if flight is not None else None)
                    if prof_dir is not None:
                        # --flight_profile: the watchdog's retry traced
                        # into its bundle, once a run
                        flight.start_profile(prof_dir)
                    # the round leaves ``state`` as it was: the last good
                    # state a retry or a skip goes back to
                    with obs_trace.step_span("round", r):
                        new_state, rec = algo.run_round(state, r)
                    record = {"round": r, **dict(rec)}
                    if watchdog is not None:
                        verdict = watchdog.judge(r, record, new_state,
                                                 state)
                        if prof_dir is not None:
                            flight.stop_profile()
                            prof_dir = None
                        if flight is not None and verdict != recovery.OK:
                            # RETRY and SKIP never reach the emitter: the
                            # bundle is taken here, with this attempt's
                            # cohort nonce
                            flight.note_watchdog(r, verdict, record,
                                                 retry=nonce)
                        if verdict == recovery.RETRY:
                            # the discarded attempt's faults happened:
                            # count them (its record is never emitted)
                            counters.update(record)
                            # its staged store rows go with it
                            algo.store_discard()
                            state = watchdog.rollback(state)
                            continue
                        if verdict == recovery.SKIP:
                            new_state = state  # carry the last-good state
                            algo.store_discard()
                            record["round_skipped"] = 1.0
                        record.update(watchdog.round_counters())
                    if prof_dir is not None:  # no watchdog judged it
                        flight.stop_profile()
                    state = new_state
                    crec = _cost_round_record(algo, cost, samples_per_client,
                                              state)
                    record["sum_training_flops"] = crec["sum_training_flops"]
                    record["sum_comm_params"] = crec["sum_comm_params"]
                    final_eval = None  # state changed: a cached eval is stale
                    if args.frequency_of_the_test and \
                            (r + 1) % args.frequency_of_the_test == 0:
                        with obs_trace.span("eval"):
                            final_eval = algo.evaluate(state)
                        record.update({
                            k: v for k, v in final_eval.items()
                            if not k.startswith("acc_per")})
                        if obs_session is not None and \
                                "acc_per_client" in final_eval:
                            # the per-site series joins the JSONL line
                            # only: the history record is obs-off's
                            obs_extra[r] = {"acc_per_client":
                                            final_eval["acc_per_client"]}
                    history.append(record)
                    deferred.push(record)
                    if ckpt_mgr is not None:
                        ckpt_mgr.save(
                            r + 1, state,
                            metadata=_ckpt_metadata(args, algo, cost),
                            store=algo._store)
                    r += 1
                if watchdog is not None:
                    algo.set_retry_nonce(0)
            except BaseException:
                deferred.flush_safely()  # emit the last completed round
                raise
            deferred.flush()

        fin_rec = None
        # checkpoints hold pre-finalize states, so a resumed run with no
        # rounds left runs the final pass again from the same state
        if getattr(args, "final_finetune", 1):
            with obs_trace.span("finalize"):
                state, fin_rec = algo.finalize(state)
        if fin_rec is not None:
            # the final record (round -1)
            record = {k: v if k in ("round", "finetune") else to_float(v)
                      for k, v in fin_rec.items()}
            history.append(record)
            if obs_session is not None:
                obs_session.record_round(record)
            logger.info("%s final: %s", algo_name, record)
            # only a finalize that trained (FedAvg's fine-tune) counts
            # toward the FLOPs/comm counters
            if record.get("finetune"):
                cost.record_round(*algo.cost_snapshot(state),
                                  n_clients=algo.num_clients,
                                  samples_per_client=samples_per_client)
            final_eval = {k: v for k, v in fin_rec.items()
                          if k not in ("round", "finetune")}
        if final_eval is None:  # the last round was not an eval round
            final_eval = algo.evaluate(state)
        save_masks = getattr(args, "save_masks", False) and \
            hasattr(state, "masks")
        # the end-of-run records read every client's rows: on a client mesh
        # each rank gathers them (all take part, so all ask alike)
        whole = (algo.state_to_global(state)
                 if args.results_dir or save_masks else state)
        extras = {}
        if save_masks:
            # the final masks, as booleans in the reference's layout
            extras["final_masks"] = {
                k: to_reference_layout(k, m, lead=1).cpu().numpy() != 0
                for k, m in whole.masks.items()}
        if getattr(args, "record_mask_diff", False) and \
                hasattr(algo, "mask_distance_matrix"):
            extras["mask_distance_matrix"] = algo.mask_distance_matrix(
                state)
        avg_inf = 0.0
        if args.results_dir and lead:
            avg_inf = avg_inference_flops(
                algo.model, whole, algo.init_sample_shape, algo.num_clients,
                functools.partial(algo.cost_snapshot, whole=True))
        fault_totals = counters.summary()
        if watchdog is not None:
            fault_totals.update(watchdog.totals())
        if ckpt_mgr is not None:
            fault_totals["checkpoint_save_failures"] = float(
                ckpt_mgr.save_failures)
        store_stats = None
        if algo._store is not None:
            # the JAX store's gauges, each rank's own (all take part)
            store_stats = store_stats_by_rank(algo._store, mesh)
            logger.info("client store: %s", store_stats)
        if flight is not None:
            fs = flight.summary()
            if fs["bundles"] or fs["triggers_skipped"]:
                logger.info("flight recorder: %d bundle(s), %d trigger(s) "
                            "over budget: %s", len(fs["bundles"]),
                            fs["triggers_skipped"], fs["bundles"])
            if obs_session is not None:
                obs_session.registry.gauge("flight_bundles").set(
                    float(len(fs["bundles"])))
        obs_snapshot = None
        if obs_session is not None:
            for k, v in fault_totals.items():
                # run-level totals (the watchdog's and the checkpoints'
                # too) in the registry before the final snapshot
                obs_session.registry.gauge("fault_recovery_" + k).set(v)
            obs_snapshot = obs_session.finish()
            if obs_session.metrics_json_path:
                logger.info("obs: metrics.json -> %s",
                            obs_session.metrics_json_path)
            if obs_session.trace_path:
                logger.info("obs: Perfetto trace -> %s",
                            obs_session.trace_path)
        stat_path = save_stat_info(
            args, identity, history, final_eval, extras, cost=cost,
            avg_inference_flops=avg_inf,
            fault_counters=fault_totals,
            obs_metrics=obs_snapshot) if lead else None
        if obs_session is not None and obs_session.slo is not None:
            _slo_verdict(args, identity, obs_session)
        return {
            "identity": identity,
            "history": history,
            "final_eval": final_eval,
            "stat_path": stat_path,
            "state": state,
            "client_mesh_devices": n_mesh,
            "store_stats": store_stats,
        }
    finally:
        if obs_session is not None:
            # idempotent: restores the null tracer and closes the sinks
            # when the run died mid-round too
            obs_session.close()
        if mesh is not None and algo is not None:
            # before the mesh is torn down (ClientMesh.destroy), also when
            # the run raised: a traceback keeps the algorithm reachable
            algo.release_graphs()
        if ckpt_mgr is not None:
            ckpt_mgr.close()
        remove_run_file_logger(log_handler)


def main(argv: Optional[Sequence[str]] = None,
         algo: Optional[str] = None) -> Dict[str, Any]:
    args = parse_args(argv, algo)
    return run_experiment(args, algo)
