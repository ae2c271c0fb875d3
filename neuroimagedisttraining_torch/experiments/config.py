"""Flag surface, derived config, and run-identity strings (counterpart of
``neuroimagedisttraining_tpu/experiments/config.py``, copied whole).

The port parses every command line the JAX CLI accepts to the same namespace
plus one flag of its own, ``--device`` (the role ``JAX_PLATFORMS`` plays
there), and gives the same identity string, so logs and results land at the
same paths. The flags of subsystems the port has not got are parsed all the
same; the runner refuses them (``runner.refuse_unported``).

Like the JAX package, it rebuilds the original per-algorithm argparse mains
(``fedml_experiments/standalone/<algo>/main_<algo>.py``) as one shared flag
table plus per-algorithm extras; the help texts are the JAX package's. Flag
names are kept compatible with the original (``main_sailentgrads.py:31-127``,
``main_dispfl.py:93-108``, ``main_ditto.py:79,101``) so existing sweep
scripts translate 1:1.

Derived config mirrors ``client_num_per_round = int(client_num_in_total *
frac)`` (``main_sailentgrads.py:234``); the identity string doubles as the
experiment-tracking key and the log filename (``main_sailentgrads.py:205-241``).
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

ALGO_NAMES = (
    "fedavg",
    "salientgrads",
    "dispfl",
    "subavg",
    "dpsgd",
    "ditto",
    "fedfomo",
    "local",
    "turboaggregate",
)


def build_parser(algo: Optional[str] = None) -> argparse.ArgumentParser:
    """Common flags + (optionally) one algorithm's extra flags."""
    p = argparse.ArgumentParser(
        prog=f"main_{algo}" if algo else "neuroimagedisttraining_torch",
        description="Federated neuroimaging training (PyTorch/CUDA port)",
    )
    if algo is None:
        p.add_argument("--algo", type=str, default="fedavg",
                       choices=ALGO_NAMES, help="federated algorithm")

    # -- model / data (main_sailentgrads.py:36-63)
    p.add_argument("--model", type=str, default="3dcnn",
                   help="model key in the zoo registry (3dcnn, resnet18, ...)")
    p.add_argument("--dataset", type=str, default="synthetic",
                   help="abcd | abcd_site | cifar10 | cifar100 | "
                        "tiny_imagenet | synthetic")
    p.add_argument("--data_dir", type=str, default="",
                   help="dataset root (ABCD .h5 path or CIFAR batches dir)")
    p.add_argument("--partition_method", type=str, default="dir",
                   help="dir | n_cls | my_part | site (cifar/tiny partition)")
    p.add_argument("--partition_alpha", type=float, default=0.3)
    p.add_argument("--client_num_in_total", type=int, default=8)
    p.add_argument("--frac", type=float, default=1.0,
                   help="fraction of clients sampled per round")

    # -- local training (main_sailentgrads.py:66-101)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--client_optimizer", type=str, default="sgd")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_decay", type=float, default=0.998)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--wd", type=float, default=0.0, help="weight decay")
    p.add_argument("--grad_clip", type=float, default=10.0)
    p.add_argument("--epochs", type=int, default=2,
                   help="local epochs per round")
    p.add_argument("--comm_round", type=int, default=10)
    p.add_argument("--frequency_of_the_test", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ci", type=int, default=0,
                   help="smoke mode: tiny eval to catch programming errors "
                        "(sailentgrads_api.py:260-265 semantics)")
    # accepted for reference sweep-script compatibility; inert here
    # (--gpu is CUDA device selection; --type step is dead code in the
    # reference too — dpsgd's step_train is commented out,
    # dpsgd/my_model_trainer.py:67-82)
    p.add_argument("--gpu", type=int, default=0,
                   help="inert (reference CUDA device id; TPU runs use "
                        "the attached mesh)")
    p.add_argument("--type", type=str, default="epoch",
                   help="inert (reference epoch|step local-loop switch; "
                        "'step' is dead code in the reference)")
    p.add_argument("--final_finetune", type=int, default=1,
                   help="run the algorithm's end-of-training pass "
                        "(FedAvg: final per-client fine-tune, "
                        "fedavg_api.py:79-88; SalientGrads: the eval-only "
                        "final round=-1 _test_on_all_clients, "
                        "sailentgrads_api.py:147); 0 skips it")
    p.add_argument("--track_personal", type=int, default=None,
                   help="fedavg/salientgrads: keep per-client personal "
                        "models (w_per_mdls, fedavg_api.py:42-45 / "
                        "sailentgrads_api.py:107-110) on device for "
                        "per-round personal eval (+ fedavg's final "
                        "fine-tune). The stack is one full model per "
                        "client in HBM; pass 0 for very large "
                        "--client_num_in_total simulations that don't "
                        "need personal models. The None sentinel lets the "
                        "runner distinguish an explicit choice from the "
                        "default when resuming a pre-round-5 salientgrads "
                        "lineage (whose states have no personal stack)")

    # -- robust aggregation (fedml_core/robustness/robust_aggregation.py;
    # dead code in the reference — no caller — wired end-to-end here)
    p.add_argument("--defense_type", type=str, default="none",
                   choices=["none", "norm_diff_clipping", "weak_dp"],
                   help="Byzantine defense applied to client updates before "
                        "averaging (fedavg/salientgrads)")
    p.add_argument("--norm_bound", type=float, default=5.0,
                   help="norm-difference clipping bound "
                        "(robust_aggregation.py:38-50)")
    p.add_argument("--stddev", type=float, default=0.025,
                   help="weak-DP Gaussian noise stddev "
                        "(robust_aggregation.py:52-55)")
    p.add_argument("--robust_agg", type=str, default="none",
                   choices=["none", "median", "trimmed_mean", "krum",
                            "multikrum", "norm_krum"],
                   help="Byzantine-robust aggregation statistic replacing "
                        "the weighted mean over the stacked client updates "
                        "(robust/aggregation.py). Composes with --agg_impl "
                        "(the robust statistic ranks the wire-decoded rows "
                        "for bf16/int8, the sparsified rows for topk), "
                        "--guard quarantine (quarantined clients are masked "
                        "rows), error feedback, and both fed modes")
    p.add_argument("--robust_trim", type=float, default=0.2,
                   help="per-side trim fraction for "
                        "--robust_agg trimmed_mean (0 <= f < 0.5; the trim "
                        "count clamps so at least one survivor row remains)")
    p.add_argument("--robust_krum_f", type=int, default=0,
                   help="assumed Byzantine count f for krum/multikrum/"
                        "norm_krum (0 = auto: max(1, ceil(0.2*cohort)))")

    # -- fault tolerance (new: no reference equivalent — the reference has
    # no fault path at all; see README "Fault tolerance")
    p.add_argument("--fault_spec", type=str, default="",
                   help="deterministic per-round fault injection on the "
                        "central-aggregate round (fedavg/salientgrads), "
                        "e.g. 'drop=0.2,straggle=0.1,nan=0.05,"
                        "scale=0.02:100x' (robust/faults.py). All draws "
                        "derive from --seed, so a --resume'd run replays "
                        "the identical fault trace")
    p.add_argument("--guard", type=int, default=None,
                   help="in-jit non-finite quarantine before aggregation "
                        "(robust/guard.py): screens the stacked client "
                        "updates, zero-weights NaN/Inf/dropped clients, "
                        "renormalizes over survivors (0 survivors = carry "
                        "the previous global model). None = auto: on "
                        "exactly when --fault_spec is set. A guarded clean "
                        "round is bit-identical to the unguarded one")
    p.add_argument("--watchdog", type=int, default=None,
                   help="host-side divergence watchdog with rollback-retry "
                        "(robust/recovery.py): an unhealthy round (non-"
                        "finite train loss, or over the --watchdog_loss/"
                        "--watchdog_norm thresholds) is rolled back to the "
                        "last-good state and retried with a re-sampled "
                        "cohort, --max_round_retries times with backoff; "
                        "then the round is skipped. None = auto: on "
                        "exactly when --fault_spec is set. Requires "
                        "--fuse_rounds 1 (per-round host control)")
    p.add_argument("--watchdog_loss", type=float, default=0.0,
                   help="watchdog train-loss threshold (0 = non-finite "
                        "check only)")
    p.add_argument("--watchdog_norm", type=float, default=0.0,
                   help="watchdog global-update L2-norm threshold "
                        "(0 = off)")
    p.add_argument("--max_round_retries", type=int, default=2,
                   help="watchdog rollback-retry budget per round")
    p.add_argument("--retry_backoff_s", type=float, default=0.0,
                   help="linear backoff between watchdog retries (seconds "
                        "x retry number)")
    p.add_argument("--multihost_timeout_s", type=float, default=0.0,
                   help="jax.distributed.initialize timeout (0 = jax "
                        "default); a slow coordinator fails fast instead "
                        "of hanging the SLURM allocation")
    p.add_argument("--multihost_retries", type=int, default=2,
                   help="bounded retries for the multihost init handshake "
                        "(parallel/multihost.py; mid-run collectives are "
                        "deliberately never retried per-process — that "
                        "would break SPMD collective matching)")

    # -- runtime (new: TPU-native knobs, no reference equivalent)
    p.add_argument("--layout", type=str, default="channels",
                   choices=["channels", "flat", "s2d"],
                   help="volume storage layout: channels=NDHWC (reference); "
                        "flat=channel-less + apply-time inject; s2d=phase-"
                        "decomposed stem input (fastest ABCD path on TPU)")
    p.add_argument("--compute_dtype", type=str, default="",
                   help="mixed-precision compute dtype (e.g. bfloat16); "
                        "master weights stay float32")
    p.add_argument("--data_dtype", type=str, default="",
                   choices=["", "float32", "bfloat16"],
                   help="store volumes in this dtype on device (bfloat16 "
                        "halves HBM for data and skips the per-step "
                        "convert when paired with --compute_dtype bfloat16)")
    p.add_argument("--batching", type=str, default=None,
                   choices=["epoch", "replacement"],
                   help="local batch draw: epoch = per-epoch shuffles, each "
                        "client consuming its own ceil(n_i/batch) batches "
                        "(reference DataLoader semantics, the default); "
                        "replacement = uniform with-replacement draws with "
                        "a uniform mean-derived step count (legacy). The "
                        "None sentinel lets the runner distinguish an "
                        "explicit choice from the default when continuing "
                        "a pre-round-3 checkpoint lineage")
    p.add_argument("--augment", type=int, default=None,
                   help="training-time RandomCrop(H,4)+flip on augmentable "
                        "datasets (cifar10/100, tiny) inside the jitted "
                        "step — the reference's torchvision train pipeline "
                        "(cifar10/data_loader.py:46-50), always on there "
                        "(and on by default here); 0 disables for "
                        "ablations. The None sentinel lets the runner "
                        "distinguish an explicit choice from the default "
                        "when continuing a pre-round-4 lineage")
    p.add_argument("--client_chunk", type=int, default=0,
                   help="chunk vmapped clients to bound HBM (0 = full vmap)")
    p.add_argument("--fuse_rounds", type=int, default=1,
                   help="execute the round loop in K-round fused programs "
                        "(lax.scan over rounds — one dispatch + one metric "
                        "fetch per block). CLI-supported: fedavg, "
                        "salientgrads, ditto, local, dpsgd, and "
                        "dispfl --static (subavg and evolving-mask dispfl "
                        "fuse on the library path only — their evolving "
                        "masks need per-round cost snapshots here; fedfomo/"
                        "turboaggregate have data-dependent host work and "
                        "cannot fuse). With "
                        "--checkpoint_dir, checkpoints save at block "
                        "boundaries instead of every round (lineages stay "
                        "resumable across fused/unfused runs); "
                        "1 = unfused")
    p.add_argument("--agg_impl", type=str, default="dense",
                   choices=["dense", "bucketed", "bf16", "int8", "sparse",
                            "topk", "hier"],
                   help="cross-chip aggregation path for the central "
                        "weighted mean (parallel/collectives.py): dense = "
                        "the exact monolithic contraction (default); "
                        "bucketed = pipelined fixed-size per-bucket "
                        "reduces (exact off-mesh); bf16/int8 = low-"
                        "precision wire with f32 accumulation + master "
                        "weights; sparse = mask-aware reduce on the SNIP "
                        "mask's live coordinates (salientgrads only); "
                        "topk = error-feedback top-k sparsification of "
                        "the client deltas (--agg_topk_density; the "
                        "residual is carried in algorithm state — "
                        "fedavg/salientgrads only, new checkpoint "
                        "lineage); hier = two-stage hierarchical reduce "
                        "(full-precision psum inside each "
                        "--agg_hier_inner-device slice, --agg_hier_wire "
                        "across slices). Centralized algorithms (fedavg/"
                        "salientgrads/ditto) only")
    p.add_argument("--agg_bucket_size", type=int, default=0,
                   help="aggregation bucket size in elements for the "
                        "non-dense --agg_impl paths (0 = the 256k-element "
                        "default, 1 MiB f32 per bucket on the wire)")
    p.add_argument("--agg_topk_density", type=float, default=0.1,
                   help="--agg_impl topk: fraction of each leaf-group's "
                        "coordinates shipped per client per round "
                        "(selected by magnitude within the SNIP mask's "
                        "live set when one exists); the unshipped "
                        "remainder accumulates in the error-feedback "
                        "residual")
    p.add_argument("--agg_topk_sample", type=int, default=0,
                   help="--agg_impl topk: estimate each leaf-group's "
                        "selection threshold from a deterministic "
                        "strided subsample of ~this many candidates "
                        "instead of the exact top-k (the DGC "
                        "hierarchical-sampling trick — top_k is "
                        "sort-bound in group size; error feedback "
                        "absorbs the approximate shipped count). "
                        "0 = exact selection (default)")
    p.add_argument("--agg_hier_wire", type=str, default="bf16",
                   choices=["f32", "bf16", "int8", "sparse"],
                   help="--agg_impl hier: the CROSS-SLICE wire (the "
                        "intra-slice stage is always a full-precision "
                        "psum); sparse = compressed-plan f32 across "
                        "slices (salientgrads only)")
    p.add_argument("--agg_hier_inner", type=int, default=0,
                   help="--agg_impl hier: devices per intra-slice group "
                        "(must divide the clients mesh axis; 0 = the "
                        "balanced auto split, e.g. 8 devices -> 2x4)")
    p.add_argument("--agg_kernels", type=str, default="xla",
                   choices=["xla", "pallas"],
                   help="kernel backend for the aggregation wire's "
                        "selection/quantize hot paths (ops/"
                        "topk_select.py, ops/pallas_kernels.py): xla = "
                        "the pure-XLA bit-exact reference (default); "
                        "pallas = the fused kernels (interpret mode off-"
                        "TPU, so CPU runs exercise the identical kernel "
                        "code). Bit-identical outputs by the tie-break "
                        "contract — never enters run identity")
    p.add_argument("--agg_overlap", type=int, default=1,
                   help="group-ordered aggregation dispatch: emit each "
                        "leaf-group bucket's collective right after its "
                        "own local contraction so XLA can pipeline wire "
                        "against compute (parallel/collectives.py). "
                        "Bit-identical math — scheduling freedom only, "
                        "never enters run identity; 0 restores the "
                        "contract-everything-then-reduce order for A/B "
                        "timing")
    import os as _os

    p.add_argument("--donate_state", type=int,
                   # product default: ON. The env override exists for
                   # compile-budget-bound CI (tests/conftest.py): a
                   # donated executable cannot use the persistent
                   # compilation cache (base._no_persistent_cache_write
                   # — jaxlib 0.4.37 corrupts donated executables on
                   # reload), so the suite runs the borrow default and
                   # the donation suites opt in explicitly
                   default=int(_os.environ.get(
                       "NIDT_DONATE_STATE_DEFAULT", "1")),
                   help="state-ownership protocol: round/fused/finetune "
                        "entry points take ownership of their input "
                        "state (jit donate_argnums), so the [C, model] "
                        "personal stack (and topk residual / eval "
                        "cache) aliases in place instead of being "
                        "re-allocated every call — the RESULTS.md "
                        "Round-13 donation ledger's ~(1+C)-model/round "
                        "rewrite drops to the trained slice. "
                        "Bit-identical to 0 (aliasing only — never "
                        "enters run identity); callers that re-run "
                        "from a saved state borrow via "
                        "algo.clone_state (README 'State ownership & "
                        "donation'). Supported: fedavg/salientgrads/"
                        "ditto; a no-op elsewhere")
    p.add_argument("--eval_cache", type=int, default=0,
                   help="in-state incremental personal eval (fedavg/"
                        "salientgrads with the personal stack): the "
                        "round body evaluates only the trained "
                        "clients' personal rows into a per-client "
                        "(correct, loss_sum, total) cache carried in "
                        "algorithm state — O(clients_per_round) "
                        "forwards per round instead of O(C) per eval, "
                        "riding the fused scan carry and checkpoints. "
                        "Accuracies bit-equal the full eval; losses "
                        "agree to f32 round-off (subset-width "
                        "reassociation — the fused-eval tolerance). "
                        "State-structure change: 'evcache' splits both "
                        "run and checkpoint lineage (the r5 "
                        "track_personal / topk-residual pattern)")
    p.add_argument("--eval_clients", type=int, default=0,
                   help="sampled-eval mode: evaluate only this many "
                        "(seeded) clients per eval instead of the whole "
                        "cohort — bounds the O(N) full-cohort / O(N^2) "
                        "personal eval cost at large client counts "
                        "(0 = all)")
    p.add_argument("--client_store", type=str, default="device",
                   choices=["device", "host", "disk"],
                   help="population-scale client store (core/"
                        "client_store.py): device (default) keeps the "
                        "full [C, model] personal stack / topk residual "
                        "resident in HBM; host / disk stream only the "
                        "sampled cohort's rows to device each round "
                        "(host-RAM LRU hot cache, memory-mapped on-disk "
                        "cold tier for 'disk'), written back on the "
                        "fused-flush path with the next cohort "
                        "prefetched off the gather clock. Bit-identical "
                        "to device residency (tests/test_client_store."
                        "py pins it) — never enters run identity; HBM "
                        "stays flat in --client_num_in_total. "
                        "fedavg/salientgrads/ditto, sampled "
                        "participation only")
    p.add_argument("--store_hot_clients", type=int, default=64,
                   help="client-store host-RAM hot-cache capacity in "
                        "clients per field (LRU; overflow spills to the "
                        "disk tier under 'disk', stays host-resident "
                        "under 'host'). Residency knob only — never "
                        "enters run identity")
    p.add_argument("--fused_kernels", type=int, default=0,
                   help="route the optimizer update through the Pallas "
                        "fused masked-SGD kernel (salientgrads; measured "
                        "neutral on AlexNet3D — see RESULTS.md)")
    p.add_argument("--remat", type=int, default=0,
                   help="rematerialize local-step activations (trades FLOPs "
                        "for HBM so --client_chunk can rise)")
    p.add_argument("--multihost", action="store_true",
                   help="initialize jax.distributed and span the clients "
                        "mesh over every host's devices (TPU pod / "
                        "multi-slice); fails fast if no multi-process "
                        "runtime comes up")
    p.add_argument("--coordinator_address", type=str, default="",
                   help="explicit jax.distributed coordinator (host:port) "
                        "for manually launched CPU/GPU clusters; TPU pods "
                        "auto-detect")
    p.add_argument("--num_processes", type=int, default=0,
                   help="world size for explicit jax.distributed init")
    p.add_argument("--process_id", type=int, default=-1,
                   help="this process's rank for explicit jax.distributed "
                        "init")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="shard client axis over this many devices (0 = all)")
    p.add_argument("--mesh_space", type=int, default=1,
                   help="shard each volume's depth over this many devices "
                        "(hybrid clients x space mesh — the context-parallel "
                        "axis; volumes are zero-padded to divide it)")
    # -- distributed federation (fed/): one aggregator process + N site
    # processes over a real wire (scripts/run_federation.py launcher)
    p.add_argument("--fed_role", type=str, default="",
                   choices=["", "aggregator", "site"],
                   help="federated deployment role: 'aggregator' runs "
                        "rank 0 (and, on --fed_backend local, the whole "
                        "loopback federation in-process); 'site' runs "
                        "one site process (needs --fed_site_rank). "
                        "Empty = the classic in-process simulation")
    p.add_argument("--fed_mode", type=str, default="",
                   choices=["", "sync", "buffered"],
                   help="aggregation policy: 'sync' barriers per round "
                        "(bit-identical to the in-process simulation on "
                        "loopback); 'buffered' is FedBuff-style async — "
                        "first K arriving deltas, staleness-discounted. "
                        "Defaults to 'sync' when --fed_role is set")
    p.add_argument("--fed_backend", type=str, default="local",
                   choices=["local", "tcp"],
                   help="transport: 'local' = in-process loopback "
                        "threads (tests/CI), 'tcp' = the native C++ "
                        "transport across real processes")
    p.add_argument("--fed_sites", type=int, default=0,
                   help="number of site processes (>= 1 for fed runs)")
    p.add_argument("--fed_site_rank", type=int, default=0,
                   help="this site process's rank in [1, fed_sites] "
                        "(--fed_role site only)")
    p.add_argument("--fed_endpoints", type=str, default="",
                   help="rank-ordered 'host:port,...' including the "
                        "aggregator at rank 0 (--fed_backend tcp)")
    p.add_argument("--fed_buffer_k", type=int, default=0,
                   help="buffered mode: apply a flush after this many "
                        "deltas arrive (0 = max(1, fed_sites - 1), the "
                        "leave-one-straggler default)")
    p.add_argument("--fed_staleness_bound", type=int, default=2,
                   help="buffered mode: drop deltas computed more than "
                        "this many versions behind the current global "
                        "model (FedBuff's staleness cap)")
    p.add_argument("--fed_timeout_s", type=float, default=60.0,
                   help="aggregator wait budget: sync collect window / "
                        "buffered arrival gap before quorum degradation")
    p.add_argument("--fed_retries", type=int, default=2,
                   help="send_message retry budget (fed.protocol."
                        "send_with_retry; exponential backoff)")
    p.add_argument("--fed_backoff_s", type=float, default=0.05,
                   help="base backoff between send retries")
    p.add_argument("--fed_trace", type=str, default="",
                   help="write the buffered arrival trace here (default: "
                        "<fed_out>/trace.json)")
    p.add_argument("--fed_replay", type=str, default="",
                   help="replay a recorded arrival trace: the buffered "
                        "run re-applies the same deltas in the same "
                        "order — bit-for-bit deterministic")
    p.add_argument("--fed_site_faults", type=str, default="",
                   help="per-site process faults "
                        "'rank:fault_spec[:delay_s];...' (robust/faults "
                        "grammar), e.g. '3:straggle=1.0:6.0' — site 3 "
                        "REALLY sleeps 6s before replying each round")
    p.add_argument("--fed_out", type=str, default="",
                   help="federation output dir (default: "
                        "<results_dir>/fed/<identity>): per-process "
                        "JSONL streams, the folded federation.jsonl, "
                        "trace.json, summary.json")
    # -- serving plane (serve/): the checkpoint-streaming inference
    # worker. Serving never touches training lineage — every serve_*
    # flag is census-classified inert
    p.add_argument("--serve_role", type=str, default="",
                   choices=["", "worker", "publisher"],
                   help="serving-plane role: 'worker' serves per-client "
                        "inference (with --serve_backend local it also "
                        "hosts the publisher's training loop in-process); "
                        "'publisher' trains and streams checkpoints "
                        "(tcp only). Empty = not a serving run")
    p.add_argument("--serve_backend", type=str, default="local",
                   choices=["local", "tcp"],
                   help="serving transport: 'local' = in-process "
                        "loopback (tests/CI), 'tcp' = the native "
                        "transport across real processes")
    p.add_argument("--serve_endpoints", type=str, default="",
                   help="rank-ordered 'host:port,host:port' — rank 0 "
                        "publisher, rank 1 worker (--serve_backend tcp)")
    p.add_argument("--serve_requests", type=int, default=256,
                   help="synthetic requests the worker's traffic pump "
                        "submits (Zipf-skewed client popularity)")
    p.add_argument("--serve_rps", type=float, default=200.0,
                   help="open-loop target request rate (requests/sec); "
                        "the schedule never slips with service time, so "
                        "a slow worker builds queue depth")
    p.add_argument("--serve_batch", type=int, default=16,
                   help="micro-batch slab width: the one compiled "
                        "forward's leading axis (partial batches pad)")
    p.add_argument("--serve_linger_ms", type=float, default=2.0,
                   help="micro-batch coalescing window from the OLDEST "
                        "pending request — the tail-latency bound")
    p.add_argument("--serve_zipf", type=float, default=1.1,
                   help="Zipf skew exponent for client popularity "
                        "(1.0-1.2 is the classic web range; larger = "
                        "hotter head — harder on the store LRU)")
    p.add_argument("--serve_wire", type=str, default="int8",
                   choices=["dense", "bf16", "int8"],
                   help="fed/wire codec for checkpoint delta pushes "
                        "(first push is always dense full). The worker "
                        "stays bit-identical to the disk checkpoint "
                        "through ANY of these — lossy exactly once, at "
                        "encode")
    p.add_argument("--serve_push_every", type=int, default=1,
                   help="publisher pushes a model version every N "
                        "training rounds")
    p.add_argument("--serve_ckpt_dir", type=str, default="",
                   help="servable checkpoint dir (default: "
                        "<serve_out>/ckpt); the bit-identity gate "
                        "compares the live model against these files")
    p.add_argument("--serve_out", type=str, default="",
                   help="serving output dir (default: "
                        "<results_dir>/serve/<identity>-serve): the "
                        "per-tick JSONL/events streams, metrics.json, "
                        "store rows, checkpoints")
    p.add_argument("--serve_trace", type=str, default="",
                   help="record the served request stream here (JSON; "
                        "replayable with --serve_replay)")
    p.add_argument("--serve_replay", type=str, default="",
                   help="serve a recorded request trace instead of a "
                        "fresh Zipf draw (replay-equality contract)")
    p.add_argument("--serve_store", type=str, default="disk",
                   choices=["disk", "host"],
                   help="personal-model population tier (core/"
                        "client_store): 'disk' rows + host-RAM LRU hot "
                        "set (--store_hot_clients), or all-host")
    p.add_argument("--serve_timeout_s", type=float, default=60.0,
                   help="drain/ack wait budget: worker waits this long "
                        "for serve_finish; publisher for the last ack")
    p.add_argument("--serve_workers", type=int, default=1,
                   help="checkpoint fan-out width (loopback backend): "
                        "N workers (ranks 1..N) subscribe to the one "
                        "publisher, every push broadcasts, ACKs keep "
                        "per-rank watermarks and wait_acked waits for "
                        "the slowest subscriber. Worker 1 takes the "
                        "traffic; extras adopt every version "
                        "identically (the fan-out bit-identity gate)")
    p.add_argument("--checkpoint_dir", type=str, default="",
                   help="enable round-granular orbax checkpointing here")
    p.add_argument("--resume", action="store_true",
                   help="resume from latest checkpoint in --checkpoint_dir")
    p.add_argument("--logfile", type=str, default="",
                   help="override the log filename (default: the run "
                        "identity string, main_sailentgrads.py:248-253)")
    p.add_argument("--log_dir", type=str, default="LOG",
                   help="per-run file logs (main_sailentgrads.py:184-192)")
    p.add_argument("--results_dir", type=str, default="results",
                   help="stat_info pickle dir (subavg_api.py:218-221)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a jax.profiler trace of one round here")
    # -- observability (obs/; telemetry NEVER forks run/checkpoint
    # lineage — none of these enter run_identity)
    p.add_argument("--obs", type=int, default=0,
                   help="enable the observability subsystem (obs/): "
                        "per-round JSONL telemetry + metrics registry + "
                        "host span tracer + memory watermarks. Off (the "
                        "default) is bit-identical to pre-obs behavior")
    p.add_argument("--obs_jsonl", type=str, default="",
                   help="per-round JSONL stream path (default: "
                        "<results_dir>/<dataset>/<identity>.obs.jsonl). "
                        "Only process 0 exports; per-host streams merge "
                        "with obs.export.merge_host_jsonl")
    p.add_argument("--trace_dir", type=str, default="",
                   help="write the host span trace (Chrome trace-event "
                        "JSON, Perfetto-loadable) here at end of run; "
                        "pair with --profile_dir to line host spans up "
                        "with the XLA device trace")
    p.add_argument("--xtrace", type=int, default=0,
                   help="cross-process distributed tracing "
                        "(obs/xtrace.py) for the federation/serving "
                        "planes: the aggregator (or publisher) mints "
                        "one trace context per round, every TRAIN/"
                        "delta/FINISH/push frame carries it as "
                        "control-plane headers, and each process "
                        "writes its own <process>.xtrace.json span "
                        "stream — clock-aligned (HELLO-handshake NTP "
                        "offsets) and folded into one Perfetto-"
                        "loadable federation.trace.json with per-"
                        "process lanes. Also stamps fed_round_ms/"
                        "fed_wire_ms/fed_queue_ms/serve_adopt_lag_ms "
                        "on the round streams for live --slo_spec "
                        "objectives. Off (the default) is byte-inert "
                        "on every wire; never enters run identity")
    p.add_argument("--xtrace_dir", type=str, default="",
                   help="where the per-process *.xtrace.json streams "
                        "and the merged federation.trace.json land "
                        "(default: the fed/serve out_dir)")
    p.add_argument("--obs_heartbeat_every", type=float, default=0.0,
                   help="live fleet telemetry (obs/live.py): every "
                        "UPDATE/ACK frame piggybacks a gauge snapshot "
                        "as hb_* control-plane headers AND each site/"
                        "serve worker emits a standalone fed_heartbeat "
                        "frame every N seconds; the aggregator/"
                        "publisher runs a FleetLedger (LIVE->SUSPECT->"
                        "DOWN on missed heartbeats, SITE_DOWN/"
                        "SITE_RECOVERED typed events, fleet_* gauges "
                        "joined onto round records for federation-"
                        "scope --slo_spec objectives). 0 (the default) "
                        "is byte-inert on every wire; never enters run "
                        "identity")
    p.add_argument("--obs_prom_port", type=int, default=0,
                   help="Prometheus exposition (obs/prom.py): serve "
                        "GET /metrics (text format 0.0.4, "
                        "deterministic key order) from the process "
                        "metrics registry + comm counters + fleet "
                        "gauges on this port — the aggregator and the "
                        "serve worker start the HTTP thread. 0 (the "
                        "default) = off, -1 = ephemeral port (the "
                        "bound port lands in the result dict); pure "
                        "readout, never enters run identity")
    p.add_argument("--obs_watch_every", type=float, default=1.0,
                   help="`obs watch` refresh interval in seconds (the "
                        "live fleet dashboard; tool-side only)")
    p.add_argument("--obs_watch_color", type=int, default=1,
                   help="`obs watch` ANSI health colors (0 = plain "
                        "text, the byte-pinned frame; tool-side only)")
    p.add_argument("--serve_probe_every", type=int, default=0,
                   help="accuracy-under-staleness probe: every N "
                        "serving ticks the worker evaluates its "
                        "CURRENT global model on a small fixed batch "
                        "and stamps serve_probe_acc beside "
                        "serve_model_staleness_s — declarable as an "
                        "SLO objective and joined against staleness "
                        "by the analyzer. 0 (the default) disables "
                        "the probe")
    p.add_argument("--obs_sample_every", type=int, default=1,
                   help="memory-watermark sampling cadence in rounds "
                        "(obs/memory.py; the live-arrays fallback walk "
                        "is O(arrays), so big runs may want >1)")
    p.add_argument("--obs_tb_dir", type=str, default="",
                   help="optional TensorBoard scalar export dir (no-op "
                        "unless a TB writer is importable)")
    p.add_argument("--obs_numerics", type=int, default=0,
                   help="in-jit training-dynamics telemetry "
                        "(obs/numerics.py): per-layer-group update/grad "
                        "norms, non-finite precursor gauges, per-client "
                        "drift/cosine, SalientGrads mask churn/agreement "
                        "— computed inside the jitted round on live "
                        "arrays and returned through the round outputs "
                        "(fused blocks stay sync-free). fedavg/"
                        "salientgrads only. Off (the default) is "
                        "bit-inert")
    p.add_argument("--obs_comm", type=int, default=0,
                   help="communication telemetry (obs/comm.py): the "
                        "analytical wire-cost model's comm_* metrics "
                        "(modeled bytes per agg_impl and per leaf "
                        "group, live mask density) joined onto every "
                        "JSONL line, a once-per-run timed aggregation "
                        "probe (comm_agg_ms / per-round "
                        "comm_agg_share), Message serialized-size "
                        "accounting, and — with --profile_dir — the "
                        "device-trace collective-time attribution "
                        "(obs/devtrace.py) written as "
                        "<identity>.devtrace.json. Requires --obs; "
                        "central-aggregate algorithms (fedavg/"
                        "salientgrads/ditto) only. Off (the default) "
                        "is bit-inert; like every obs knob it never "
                        "enters run/checkpoint identity")
    p.add_argument("--obs_catalog", type=int, default=1,
                   help="fleet run catalog (obs/catalog.py): with "
                        "--obs, append this run's entry (identity + "
                        "lineage keys, identity-bearing flags, git "
                        "SHA, final metrics, end run-health, event "
                        "counts, artifact paths) to "
                        "<results_dir>/runs_index.jsonl when the "
                        "run closes — the index 'obs ls/diff/report' read. "
                        "On by default under --obs; pure readout, "
                        "bit-inert, never enters run/checkpoint "
                        "identity")
    p.add_argument("--slo_spec", type=str, default="",
                   help="online SLO engine (obs/slo.py): declarative "
                        "objectives evaluated incrementally at the "
                        "per-round record hook with O(1)-memory "
                        "streaming estimators — inline ';'-separated "
                        "DSL or a file path (one objective per line), "
                        "e.g. 'p99:round_time_s<2.5@w=20;"
                        "rate:clients_quarantined<0.1@w=50;"
                        "ewma:global_acc>0.55'. Breaches, error-budget "
                        "burn alerts, and OK/DEGRADED/FAILING health "
                        "transitions land on the typed event bus "
                        "(obs/events.py: <identity>.events.jsonl + "
                        "obs tail + flight-recorder 'slo' trigger), "
                        "and the health state is stamped on every "
                        "JSONL round line. Requires --obs; pure "
                        "readout — bit-inert off, trajectory-identical "
                        "on; like every obs knob it never enters "
                        "run/checkpoint identity")
    p.add_argument("--slo_enforce", type=int, default=0,
                   help="with --slo_spec: a run whose health ends "
                        "FAILING exits nonzero AFTER writing every "
                        "artifact (stat_info, metrics.json, events "
                        "stream) — the CI-gateable mode "
                        "scripts/slo_smoke.py drives. 0 (default) "
                        "only observes")
    p.add_argument("--flight_recorder", type=str, default="",
                   help="anomaly flight recorder (obs/recorder.py): "
                        "comma-separated triggers — 'guard' (in-jit "
                        "quarantine fired), 'watchdog' (rollback/skip "
                        "verdict), 'drift>K' (max client drift exceeds "
                        "the trailing median by K robust sigmas; "
                        "non-finite drift always trips), 'slo' (SLO "
                        "breach / budget burn / FAILING transition "
                        "from the --slo_spec event bus), or 'auto' "
                        "(= watchdog,guard). On trigger a bounded "
                        "post-mortem bundle (trigger detail + last-"
                        "K-round numerics window) lands under "
                        "<results_dir>/<dataset>/<identity>.flight/")
    p.add_argument("--flight_window", type=int, default=16,
                   help="flight-recorder sliding window: rounds of "
                        "telemetry frozen into each bundle")
    p.add_argument("--flight_profile", type=int, default=0,
                   help="with --flight_recorder and the watchdog: also "
                        "capture a jax.profiler device trace of the "
                        "first rollback-RETRY attempt into its bundle")
    p.add_argument("--tag", type=str, default="", help="identity suffix")
    # -- the port's own: where the run computes. Never enters run_identity
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (cuda, cuda:N or cpu); "
                        "the default needs CUDA and there is no fallback")

    if algo is not None:
        add_algo_args(p, algo)
    else:
        for a in ALGO_NAMES:
            add_algo_args(p, a)
    return p


def _add_once(p: argparse.ArgumentParser, *args, **kwargs):
    try:
        p.add_argument(*args, **kwargs)
    except argparse.ArgumentError:
        pass  # shared by several algorithms (e.g. --dense_ratio, --cs)


def add_algo_args(p: argparse.ArgumentParser, algo: str) -> None:
    if algo == "salientgrads":
        # main_sailentgrads.py:105-126
        _add_once(p, "--dense_ratio", type=float, default=0.5)
        _add_once(p, "--itersnip_iteration", type=int, default=1)
        _add_once(p, "--snip_mask", type=int, default=1)
        _add_once(p, "--stratified_sampling", type=int, default=0)
        _add_once(p, "--stratified_mode", type=str, default="exact",
                  choices=["exact", "balanced"],
                  help="--stratified_sampling scoring schedule: exact = "
                       "the reference's StratifiedKFold(25, shuffle, "
                       "seed 42) train-side folds (sailentgrads/"
                       "client.py:32-42); balanced = 25 class-balanced "
                       "random draws (fast path)")
    elif algo in ("dispfl", "dpsgd"):
        # main_dispfl.py:93-108
        _add_once(p, "--cs", type=str, default="random",
                  help="client/neighbor selection: random | ring | full")
        if algo == "dispfl":
            _add_once(p, "--dense_ratio", type=float, default=0.5)
            _add_once(p, "--anneal_factor", type=float, default=0.5)
            _add_once(p, "--active", type=float, default=1.0,
                      help="per-round client participation probability")
            _add_once(p, "--static", action="store_true",
                      help="freeze masks (no fire/regrow)")
            _add_once(p, "--erk_power_scale", type=float, default=1.0)
            _add_once(p, "--dis_gradient_check", action="store_true")
            _add_once(p, "--uniform", action="store_true",
                      help="flat per-layer sparsity instead of ERK "
                           "(main_dispfl.py:102)")
            _add_once(p, "--different_initial", action="store_true",
                      help="per-client independent initial masks "
                           "(main_dispfl.py:104; default is one shared)")
            _add_once(p, "--diff_spa", action="store_true",
                      help="clients cycle dense ratios 0.2..1.0 "
                           "(main_dispfl.py:106)")
            _add_once(p, "--save_masks", action="store_true",
                      help="store final masks in stat_info "
                           "(main_dispfl.py:103, dispfl_api.py:177-183)")
            _add_once(p, "--record_mask_diff", action="store_true",
                      help="store the pairwise mask hamming matrix in "
                           "stat_info (main_dispfl.py:105)")
            # accepted for reference CLI compatibility; inert in the
            # reference too (defined in main_dispfl.py:97,100 but never
            # consumed by its api/trainer)
            _add_once(p, "--public_portion", type=float, default=0.0)
            _add_once(p, "--strict_avg", action="store_true")
            _add_once(p, "--global_test", action="store_true",
                      help="identity-tag only, as in the reference "
                           "(main_dispfl.py:198-199 appends '-g' and "
                           "nothing consumes it further)")
    elif algo == "subavg":
        _add_once(p, "--dense_ratio", type=float, default=0.5)
        _add_once(p, "--each_prune_ratio", type=float, default=0.2)
        _add_once(p, "--dist_thresh", type=float, default=0.001)
        _add_once(p, "--acc_thresh", type=float, default=0.5)
    elif algo == "ditto":
        # main_ditto.py:79,101
        _add_once(p, "--lamda", type=float, default=0.5)
        _add_once(p, "--local_epochs", type=int, default=0,
                  help="personal-model epochs (0 = same as --epochs)")
    elif algo == "fedfomo":
        _add_once(p, "--val_fraction", type=float, default=0.1,
                  help="per-client validation split (data_val_loader)")
    elif algo == "turboaggregate":
        _add_once(p, "--n_groups", type=int, default=3)


def derive(args: argparse.Namespace) -> argparse.Namespace:
    """Post-parse derived fields (main_sailentgrads.py:234; rounding matches
    ``FedAlgorithm.__init__``'s ``int(round(...))`` so the recorded config
    reflects the actual per-round participation)."""
    args.client_num_per_round = max(
        1, int(round(args.client_num_in_total * args.frac)))
    if getattr(args, "ci", 0):
        args.comm_round = min(args.comm_round, 2)
    # resolve the explicit-vs-default sentinels (the runner's checkpoint
    # lineage guards need to know whether the user CHOSE the semantics or
    # inherited a flipped default — ADVICE r3)
    args.batching_explicit = getattr(args, "batching", None) is not None
    if getattr(args, "batching", None) is None:
        args.batching = "epoch"
    args.augment_explicit = getattr(args, "augment", None) is not None
    if getattr(args, "augment", None) is None:
        args.augment = 1
    args.track_personal_explicit = \
        getattr(args, "track_personal", None) is not None
    if getattr(args, "track_personal", None) is None:
        args.track_personal = 1
    # fault tolerance: validate the spec at parse time (a typo'd chaos
    # config must die here, not silently inject nothing) and resolve the
    # guard/watchdog auto sentinels — both default to ON exactly when
    # faults are injected
    fault_spec = getattr(args, "fault_spec", "")
    if fault_spec:
        from ..robust.faults import parse_fault_spec

        parse_fault_spec(fault_spec)  # raises ValueError on bad specs
    # robust aggregation: range-check the estimator knobs at parse time
    # (base.py re-validates for programmatic construction, but a typo'd
    # CLI run must die before it builds a model)
    if not 0.0 <= getattr(args, "robust_trim", 0.2) < 0.5:
        raise ValueError(
            f"--robust_trim {args.robust_trim} out of range [0, 0.5): "
            "trimming half or more per side leaves no survivor rows")
    if getattr(args, "robust_krum_f", 0) < 0:
        raise ValueError(
            f"--robust_krum_f {args.robust_krum_f} must be >= 0 "
            "(0 = auto-resolve to max(1, ceil(0.2*cohort)))")
    # same rule for the flight-recorder trigger spec: a typo'd trigger
    # must die at parse time, not silently at the fault it was meant
    # to capture
    if getattr(args, "flight_recorder", ""):
        from ..obs.recorder import parse_triggers

        parse_triggers(args.flight_recorder)
    # same rule for the SLO spec: a typo'd objective must die at parse
    # time, not silently watch nothing. File specs must exist by now —
    # a missing file gets load_slo_spec's missing-file error here
    # rather than a confusing malformed-DSL one mid-run.
    if getattr(args, "slo_spec", ""):
        from ..obs.slo import load_slo_spec

        load_slo_spec(args.slo_spec)  # raises ValueError on bad specs
    # live-telemetry knobs: range checks at parse time (same rule)
    if float(getattr(args, "obs_heartbeat_every", 0.0) or 0.0) < 0:
        raise ValueError(
            f"--obs_heartbeat_every {args.obs_heartbeat_every} must be "
            ">= 0 (seconds between heartbeat frames; 0 = off)")
    if int(getattr(args, "obs_prom_port", 0) or 0) < -1:
        raise ValueError(
            f"--obs_prom_port {args.obs_prom_port} must be >= -1 "
            "(0 = off, -1 = ephemeral, else the port to bind)")
    if float(getattr(args, "obs_watch_every", 1.0) or 0.0) <= 0:
        raise ValueError(
            f"--obs_watch_every {args.obs_watch_every} must be > 0")
    if getattr(args, "guard", None) is None:
        args.guard = 1 if fault_spec else 0
    if getattr(args, "watchdog", None) is None:
        # the watchdog needs per-round host control, which --fuse_rounds
        # removes; fused fault injection is supported WITHOUT it (the
        # in-jit guard still runs), so the auto-sentinel resolves to off
        # there instead of tripping the runner's explicit-combination
        # refusal
        args.watchdog = 1 if (
            fault_spec and getattr(args, "fuse_rounds", 1) <= 1) else 0
    # federated deployment (fed/): resolve the mode sentinel and validate
    # the per-site fault grammar at parse time (the fault_spec rule).
    # fed_mode, not fed_role, is the identity gate: the role names WHICH
    # process this is (inert), the mode names WHAT model gets trained.
    fed_role = getattr(args, "fed_role", "")
    fed_mode = getattr(args, "fed_mode", "")
    if fed_mode and not fed_role:
        raise ValueError("--fed_mode requires --fed_role")
    if fed_role:
        if not fed_mode:
            args.fed_mode = fed_mode = "sync"
        if getattr(args, "fed_sites", 0) < 1:
            raise ValueError("--fed_role requires --fed_sites >= 1")
        if fed_mode == "buffered" and \
                getattr(args, "fed_buffer_k", 0) <= 0:
            # leave-one-straggler default: a flush never waits for the
            # slowest site
            args.fed_buffer_k = max(1, args.fed_sites - 1)
        if getattr(args, "fed_site_faults", ""):
            # parse-time validation of the per-site fault grammar
            from ..fed.runtime import parse_site_faults

            parse_site_faults(args.fed_site_faults)  # raises ValueError
        if getattr(args, "fed_replay", "") and \
                not os.path.isfile(args.fed_replay):
            raise ValueError(
                f"--fed_replay trace {args.fed_replay!r} does not exist")
    # serving plane (serve/): parse-time validation of what can be
    # checked without building anything (the fault_spec rule); the
    # full refusal cluster runs in serve.runtime.validate_serve_args
    serve_role = getattr(args, "serve_role", "")
    if serve_role:
        if fed_role:
            raise ValueError(
                "--serve_role and --fed_role are different processes; "
                "run the federation and the serving worker separately")
        if getattr(args, "serve_backend", "local") == "local" and \
                serve_role != "worker":
            raise ValueError(
                "--serve_backend local hosts the publisher in-process; "
                "--serve_role publisher needs --serve_backend tcp")
        if getattr(args, "serve_backend", "local") == "tcp" and \
                not getattr(args, "serve_endpoints", ""):
            raise ValueError(
                "--serve_backend tcp needs --serve_endpoints "
                "host:port,host:port (rank 0 publisher, rank 1 worker)")
        if getattr(args, "serve_replay", "") and \
                not os.path.isfile(args.serve_replay):
            raise ValueError(
                f"--serve_replay trace {args.serve_replay!r} does not "
                "exist")
    return args


# extras that belong to each algorithm's identity string (subset of the
# flags added by add_algo_args; keep in sync)
_IDENTITY_EXTRAS = {
    "salientgrads": ("dense_ratio", "itersnip_iteration"),
    "dispfl": ("dense_ratio", "cs", "active", "anneal_factor"),
    "dpsgd": ("cs",),
    "subavg": ("dense_ratio", "each_prune_ratio"),
    "ditto": ("lamda",),
    "turboaggregate": ("n_groups",),
}


def run_identity(args: argparse.Namespace, algo: Optional[str] = None,
                 for_checkpoint: bool = False) -> str:
    """Experiment-identity string, the run's tracking key and log filename
    (rebuild of ``main_sailentgrads.py:205-241``).

    ``for_checkpoint`` drops the ``r{comm_round}`` component so a run
    resubmitted with a larger round budget (the post-TIME-LIMIT resume case,
    ``DisPFL/error3469448.err``) finds its own checkpoints.
    """
    algo = algo or getattr(args, "algo", "fedavg")
    parts: List[str] = [
        algo, args.dataset, args.model,
        f"c{args.client_num_in_total}", f"frac{args.frac:g}",
    ]
    if not for_checkpoint:
        parts.append(f"r{args.comm_round}")
    parts += [
        f"e{args.epochs}", f"bs{args.batch_size}",
        f"lr{args.lr:g}", f"seed{args.seed}",
    ]
    # only this algorithm's extras — the unified --algo parser defines every
    # algorithm's flags on the namespace, so filtering by algo keeps the
    # identity (and hence checkpoint/log paths) stable across entry points
    for extra in _IDENTITY_EXTRAS.get(algo, ()):
        v = getattr(args, extra, None)
        if v is not None:
            parts.append(f"{extra.replace('_', '')}{v:g}"
                         if isinstance(v, float) else f"{extra[:4]}{v}")
    # defense and fine-tune knobs change training behavior — they must
    # split checkpoint/log/stat_info lineages (unlike inert identity tags)
    if algo == "salientgrads" and getattr(args, "stratified_sampling", 0):
        # the scoring schedule changes the mask and hence all training —
        # both stratified modes split from the itersnip default and from
        # each other (exact = reference folds, balanced = random draws)
        parts.append(f"strat-{getattr(args, 'stratified_mode', 'exact')}")
    if getattr(args, "defense_type", "none") != "none":
        parts.append(f"def{args.defense_type}")
        parts.append(f"nb{args.norm_bound:g}")
        if args.defense_type == "weak_dp":
            parts.append(f"sd{args.stddev:g}")
    robust_agg = getattr(args, "robust_agg", "none")
    if robust_agg != "none":
        # the robust statistic replaces the weighted mean, changing the
        # global trajectory on every round — splits BOTH lineages (same
        # rule as defense_type). Only the knobs the chosen estimator
        # actually reads enter the identity: trim_frac for trimmed_mean,
        # krum_f for the krum family, norm_bound for norm_krum's clip.
        parts.append(f"ragg{robust_agg}")
        if robust_agg == "trimmed_mean":
            parts.append(f"rtrim{getattr(args, 'robust_trim', 0.2):g}")
        elif robust_agg in ("krum", "multikrum", "norm_krum"):
            parts.append(f"rkf{getattr(args, 'robust_krum_f', 0)}")
            if robust_agg == "norm_krum":
                parts.append(f"rnb{getattr(args, 'norm_bound', 5.0):g}")
    if getattr(args, "fault_spec", ""):
        # fault injection changes the state trajectory, so it splits BOTH
        # log/stat_info and checkpoint lineages (unlike the guard alone,
        # which is bit-identical on clean rounds and splits nothing)
        parts.append("flt" + args.fault_spec.replace("=", "")
                     .replace(",", "-").replace(":", "x")
                     .replace(".", "p"))
    if getattr(args, "watchdog", 0):
        # the watchdog also changes the trajectory when it fires (retried
        # rounds train a re-sampled cohort; skipped rounds carry state),
        # and its thresholds/retry budget determine WHICH rounds those
        # are — same lineage-split rule as fault_spec. retry_backoff_s
        # only changes timing, not state, so it stays out.
        parts.append(
            f"wdl{getattr(args, 'watchdog_loss', 0.0):g}"
            f"n{getattr(args, 'watchdog_norm', 0.0):g}"
            f"r{getattr(args, 'max_round_retries', 2)}")
    if not for_checkpoint:
        # these knobs change the metric protocol / training draw, so log
        # and stat_info lineages must split — but the checkpointed STATE
        # (f32 master params + rng) is interchangeable across them, so the
        # checkpoint identity excludes them (like r{comm_round}): legacy
        # lineages stay resumable, and a cross-mode --batching resume is
        # caught by the checkpoint metadata guard in the runner instead
        if getattr(args, "batching", "epoch") != "epoch":
            parts.append("wr")  # with-replacement draws train differently
        if not getattr(args, "augment", 1):
            from ..data import dataset_is_augmentable

            # only augmentable datasets consume the flag; an ABCD lineage
            # must not split on a no-op (same rule as 'nopers' below)
            if dataset_is_augmentable(args.dataset):
                parts.append("noaug")  # un-augmented CIFAR/tiny ablation
        if getattr(args, "eval_clients", 0):
            parts.append(f"evK{args.eval_clients}")
        agg_impl = getattr(args, "agg_impl", "dense")
        if agg_impl != "dense":
            # bf16/int8/sparse/topk/hier change the aggregate's numerics
            # (bucketed only its association on-mesh) — metric lineages
            # must split; the checkpointed f32 state stays
            # interchangeable, so the checkpoint identity excludes it
            # (resumable across impls) — EXCEPT topk, which carries the
            # error-feedback residual in state (split below, outside
            # this for_checkpoint-only block)
            parts.append(f"agg{agg_impl}")
            if agg_impl == "hier":
                # the cross-slice wire (and an explicit slice split)
                # change the aggregate's numerics too
                parts.append(f"hw{getattr(args, 'agg_hier_wire', 'bf16')}")
                if getattr(args, "agg_hier_inner", 0):
                    parts.append(f"hi{args.agg_hier_inner}")
        if getattr(args, "data_dtype", ""):
            parts.append(f"dt{args.data_dtype}")
    if getattr(args, "agg_impl", "dense") == "topk":
        # topk splits the CHECKPOINT lineage too (unlike the other
        # impls): its states carry the error-feedback residual stack —
        # a different state STRUCTURE (the r5 personal-stack precedent)
        # — and the residual is trajectory (a mid-lineage density change
        # would silently re-weight deferred updates), so the density
        # rides both identities
        if for_checkpoint:
            parts.append("aggtopk")
        parts.append(f"tk{getattr(args, 'agg_topk_density', 0.1):g}")
        if getattr(args, "agg_topk_sample", 0):
            # the sampled threshold changes WHICH coordinates ship —
            # trajectory, so it splits both lineages like the density
            parts.append(f"tks{args.agg_topk_sample}")
    if algo in ("fedavg", "salientgrads") and \
            getattr(args, "eval_cache", 0) and \
            getattr(args, "track_personal", 1):
        # eval_cache changes the state STRUCTURE (the in-state per-
        # client eval cache rides checkpoints — the r5 personal-stack /
        # topk-residual precedent) and the personal-loss reduction
        # width (f32 ulps), so BOTH lineages split. Only the consuming
        # algorithms split (the 'nopers' rule); --track_personal 0 has
        # no stack to cache, so the runner refuses it before here.
        parts.append("evcache")
    if not getattr(args, "final_finetune", 1):
        parts.append("noft")
    if algo in ("fedavg", "salientgrads") and \
            not getattr(args, "track_personal", 1):
        # only fedavg/salientgrads consume the flag; other algorithms'
        # lineage must not split on a no-op
        parts.append("nopers")
    if getattr(args, "global_test", False):
        parts.append("g")  # main_dispfl.py:198-199
    fed_mode = getattr(args, "fed_mode", "")
    if fed_mode:
        # federated deployment changes the trained model: sync splits
        # from the in-process lineage by protocol only (bit-identical on
        # loopback, but eval/finetune/personal coverage differ), and the
        # buffered policy's K / staleness bound / site partition shape
        # the aggregate itself. Role/backend/addresses/timeouts stay out
        # — they name WHERE the same computation runs.
        parts.append(f"fed{fed_mode}")
        parts.append(f"fs{getattr(args, 'fed_sites', 0)}")
        if fed_mode == "buffered":
            parts.append(f"fk{getattr(args, 'fed_buffer_k', 0)}")
            parts.append(f"fst{getattr(args, 'fed_staleness_bound', 0)}")
            if getattr(args, "fed_replay", ""):
                # a replayed run pins arrival order — a different
                # trajectory universe than free-running async
                parts.append("fedreplay")
        if getattr(args, "fed_site_faults", ""):
            # real-process faults change which deltas exist (drops) and
            # when they land (straggles) — trajectory, like fault_spec
            parts.append("fflt" + args.fed_site_faults.replace("=", "")
                         .replace(",", "-").replace(":", "x")
                         .replace(";", "_").replace(".", "p"))
    if args.tag:
        parts.append(args.tag)
    return "-".join(str(x) for x in parts)


def parse_args(argv: Optional[Sequence[str]] = None,
               algo: Optional[str] = None) -> argparse.Namespace:
    return derive(build_parser(algo).parse_args(argv))
