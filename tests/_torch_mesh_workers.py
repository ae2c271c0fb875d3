"""Gloo ranks for the port's client-mesh tests (``tests/test_torch_port_mesh*.py``,
``tests/test_torch_port_cli.py``): :func:`run_ranks` spawns one process a
rank, joins them into a ``file://`` gloo group, runs a list of cases (each a
function of this module by name, called on every rank with the rank's
``ClientMesh``) and returns every rank's results through files. The module
imports torch, numpy and the port only (``spawn`` imports it in each child
by name): no JAX in the ranks."""
import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp


def run_ranks(world, cases, timeout_dir=None, timeout=None):
    """Run ``cases`` (a list of ``(name, kwargs)``) on a ``world``-rank gloo
    group of CPU processes. Returns ``results[case][rank]``; a rank that
    raised re-raises here with its traceback. With ``timeout`` (seconds)
    the ranks are killed and ``TimeoutError`` raised when they have not
    all finished by then, and a collective waits at most that long."""
    with tempfile.TemporaryDirectory(dir=timeout_dir) as d:
        with open(os.path.join(d, "cases.pkl"), "wb") as f:
            pickle.dump(cases, f)
        ctx = mp.start_processes(_rank_main, args=(world, d, timeout),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=None if deadline is None else 1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"the {world} ranks did not finish "
                                   f"{len(cases)} cases in {timeout} s")
        out = []
        for i in range(len(cases)):
            row = []
            for r in range(world):
                with open(os.path.join(d, f"out_{i}_{r}.pkl"), "rb") as f:
                    got = pickle.load(f)
                if isinstance(got, _Failure):
                    raise AssertionError(
                        f"case {cases[i][0]} rank {r}:\n{got.tb}")
                row.append(got)
            out.append(row)
        return out


class _Failure:
    def __init__(self, tb):
        self.tb = tb


def _rank_main(rank, world, d, timeout=None):
    import datetime

    from neuroimagedisttraining_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(world, backend="gloo", rank=rank, device="cpu",
                     init_method="file://" + os.path.join(d, "rendezvous"),
                     timeout=None if timeout is None
                     else datetime.timedelta(seconds=timeout))
    try:
        with open(os.path.join(d, "cases.pkl"), "rb") as f:
            cases = pickle.load(f)
        for i, (name, kw) in enumerate(cases):
            try:
                got = globals()[name](mesh, **kw)
            except Exception:  # reported to the parent, which fails the test
                got = _Failure(traceback.format_exc())
            with open(os.path.join(d, f"out_{i}_{rank}.pkl"), "wb") as f:
                pickle.dump(got, f)
            if isinstance(got, _Failure):
                # the other ranks may wait in a collective of this case
                os._exit(1)
        mesh.barrier()
    finally:
        mesh.destroy()


# -- the collectives -------------------------------------------------------

def _uniform_table(table):
    """The int8 wire's draws as a callable of (rank or slice, payload leaf,
    shape) over a table ``{(wid, i): array}`` computed by the caller."""
    def draw(wid, i, shape):
        u = torch.from_numpy(np.asarray(table[(wid, i)], np.float32))
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return u

    return draw


def reduce_case(mesh, fn, tree, weights, kw, uniforms=None, masks=None,
                plan_mask=None, plan_stacked=False, shard=True):
    """One weighted mean on the mesh: ``fn`` names the collective
    (``weighted_mean``, ``sparse_weighted_mean``, ``topk_weighted_mean``),
    ``tree`` / ``masks`` the whole ``[C, ...]`` numpy trees (each rank
    keeps its block where ``shard``), ``plan_mask`` the plan's mask.
    Returns the result as numpy (and the rank's sparsified rows for top-k)."""
    from neuroimagedisttraining_torch.parallel import collectives as tc
    from neuroimagedisttraining_torch.parallel.mesh import shard_over_clients

    full = {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
    rows = shard_over_clients(full, mesh) if shard else full
    w = torch.from_numpy(np.asarray(weights, np.float32))
    kw = dict(kw)
    if uniforms is not None:
        kw["uniforms"] = _uniform_table(uniforms)
    if plan_mask is not None:
        pm = {k: torch.from_numpy(np.asarray(v)) for k, v in plan_mask.items()}
        kw["plan"] = tc.build_sparse_plan(pm, stacked=plan_stacked)
    if masks is not None:
        m = {k: torch.from_numpy(np.asarray(v)) for k, v in masks.items()}
        kw["masks"] = shard_over_clients(m, mesh) if shard else m
    if fn == "sparse_weighted_mean":
        plan = kw.pop("plan")
        out = tc.sparse_weighted_mean(rows, w, plan, mesh=mesh, **kw)
        return {k: v.numpy() for k, v in out.items()}
    if fn == "topk_weighted_mean":
        k_frac = kw.pop("k_frac")
        out, sp = tc.topk_weighted_mean(rows, w, k_frac, mesh=mesh, **kw)
        return ({k: v.numpy() for k, v in out.items()},
                {k: v.numpy() for k, v in sp.items()})
    out = getattr(tc, fn)(rows, w, mesh=mesh, **kw)
    return {k: v.numpy() for k, v in out.items()}


def partial_case(mesh, tree, weights, bucket_size):
    """The rank's local partials, as the on-mesh reduce contracts them
    (the reference's per-device ``tensordot``), per leaf in reference leaf
    order (numpy)."""
    from neuroimagedisttraining_torch.convert import (
        reference_leaf_order,
        to_reference_layout,
    )
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.parallel.mesh import shard_over_clients

    full = {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
    rows = shard_over_clients(full, mesh)
    w = torch.from_numpy(np.asarray(weights, np.float32))
    lo, hi = mesh.block(w.shape[0])
    out = {}
    for k in reference_leaf_order(rows):
        mat = to_reference_layout(k, rows[k], lead=1).reshape(hi - lo, -1)
        out[k] = kernels.fused_weighted_sum(
            {k: mat.contiguous()}, w[lo:hi].contiguous())[k].numpy()
    return out


def agg_case(mesh, **kw):
    """``collectives.agg_microbench`` on the mesh."""
    from neuroimagedisttraining_torch.parallel.collectives import \
        agg_microbench

    return agg_microbench(mesh, **kw)


# -- the round ---------------------------------------------------------------

def round_case(mesh, algo, data_seed, frac, agg_impl, rounds=2,
               perms=None, snip_idx=None, params=None, mask=None,
               finalize=False, **build):
    """SalientGrads or FedAvg on ``small3dcnn`` (:func:`build_round_algo`),
    ``rounds`` rounds and the eval after each, on the mesh (see
    :func:`drive_round`). ``perms`` (per round, per selected client),
    ``snip_idx``, ``params`` and ``mask`` are the seams (None: the port's
    own draws)."""
    a = build_round_algo(algo, data_seed, frac, agg_impl, mesh=mesh, **build)
    return drive_round(a, rounds, perms, snip_idx, params, mask, finalize)


def build_round_algo(algo, data_seed, frac, agg_impl, n_clients=8,
                     sample_shape=(8, 8, 8, 1), bucket_size=0, hier_inner=0,
                     hier_wire="bf16", dropout=0.0, mesh=None, samples=8,
                     seed=0, defense=None, **opts):
    """The round tests' algorithm: ``n_clients`` synthetic clients of data
    seed ``data_seed`` (``samples`` train rows, 4 test), batch 4,
    ``small3dcnn`` at ``dropout``, run seed ``seed``, sharded over ``mesh``
    when given; ``defense`` names a ``RobustAggregator`` (bound 5, stddev
    0.025); ``opts`` go to the algorithm (``eval_cache``,
    ``eval_clients``, ``stratified_sampling``, ``fault_spec``, ...)."""
    from neuroimagedisttraining_torch.robust import RobustAggregator

    from neuroimagedisttraining_torch.algorithms import FedAvg, SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.parallel.mesh import shard_federated

    data = make_synthetic_federated(seed=data_seed, n_clients=n_clients,
                                    samples_per_client=samples,
                                    test_per_client=4,
                                    sample_shape=tuple(sample_shape))
    if mesh is not None:
        data = shard_federated(data, mesh)
    spe = -(-int(np.max(np.asarray(data.n_train))) // 4)
    hp = HyperParams(lr=0.01, lr_decay=0.998, momentum=0.9,
                     weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                     steps_per_epoch=spe, batch_size=4)
    torch.manual_seed(0)
    model = create_model("small3dcnn", num_classes=1, dropout_rate=dropout)
    kw = dict(loss_type="bce", frac=frac, seed=seed, agg_impl=agg_impl,
              agg_bucket_size=bucket_size, agg_hier_inner=hier_inner,
              agg_hier_wire=hier_wire, device="cpu", **opts)
    if defense:
        kw["defense"] = RobustAggregator(defense, 5.0, 0.025)
    if algo == "salientgrads":
        return SalientGrads(model, data, hp, dense_ratio=0.5, **kw)
    return FedAvg(model, data, hp, **kw)


def _np_tree(t):
    return None if t is None else {k: v.detach().numpy() for k, v in t.items()}


def _state_np(state):
    return dict(global_params=_np_tree(state.global_params),
                personal=_np_tree(state.personal_params),
                residual=_np_tree(state.agg_residual),
                eval_cache=_np_tree(state.eval_cache))


def drive_round(a, rounds, perms=None, snip_idx=None, params=None,
                mask=None, finalize=False):
    """``rounds`` rounds of ``a``, the eval after each (see
    :func:`round_case`). Returns the mask, the state (this rank's rows of
    the per-client stacks) before each round and after the last, the
    round metrics and the evals, and FedAvg's fine-tune with
    ``finalize``."""
    import dataclasses

    if params is not None:
        params = {k: torch.from_numpy(np.asarray(v)) for k, v in
                  params.items()}
    kw = {}
    if snip_idx is not None:
        kw["snip_idx"] = snip_idx
    state = a.init_state(params=params, **kw)
    if mask is not None:
        state = dataclasses.replace(state, mask={
            k: torch.from_numpy(np.asarray(v)) for k, v in mask.items()})
    states, mets, evals = [], [], []
    for r in range(rounds):
        states.append(_state_np(state))
        state, met = a.run_round(state, r, perms=None if perms is None
                                 else perms[r])
        mets.append({k: np.asarray(v) for k, v in met.items()})
        evals.append({k: np.asarray(v) for k, v in a.evaluate(state).items()})
    states.append(_state_np(state))
    out = dict(states=states, mets=mets, evals=evals,
               mask=_np_tree(getattr(state, "mask", None)),
               lo=a._lo, hi=a._hi)
    if finalize:
        state, rec = a.finalize(state)
        out["final"] = {k: np.asarray(v) for k, v in rec.items()
                        if k not in ("round", "finetune")}
        out["final_personal"] = _np_tree(state.personal_params)
    return out


def _whole(ranks, key, field):
    """A per-client stack of the mesh's state, the ranks' blocks in order."""
    trees = [r["states"][key][field] for r in ranks]
    if trees[0] is None:
        return None
    return {k: np.concatenate([t[k] for t in trees]) for k in trees[0]}


def replay_off_mesh(a, ranks, rounds, perms=None, snip_idx=None,
                    params=None, mask=None, finalize=False):
    """The mesh run ``ranks`` (every rank's :func:`drive_round`) replayed by
    ``a``, off the mesh: each round from the mesh's state before it (the
    generator in step, as both draw the same), and each eval of the mesh's
    state after the round. Returns, per round, the trained state, the
    metrics and the eval, and the fine-tune of the mesh's last state."""
    import dataclasses

    def tensors(t):
        return None if t is None else {k: torch.from_numpy(np.asarray(v))
                                       for k, v in t.items()}

    def at(state, key):
        return dataclasses.replace(
            state,
            global_params=tensors(ranks[0]["states"][key]["global_params"]),
            personal_params=tensors(_whole(ranks, key, "personal")),
            agg_residual=tensors(_whole(ranks, key, "residual")),
            # the eval cache is replicated: every rank holds all of it
            eval_cache=tensors(ranks[0]["states"][key]["eval_cache"]))

    kw = {}
    if snip_idx is not None:
        kw["snip_idx"] = snip_idx
    state = a.init_state(params=tensors(params), **kw)
    if mask is not None:
        state = dataclasses.replace(state, mask=tensors(mask))
    out = dict(mask=_np_tree(getattr(state, "mask", None)), states=[],
               mets=[], evals=[])
    for r in range(rounds):
        state, met = a.run_round(at(state, r),
                                 r, perms=None if perms is None else perms[r])
        out["states"].append(_state_np(state))
        out["mets"].append({k: np.asarray(v) for k, v in met.items()})
        out["evals"].append({k: np.asarray(v) for k, v in
                             a.evaluate(at(state, r + 1)).items()})
    if finalize:
        fin, rec = a.finalize(at(state, rounds))
        out["final"] = {k: np.asarray(v) for k, v in rec.items()
                        if k not in ("round", "finetune")}
        out["final_personal"] = _np_tree(fin.personal_params)
    return out


def eval_terms_case(mesh, algo, data_seed, n_clients=8):
    """The per-client eval sums of the fresh global model on the mesh."""
    a = build_round_algo(algo, data_seed, 1.0, "dense", n_clients,
                         mesh=mesh)
    state = a.init_state()
    correct, loss_sum = a._eval_terms(
        range(a.num_clients), lambda c: state.global_params)
    return correct.numpy(), loss_sum.numpy()


# -- fused blocks on the mesh -------------------------------------------------

def _evals_np(ev):
    return {k: np.asarray(v) for k, v in ev.items()
            if not k.startswith("acc_per")}


def fused_case(mesh, algo, data_seed, frac, agg_impl, rounds=2, perms=None,
               params=None, mask=None, **build):
    """One fused block of ``rounds`` rounds with the eval every round on
    the mesh (``run_rounds_fused``) and the same rounds run eagerly on it
    from the same state, each round's eval after it. ``perms`` (per round,
    per selected client), ``params`` and ``mask`` are the seams. Returns
    both, with the fused block's state after its first round and the
    mask."""
    import dataclasses

    a = build_round_algo(algo, data_seed, frac, agg_impl, mesh=mesh, **build)
    if params is not None:
        params = {k: torch.from_numpy(np.asarray(v))
                  for k, v in params.items()}
    state = a.init_state(params=params)
    if mask is not None:
        state = dataclasses.replace(state, mask={
            k: torch.from_numpy(np.asarray(v)) for k, v in mask.items()})
    eager, mets, evals = a.clone_state(state), [], []
    for r in range(rounds):
        eager, met = a.run_round(eager, r, perms=None if perms is None
                                 else perms[r])
        mets.append({k: np.asarray(v) for k, v in met.items()})
        evals.append(_evals_np(a.evaluate(eager)))
    first = {}
    seams = None if perms is None else [{"perms": p} for p in perms]
    fused, ys = a.run_rounds_fused(
        state, 0, rounds, eval_every=1, seams=seams,
        on_first_round=lambda s: first.update(state=_state_np(s)))
    ys = ys.materialize()
    return dict(mask=_np_tree(getattr(state, "mask", None)),
                eager=_state_np(eager), mets=mets, evals=evals,
                fused=_state_np(fused), first=first["state"],
                ys={k: np.asarray(v) for k, v in ys.items() if k != "eval"},
                ys_eval={k: np.asarray(v) for k, v in ys["eval"].items()},
                graphs=len(a._fused.rounds), lo=a._lo, hi=a._hi)


def stratified_case(mesh, mode, data_seed=1, n_clients=2, dropout=0.0,
                    snip_idx=None, params=None):
    """The SNIP mask of stratified SNIP (``mode`` "exact" or "balanced")
    on the mesh: ``n_clients`` clients of 50 train rows, batch 8, the port's
    own draws or the ``snip_idx`` seam, from ``params`` where given."""
    a = build_stratified_algo(mode, data_seed, n_clients, dropout, mesh)
    kw = {}
    if params is not None:
        kw["params"] = {k: torch.from_numpy(np.asarray(v))
                        for k, v in params.items()}
    if snip_idx is not None:
        kw["snip_idx"] = snip_idx
    return _np_tree(a.init_state(**kw).mask)


def build_stratified_algo(mode, data_seed=1, n_clients=2, dropout=0.0,
                          mesh=None):
    """SalientGrads with stratified SNIP as the reference's stratified
    tests build it: ``n_clients`` even shards of 50 rows (8x8x8), batch 8,
    ``small3dcnn`` at ``dropout``, sharded over ``mesh`` when given."""
    import warnings

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.parallel.mesh import shard_federated

    data = make_synthetic_federated(
        seed=data_seed, n_clients=n_clients, samples_per_client=50,
        test_per_client=4, sample_shape=(8, 8, 8, 1), uneven=False)
    if mesh is not None:
        data = shard_federated(data, mesh)
    torch.manual_seed(0)
    model = create_model("small3dcnn", num_classes=1, dropout_rate=dropout)
    hp = HyperParams(lr=0.01, local_epochs=1, steps_per_epoch=7,
                     batch_size=8)
    with warnings.catch_warnings():
        # a fold with fewer members of a class than splits warns
        warnings.simplefilter("ignore")
        return SalientGrads(model, data, hp, loss_type="bce", frac=1.0,
                            seed=0, dense_ratio=0.5, device="cpu",
                            stratified_sampling=True, stratified_mode=mode)


def gloo_on_card_case(mesh):
    """The fused block of a gloo mesh whose algorithm stands on the card
    (its device set to CUDA after it was built on the CPU): the refusal's
    message, or None where nothing was refused."""
    a = build_round_algo("fedavg", 9, 1.0, "dense", mesh=mesh)
    state = a.init_state()
    a.device = torch.device("cuda")
    try:
        a.run_rounds_fused(state, 0, 2)
    except ValueError as e:
        return str(e)
    return None


# -- the robust tier on the mesh ----------------------------------------------

def robust_algo(case, mesh=None):
    """The algorithm of a robust case (a dict: ``algo``, ``impl``,
    ``data_seed``, ``frac``, ``seed``, ``spec``, ``robust``, ``defense``,
    and optionally ``guard``, ``opts`` (more options of the algorithm)
    and ``init``, the initial parameters and mask; see
    ``tests/test_torch_port_mesh_robust.py``), on the mesh when given."""
    kw = dict(seed=case["seed"], fault_spec=case["spec"],
              robust_agg=case["robust"], defense=case["defense"],
              mesh=mesh, **case.get("opts", {}))
    if "guard" in case:
        kw["guard"] = case["guard"]
    return build_round_algo(case["algo"], case["data_seed"], case["frac"],
                            case["impl"], **kw)


def _seam_round(seams, r):
    return {} if seams is None else dict(seams[r])


def robust_case(mesh, case, rounds=2, seams=None, fused=True):
    """A robust case on the mesh: ``rounds`` eager rounds from the initial
    state (the state before each and after the last, the metrics, the eval
    after each), and with ``fused`` the same rounds as one fused block from
    the same state; with ``case["finalize"]`` FedAvg's fine-tune of the
    eager end state. ``seams`` (per round, a dict of ``run_round``'s
    seams) replace the port's draws."""
    a = robust_algo(case, mesh)
    state = _robust_init(a, case)
    e, states, mets, evals = a.clone_state(state), [], [], []
    for r in range(rounds):
        states.append(_state_np(e))
        e, met = a.run_round(e, r, **_seam_round(seams, r))
        mets.append({k: np.asarray(v) for k, v in met.items()})
        evals.append(_evals_np(a.evaluate(e)))
    states.append(_state_np(e))
    out = dict(states=states, mets=mets, evals=evals,
               mask=_np_tree(getattr(state, "mask", None)), lo=a._lo,
               hi=a._hi)
    if fused:
        f, ys = a.run_rounds_fused(
            state, 0, rounds,
            seams=None if seams is None else [dict(x) for x in seams])
        out["fused"] = _state_np(f)
        out["ys"] = {k: np.asarray(v) for k, v in ys.materialize().items()}
    if case.get("finalize"):
        fin, rec = a.finalize(e)
        out["final"] = {k: np.asarray(v) for k, v in rec.items()
                        if k not in ("round", "finetune")}
        out["final_personal"] = _np_tree(fin.personal_params)
    return out


def _robust_init(a, case):
    """``a``'s initial state, from ``case["init"]`` (numpy ``params`` and
    ``mask``) where the case gives one."""
    import dataclasses

    init = case.get("init")
    if init is None:
        return a.init_state()
    state = a.init_state(params=_tensors(init["params"]))
    if init["mask"] is not None:
        state = dataclasses.replace(state, mask=_tensors(init["mask"]))
    return state


def replay_robust(case, ranks, rounds=2, seams=None):
    """The mesh run ``ranks`` (every rank's :func:`robust_case`) replayed
    off the mesh, each round from the mesh's state before it: per round
    the trained state, the metrics and the eval of the mesh's state after
    it; with ``case["finalize"]`` the fine-tune of the mesh's end state."""
    a = robust_algo(case)
    state = a.init_state()
    out = dict(mask=_np_tree(getattr(state, "mask", None)), states=[],
               mets=[], evals=[])
    for r in range(rounds):
        state, met = a.run_round(_at(state, ranks, r), r,
                                 **_seam_round(seams, r))
        out["states"].append(_state_np(state))
        out["mets"].append({k: np.asarray(v) for k, v in met.items()})
        out["evals"].append(_evals_np(a.evaluate(_at(state, ranks,
                                                     r + 1))))
    if case.get("finalize"):
        fin, rec = a.finalize(_at(state, ranks, rounds))
        out["final"] = {k: np.asarray(v) for k, v in rec.items()
                        if k not in ("round", "finetune")}
        out["final_personal"] = _np_tree(fin.personal_params)
    return out


def _tensors(t):
    return None if t is None else {k: torch.from_numpy(np.asarray(v))
                                   for k, v in t.items()}


def _at(state, ranks, key):
    """``state`` with the mesh's state ``key`` (the ranks' blocks of the
    row fields joined)."""
    import dataclasses

    return dataclasses.replace(
        state,
        global_params=_tensors(ranks[0]["states"][key]["global_params"]),
        personal_params=_tensors(_whole(ranks, key, "personal")),
        agg_residual=_tensors(_whole(ranks, key, "residual")),
        eval_cache=_tensors(ranks[0]["states"][key]["eval_cache"]))


def clean_guard_case(mesh, case):
    """One round of ``case`` with the guard on and no fault, and one with
    the guard off, from the same state, on the mesh."""
    out = {}
    for guard in (True, False):
        a = robust_algo(dict(case, spec="", guard=guard), mesh)
        state, met = a.run_round(a.init_state(), 0)
        out[guard] = dict(state=_state_np(state),
                          mets={k: np.asarray(v) for k, v in met.items()})
    return out


# -- checkpoints on the mesh -----------------------------------------------------

def _ckpt(directory, algo=None):
    from neuroimagedisttraining_torch.utils.checkpoint import \
        CheckpointManager

    return CheckpointManager(directory, "run", max_to_keep=8, layout=algo)


def ckpt_run_case(mesh, case, directory, rounds=4, save_after=2,
                  loop="eager"):
    """``rounds`` rounds of ``case`` (under ``loop`` "fused" in blocks of
    ``save_after`` rounds) with a checkpoint after round ``save_after``
    into ``directory``, and the same run resumed: a fresh algorithm
    restores that step and runs the rest. Returns the uninterrupted run's
    state at the step and at the end, and the resumed run's restored and
    end states (this rank's rows)."""
    a = robust_algo(case, mesh)
    mgr = _ckpt(directory, a)
    state = a.init_state()
    saved = None
    step = range(rounds) if loop == "eager" else range(0, rounds,
                                                        save_after)
    for r in step:
        if loop == "eager":
            state, _ = a.run_round(state, r)
            done = r + 1
        else:
            state, _ = a.run_rounds_fused(state, r, save_after)
            done = r + save_after
        if done == save_after:
            mgr.save(done, state)
            saved = _state_np(state)
    a.release_graphs()
    out = dict(saved=saved, end=_state_np(state), lo=a._lo, hi=a._hi)
    b = robust_algo(case, mesh)
    out["resumed"] = _resume(b, _ckpt(directory, b), save_after, rounds,
                             loop)
    return out


def _resume(a, mgr, step, rounds, loop="eager"):
    """Restore the lineage's newest step, ``step``, with ``a`` and run
    the rounds after it; returns the restored and the end state (numpy,
    this rank's rows)."""
    state, got = mgr.restore_latest(a.init_state())
    assert got == step, (got, step)
    restored = _state_np(state)
    if loop == "eager":
        for r in range(step, rounds):
            state, _ = a.run_round(state, r)
    else:
        state, _ = a.run_rounds_fused(state, step, rounds - step)
        a.release_graphs()
    return dict(restored=restored, end=_state_np(state), lo=a._lo,
                hi=a._hi)


def ckpt_resume_case(mesh, case, directory, step, rounds):
    """Resume ``directory``'s step ``step`` (written at any mesh width) on
    this mesh and run the rounds after it."""
    a = robust_algo(case, mesh)
    return _resume(a, _ckpt(directory, a), step, rounds)


def watchdog_case(mesh, case, directory, rounds=3, max_retries=2,
                  flip_rank=1):
    """The runner's round loop under the watchdog on the mesh, every
    adopted round saved, and every rollback through the checkpoint
    (``rollback(None)``: the in-memory state treated as lost). On rank
    ``flip_rank`` the local health check is inverted, so any verdict that
    is not rank 0's would show. Returns per attempt ``(round, verdict,
    restored state equals the last saved one)``, the counters and the end
    state."""
    import dataclasses

    from neuroimagedisttraining_torch.robust import recovery

    a = robust_algo(case, mesh)
    mgr = _ckpt(directory, a)
    retries = 0 if a.clients_per_round == a.num_clients else max_retries
    wd = recovery.RoundWatchdog(max_retries=retries, norm_threshold=1e6,
                                ckpt_mgr=mgr, template_fn=a.init_state,
                                mesh=mesh)
    if mesh.rank == flip_rank:
        healthy = wd.healthy
        wd.healthy = lambda *args: not healthy(*args)
    state = a.init_state()
    mgr.save(0, state)
    log, r = [], 0
    while r < rounds:
        a.set_retry_nonce(wd.retries_at(r))
        new, met = a.run_round(state, r)
        verdict = wd.judge(r, {"train_loss": met["train_loss"]}, new, state)
        if verdict == recovery.OK:
            state = new
            mgr.save(r + 1, state)
            log.append((r, verdict, None))
            r += 1
            continue
        restored = wd.rollback(None)
        same = all(
            torch.equal(x[k], y[k])
            for f in ("global_params", "personal_params", "agg_residual")
            for x, y in [(getattr(restored, f), getattr(state, f))]
            if x is not None for k in x) and torch.equal(
                restored.generator.get_state(), state.generator.get_state())
        log.append((r, verdict, same))
        state = dataclasses.replace(restored)
        if verdict == recovery.SKIP:
            mgr.save(r + 1, state)
            r += 1
    a.set_retry_nonce(0)
    return dict(log=log, totals=wd.totals(), end=_state_np(state))


def save_failure_case(mesh, case, directory, rounds=2):
    """A save that raises on rank 0 (its first write): every rank goes on,
    rank 0 counts the failure, the next save lands. Returns also how often
    each rank wrote (rank 0 alone writes)."""
    a = robust_algo(case, mesh)
    mgr = _ckpt(directory, a)
    write, calls = mgr._write, []

    def failing(*args, **kw):
        calls.append(1)
        if mesh.rank == 0 and len(calls) == 1:
            raise OSError("disk full")
        return write(*args, **kw)

    mgr._write = failing
    state = a.init_state()
    done = []
    for r in range(rounds):
        state, _ = a.run_round(state, r)
        done.append(mgr.save(r + 1, state))
    return dict(failures=mgr.save_failures, done=done,
                steps=mgr.all_steps(), writes=len(calls))


# -- the other seven algorithms on the mesh ----------------------------------

#: the personal cases' algorithm classes, by CLI name
_PERSONAL_CLASSES = {"local": "LocalOnly", "ditto": "Ditto",
                     "subavg": "SubAvg", "dpsgd": "DPSGD",
                     "dispfl": "DisPFL", "fedfomo": "FedFomo",
                     "turboaggregate": "TurboAggregate"}


def personal_cohort(case):
    """The cohort of a personal case (a dict: ``algo``, ``data_seed``,
    ``frac``, and optionally ``epochs``, ``personal_epochs``, ``val``,
    ``opts``; see ``tests/test_torch_port_mesh_personal.py``): 8 synthetic
    clients of 8 train and 4 test rows (``val`` validation rows), 8x8x8
    volumes, and the step count of a batch of 4."""
    from neuroimagedisttraining_torch.data import make_synthetic_federated

    data = make_synthetic_federated(
        seed=case["data_seed"], n_clients=8, samples_per_client=8,
        test_per_client=4, val_per_client=case.get("val", 0),
        sample_shape=(8, 8, 8, 1))
    return data, -(-int(np.max(np.asarray(data.n_train))) // 4)


def build_personal_algo(case, mesh=None):
    """The algorithm of a personal case on ``small3dcnn`` (no dropout), run
    seed 0, its data sharded over ``mesh`` when given: the round tests'
    hyperparameters at ``case["epochs"]`` local epochs (Ditto's personal
    leg at ``case["personal_epochs"]``)."""
    import dataclasses

    from neuroimagedisttraining_torch import algorithms
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.parallel.mesh import shard_federated

    data, spe = personal_cohort(case)
    if mesh is not None:
        data = shard_federated(data, mesh)
    hp = HyperParams(lr=0.01, lr_decay=0.998, momentum=0.9,
                     weight_decay=5e-4, grad_clip=10.0,
                     local_epochs=case.get("epochs", 1), steps_per_epoch=spe,
                     batch_size=4)
    torch.manual_seed(0)
    model = create_model("small3dcnn", num_classes=1, dropout_rate=0.0)
    kw = dict(case.get("opts", {}))
    if case["algo"] == "ditto" and case.get("personal_epochs"):
        kw["personal_hp"] = dataclasses.replace(
            hp, local_epochs=case["personal_epochs"])
    cls = getattr(algorithms, _PERSONAL_CLASSES[case["algo"]])
    return cls(model, data, hp, loss_type="bce", frac=case["frac"], seed=0,
               device="cpu", **kw)


def _np_fields(state):
    """Every tensor field of a state (a tree or a tensor) as numpy, by
    field name; the generator left out."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, dict):
            out[f.name] = _np_tree(v)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().numpy()
    return out


def _personal_init(a, init):
    """``a``'s initial state, from ``init`` (numpy ``params`` and, for
    DisPFL, the whole ``[C, ...]`` ``masks``) where given."""
    if init is None:
        return a.init_state()
    kw = dict(params=_tensors(init["params"]))
    if init.get("masks") is not None:
        kw["masks"] = _tensors(init["masks"])
    return a.init_state(**kw)


def personal_case(mesh, case, rounds=2, seams=None, init=None, fused=False,
                  record=False):
    """A personal case on the mesh: ``rounds`` eager rounds from the
    initial state (``init``, or the algorithm's own): the state before each
    and after the last, the metrics, the eval after each. ``seams`` (per
    round, a dict of ``run_round``'s seams) replace the port's draws. With
    ``fused`` the same rounds as one fused block from the same state (the
    eval every round). With ``record`` (FedFomo) each round's validation
    losses in call order and the trained rows of the rank's clients."""
    a = build_personal_algo(case, mesh)
    state = _personal_init(a, init)
    vals, trained = [], []
    if record:
        val_loss, train_stacked = a._val_loss, a._train_stacked

        def record_loss(params, i):
            out = val_loss(params, i)
            vals[-1].append(float(out))
            return out

        def record_trained(*args, **kw):
            out = train_stacked(*args, **kw)
            trained.append(_np_tree(out[0]))
            return out

        a._val_loss, a._train_stacked = record_loss, record_trained
    e, states, mets, evals = a.clone_state(state), [], [], []
    for r in range(rounds):
        states.append(_np_fields(e))
        vals.append([])
        e, met = a.run_round(e, r, **_seam_round(seams, r))
        mets.append({k: np.asarray(v) for k, v in met.items()})
        evals.append(_evals_np(a.evaluate(e)))
    states.append(_np_fields(e))
    out = dict(states=states, mets=mets, evals=evals, lo=a._lo, hi=a._hi)
    if record:
        out.update(vals=vals, trained=trained)
    if fused:
        f, ys = a.run_rounds_fused(
            state, 0, rounds, eval_every=1,
            seams=None if seams is None else [dict(x) for x in seams])
        ys = ys.materialize()
        out["fused"] = _np_fields(f)
        out["ys"] = {k: np.asarray(v) for k, v in ys.items() if k != "eval"}
        out["ys_eval"] = {k: np.asarray(v) for k, v in ys["eval"].items()}
    return out


def _join_fields(algo, ranks, key):
    """The mesh's state ``key`` in the single-process layout: the ranks'
    blocks of each row field joined, the replicated fields rank 0's."""
    out = dict(ranks[0]["states"][key])
    for f in algo.row_fields:
        if out.get(f) is None:
            continue
        blocks = [r["states"][key][f] for r in ranks]
        out[f] = ({k: np.concatenate([b[k] for b in blocks])
                   for k in blocks[0]} if isinstance(blocks[0], dict)
                  else np.concatenate(blocks))
    return out


def _personal_at(state, fields):
    """``state`` with every tensor field from ``fields`` (numpy)."""
    import dataclasses

    return dataclasses.replace(state, **{
        f: (_tensors(v) if isinstance(v, dict) else torch.from_numpy(v))
        for f, v in fields.items()})


def replay_personal(case, ranks, rounds=2, seams=None, init=None):
    """The mesh run ``ranks`` (every rank's :func:`personal_case`)
    replayed off the mesh, each round from the mesh's state before it (the
    generator in step): per round the trained state (single-process
    layout), the metrics and the eval of the mesh's state after it."""
    a = build_personal_algo(case)
    state = _personal_init(a, init)
    out = dict(states=[], mets=[], evals=[], row_fields=a.row_fields)
    for r in range(rounds):
        state, met = a.run_round(
            _personal_at(state, _join_fields(a, ranks, r)), r,
            **_seam_round(seams, r))
        out["states"].append(_np_fields(state))
        out["mets"].append({k: np.asarray(v) for k, v in met.items()})
        out["evals"].append(_evals_np(a.evaluate(_personal_at(
            state, _join_fields(a, ranks, r + 1)))))
    return out


def personal_ckpt_case(mesh, case, directory, rounds=4, save_after=2):
    """``save_after`` rounds of a personal case with a checkpoint into
    ``directory`` (every rank saving, rank 0 writing), then the rest of
    ``rounds``: this rank's rows at the step and at the end."""
    a = build_personal_algo(case, mesh)
    mgr = _ckpt(directory, a)
    state = a.init_state()
    saved = None
    for r in range(rounds):
        state, _ = a.run_round(state, r)
        if r + 1 == save_after:
            mgr.save(save_after, state)
            saved = _np_fields(state)
    return dict(saved=saved, end=_np_fields(state), lo=a._lo, hi=a._hi)


def personal_resume_case(mesh, case, directory, step, rounds=4):
    """Resume ``directory``'s step ``step`` (written at any mesh width) on
    this mesh (or off it, ``mesh`` None) and run the rounds after it: the
    restored and the end state (this rank's rows)."""
    a = build_personal_algo(case, mesh)
    state, got = _ckpt(directory, a if mesh is not None else None) \
        .restore_latest(a.init_state())
    assert got == step, (got, step)
    restored = _np_fields(state)
    for r in range(step, rounds):
        state, _ = a.run_round(state, r)
    return dict(restored=restored, end=_np_fields(state), lo=a._lo,
                hi=a._hi)


# -- the client store on the mesh ---------------------------------------------

def store_algo(case, mesh=None, root=None):
    """The algorithm of a store case (a dict: ``algo`` "salientgrads",
    "fedavg" or "ditto", ``mode`` "host" or "disk", ``impl``, and
    optionally ``spec`` (the fault spec; the guard follows it), ``robust``
    (``robust_agg``), ``opts`` (more options); see ``tests/
    test_torch_port_mesh_store.py``): 8 clients of data seed 4 at ``frac``
    0.5 with a store of 2 hot rows (a disk store's files under ``root``),
    the mesh's data kept on the host as the runner keeps it. With
    ``case["model"]`` (the cross-framework case: ``model``, ``widths``,
    ``sample_shape``, ``n_clients``, ``samples``, ``test``, ``batch``) the
    narrow phased ``3dcnn_s2d`` on that cohort instead."""
    import dataclasses

    from neuroimagedisttraining_torch.algorithms import (
        Ditto,
        FedAvg,
        SalientGrads,
    )
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.parallel.mesh import shard_federated

    big = case.get("model") is not None
    shape = tuple(case.get("sample_shape", (8, 8, 8, 1)))
    data = make_synthetic_federated(
        seed=case.get("data_seed", 4), n_clients=case.get("n_clients", 8),
        samples_per_client=case.get("samples", 8),
        test_per_client=case.get("test", 4), sample_shape=shape,
        uneven=True)
    if mesh is not None:
        data = shard_federated(data, mesh, host=True)
    batch = case.get("batch", 4)
    spe = -(-int(np.max(np.asarray(data.n_train))) // batch)
    hp = HyperParams(lr=0.01, lr_decay=0.998, momentum=0.9,
                     weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                     steps_per_epoch=spe, batch_size=batch)
    torch.manual_seed(0)
    if big:
        model = create_model(case["model"], num_classes=1,
                             widths=tuple(case["widths"]), dropout_rate=0.0,
                             sample_shape=shape)
    else:
        model = create_model("small3dcnn", num_classes=1, dropout_rate=0.0)
    kw = dict(loss_type="bce", frac=case.get("frac", 0.5), seed=0,
              agg_impl=case.get("impl", "dense"), device="cpu",
              client_store=case["mode"], store_hot_clients=2,
              store_dir=root, fault_spec=case.get("spec", ""),
              robust_agg=case.get("robust", "none"), **case.get("opts", {}))
    if case["algo"] == "salientgrads":
        return SalientGrads(model, data, hp, dense_ratio=0.5, **kw)
    if case["algo"] == "ditto":
        return Ditto(model, data, hp, lamda=0.5,
                     personal_hp=dataclasses.replace(hp, local_epochs=2),
                     **kw)
    return FedAvg(model, data, hp, **kw)


def store_rows(a):
    """The rows a store holds (this rank's block), flushed, by field
    (numpy)."""
    a.store_flush()
    return {f: _np_tree(a._store.gather_all(f))
            for f in a._store.field_names()}


def _store_state_np(state):
    """The replicated fields of a store-backed state (numpy): the row
    fields are the store's."""
    return dict(global_params=_np_tree(state.global_params),
                mask=_np_tree(getattr(state, "mask", None)),
                eval_cache=_np_tree(getattr(state, "eval_cache", None)))


def _store_init(a, init):
    """``a``'s initial state, from ``init`` (numpy ``params`` and
    ``mask``) where given."""
    import dataclasses

    if init is None:
        return a.init_state()
    state = a.init_state(params=_tensors(init["params"]))
    if init.get("mask") is not None:
        state = dataclasses.replace(state, mask=_tensors(init["mask"]))
    return state


def store_case(mesh, case, root, rounds=4, block=2, seams=None, init=None,
               fused=True, finalize=False):
    """A store case on the mesh: ``rounds`` eager streamed rounds (the
    state, the rank's stored rows before each and after the last, the
    metrics, the eval after each, the store's counters), and with
    ``fused`` the same rounds as fused blocks of ``block`` from the same
    initial state on a second algorithm (a store of its own): its state
    and rows after each block and its metrics. ``seams`` (per round, a
    dict of ``run_round``'s seams) and ``init`` replace the port's draws;
    with ``finalize`` FedAvg's fine-tune of the eager end state."""
    a = store_algo(case, mesh, os.path.join(root, "eager"))
    state = _store_init(a, init)
    states, rows, mets, evals = [], [], [], []
    for r in range(rounds):
        states.append(_store_state_np(state))
        rows.append(store_rows(a))
        state, met = a.run_round(state, r, **_seam_round(seams, r))
        mets.append({k: np.asarray(v) for k, v in met.items()})
        evals.append(_evals_np(a.evaluate(state)))
    states.append(_store_state_np(state))
    rows.append(store_rows(a))
    out = dict(states=states, rows=rows, mets=mets, evals=evals,
               lo=a._lo, hi=a._hi, stats=a._store.stats())
    if finalize:
        fin, rec = a.finalize(state)
        out["final"] = {k: np.asarray(v) for k, v in rec.items()
                        if k not in ("round", "finetune")}
        out["final_rows"] = store_rows(a)
    if fused:
        b = store_algo(case, mesh, os.path.join(root, "fused"))
        f = _store_init(b, init)
        out["fused"], out["fused_rows"], out["ys"] = [], [], []
        for r0 in range(0, rounds, block):
            f, ys = b.run_rounds_fused(
                f, r0, block, seams=None if seams is None
                else [dict(x) for x in seams[r0:r0 + block]])
            out["fused"].append(_store_state_np(f))
            out["fused_rows"].append(store_rows(b))
            out["ys"].append({k: np.asarray(v)
                              for k, v in ys.materialize().items()})
        out["fused_eval"] = _evals_np(b.evaluate(f))
        out["graphs"] = len(b._fused.rounds)
        out["width"] = b._fused.width
    return out


def _whole_rows(ranks, key=None, which="rows"):
    """The ranks' stored rows (``r[which]``, or ``r[which][key]``) joined
    in client order, by field."""
    def rows(r):
        return r[which] if key is None else r[which][key]

    out = {}
    for f in rows(ranks[0]):
        blocks = [rows(r)[f] for r in ranks]
        out[f] = {k: np.concatenate([b[k] for b in blocks])
                  for k in blocks[0]}
    return out


def load_store_rows(a, rows):
    """``a``'s store (one process) set to ``rows`` (every client's, by
    field) and its store eval's terms dropped (the next eval is a full
    pass)."""
    n = a.num_clients
    for f, tree in rows.items():
        a._store.stage(f, np.arange(n), _tensors(tree))
    a._store.commit()
    a._store_eval_cache, a._store_eval_dirty = None, []


def replay_store(case, ranks, root, rounds=4, seams=None, init=None,
                 finalize=False):
    """The mesh run ``ranks`` (every rank's :func:`store_case`) replayed by
    one process with a store: each round from the mesh's state before it
    (its replicated fields, and every client's stored rows loaded into the
    store; the generator in step), the rows the round leaves, its metrics
    and the eval of the mesh's state after it; with ``finalize`` the
    fine-tune of the mesh's end state."""
    import dataclasses

    a = store_algo(case, None, root)
    state = _store_init(a, init)

    def at(state, key):
        load_store_rows(a, _whole_rows(ranks, key))
        st = ranks[0]["states"][key]
        return dataclasses.replace(state, **{
            f: _tensors(v) for f, v in st.items() if v is not None})

    out = dict(rows=[], mets=[], evals=[], states=[])
    for r in range(rounds):
        state, met = a.run_round(at(state, r), r, **_seam_round(seams, r))
        out["states"].append(_store_state_np(state))
        out["rows"].append(store_rows(a))
        out["mets"].append({k: np.asarray(v) for k, v in met.items()})
        out["evals"].append(_evals_np(a.evaluate(at(state, r + 1))))
    if finalize:
        fin, rec = a.finalize(at(state, rounds))
        out["final"] = {k: np.asarray(v) for k, v in rec.items()
                        if k not in ("round", "finetune")}
        out["final_rows"] = store_rows(a)
    return out


def _store_resume(a, mgr, step, rounds):
    """Restore the lineage's newest step, ``step``, into ``a`` (its store
    included) and run the eager rounds after it: the restored and the end
    state and rows (this rank's block) and the rounds' metrics."""
    state, got = mgr.restore_latest(a.init_state(), store=a._store)
    assert got == step, (got, step)
    out = dict(restored=_store_state_np(state), restored_rows=store_rows(a),
               mets=[], lo=a._lo, hi=a._hi)
    for r in range(step, rounds):
        state, met = a.run_round(state, r)
        out["mets"].append({k: np.asarray(v) for k, v in met.items()})
    out.update(end=_store_state_np(state), end_rows=store_rows(a))
    return out


def store_ckpt_case(mesh, case, root, directory, loop="eager", resume=True):
    """A store-backed lineage in ``directory``: eager, 2 rounds with a step
    after round 0; fused, 4 rounds in blocks of 2 with a step after the
    first block (every rank saves, rank 0 writes the state and the store's
    sidecar). The state and this rank's stored rows at the step and at the
    end, the metrics of each round, and with ``resume`` the same lineage
    resumed by a fresh algorithm (a store of its own) at the same width
    (:func:`_store_resume`; the rounds after the step eager)."""
    a = store_algo(case, mesh, os.path.join(root, "run"))
    mgr = _ckpt(directory, a)
    state = a.init_state()
    rounds, step = (2, 1) if loop == "eager" else (4, 2)
    out = dict(mets=[], lo=a._lo, hi=a._hi)
    done = 0
    while done < rounds:
        if loop == "eager":
            state, met = a.run_round(state, done)
            out["mets"].append({k: np.asarray(v) for k, v in met.items()})
            done += 1
        else:
            state, ys = a.run_rounds_fused(state, done, step)
            ys = ys.materialize()
            out["mets"] += [{k: np.asarray(v[i]) for k, v in ys.items()}
                            for i in range(step)]
            done += step
        if done == step:
            mgr.save(step, state, store=a._store)
            out.update(saved=_store_state_np(state), saved_rows=store_rows(a))
    a.release_graphs()
    out.update(end=_store_state_np(state), end_rows=store_rows(a))
    if resume:
        b = store_algo(case, mesh, os.path.join(root, "resumed"))
        out["resumed"] = _store_resume(b, _ckpt(directory, b), step, rounds)
    return out


def store_resume_case(mesh, case, root, directory, step, rounds=2):
    """Resume ``directory``'s store-backed step ``step`` (written at any
    width) on this mesh (or off it, ``mesh`` None) and run the rounds after
    it (:func:`_store_resume`)."""
    a = store_algo(case, mesh, root)
    return _store_resume(a, _ckpt(directory, a if mesh is not None
                                  else None), step, rounds)


def store_watchdog_case(mesh, case, root, directory, rounds=3,
                        max_retries=2, flip_rank=1):
    """The runner's round loop under the watchdog with a store on the
    mesh: every adopted round saved with the store's sidecar, and on a
    rollback every rank discards its staged rows and restores the last
    step through the checkpoint (``rollback(None)``), the store's block
    reloaded from the sidecar. Rank ``flip_rank``'s local health check is
    inverted, so a verdict that is not rank 0's would show. Returns per
    attempt ``(round, verdict, restored state and rows equal the last
    saved ones)``, the counters and the end state."""
    import dataclasses

    from neuroimagedisttraining_torch.robust import recovery

    a = store_algo(case, mesh, root)
    mgr = _ckpt(directory, a)
    wd = recovery.RoundWatchdog(max_retries=max_retries, norm_threshold=1e6,
                                ckpt_mgr=mgr, template_fn=a.init_state,
                                store=a._store, mesh=mesh)
    if mesh is not None and mesh.rank == flip_rank:
        healthy = wd.healthy
        wd.healthy = lambda *args: not healthy(*args)
    state = a.init_state()
    mgr.save(0, state, store=a._store)
    saved, saved_rows = _store_state_np(state), store_rows(a)
    log, r = [], 0
    while r < rounds:
        a.set_retry_nonce(wd.retries_at(r))
        new, met = a.run_round(state, r)
        verdict = wd.judge(r, {"train_loss": met["train_loss"]}, new, state)
        if verdict == recovery.OK:
            state = new
            mgr.save(r + 1, state, store=a._store)
            saved, saved_rows = _store_state_np(state), store_rows(a)
            log.append((r, verdict, None))
            r += 1
            continue
        a.store_discard()  # the attempt's staged rows, on every rank
        restored = wd.rollback(None)
        same = _eq_np(_store_state_np(restored), saved) and \
            _eq_np(store_rows(a), saved_rows) and torch.equal(
                restored.generator.get_state(), state.generator.get_state())
        log.append((r, verdict, same))
        state = dataclasses.replace(restored)
        if verdict == recovery.SKIP:
            mgr.save(r + 1, state, store=a._store)
            saved, saved_rows = _store_state_np(state), store_rows(a)
            r += 1
    a.set_retry_nonce(0)
    return dict(log=log, totals=wd.totals(), end=_store_state_np(state))


def _eq_np(a, b):
    """Bitwise equal numpy arrays, or dicts of them (nested; None alike)."""
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(
            _eq_np(a[k], b[k]) for k in b)
    if b is None:
        return a is None
    return np.array_equal(a, b)


# -- the image side: an augmented round ----------------------------------------

def build_image_algo(algo="salientgrads", mesh=None, n_clients=4, samples=8,
                     seed=3):
    """SalientGrads (or FedAvg) on ``cnn_cifar10`` over ``n_clients``
    CIFAR-shaped clients of ``samples`` numpy-seeded images (4 test), 10
    classes, CE, batch 4, CIFAR-10's black pad value (so every training and
    SNIP batch is cropped and flipped), sharded over ``mesh`` when given."""
    from neuroimagedisttraining_torch.algorithms import FedAvg, SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data.cifar import (
        CIFAR10_MEAN,
        CIFAR10_STD,
        black_pad_value,
    )
    from neuroimagedisttraining_torch.data.types import FederatedData
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.parallel.mesh import shard_federated

    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    data = FederatedData(
        x_train=t(rng.randn(n_clients, samples, 32, 32, 3).astype(np.float32)),
        y_train=t(rng.randint(0, 10, (n_clients, samples)).astype(np.int32)),
        n_train=t(np.full(n_clients, samples, np.int32)),
        x_test=t(rng.randn(n_clients, 4, 32, 32, 3).astype(np.float32)),
        y_test=t(rng.randint(0, 10, (n_clients, 4)).astype(np.int32)),
        n_test=t(np.full(n_clients, 4, np.int32)), class_num=10,
        aug_pad_value=black_pad_value(CIFAR10_MEAN, CIFAR10_STD))
    if mesh is not None:
        data = shard_federated(data, mesh)
    hp = HyperParams(lr=0.01, lr_decay=0.998, momentum=0.9,
                     weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                     steps_per_epoch=samples // 4, batch_size=4)
    torch.manual_seed(0)
    model = create_model("cnn_cifar10", num_classes=10)
    kw = dict(loss_type="ce", frac=1.0, seed=0, device="cpu")
    if algo == "salientgrads":
        return SalientGrads(model, data, hp, dense_ratio=0.5, **kw)
    return FedAvg(model, data, hp, **kw)


def image_round_case(mesh, algo="salientgrads", rounds=2):
    """:func:`build_image_algo` on the mesh: SNIP, ``rounds`` rounds and
    the eval after each (:func:`drive_round`)."""
    return drive_round(build_image_algo(algo, mesh=mesh), rounds)
