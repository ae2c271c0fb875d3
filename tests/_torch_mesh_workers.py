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
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp


def run_ranks(world, cases, timeout_dir=None):
    """Run ``cases`` (a list of ``(name, kwargs)``) on a ``world``-rank gloo
    group of CPU processes. Returns ``results[case][rank]``; a rank that
    raised re-raises here with its traceback."""
    with tempfile.TemporaryDirectory(dir=timeout_dir) as d:
        with open(os.path.join(d, "cases.pkl"), "wb") as f:
            pickle.dump(cases, f)
        mp.spawn(_rank_main, args=(world, d), nprocs=world, join=True)
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


def _rank_main(rank, world, d):
    from neuroimagedisttraining_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(world, backend="gloo", rank=rank, device="cpu",
                     init_method="file://" + os.path.join(d, "rendezvous"))
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
                     hier_wire="bf16", dropout=0.0, mesh=None):
    """The round tests' algorithm: ``n_clients`` synthetic clients of data
    seed ``data_seed`` (8 train rows, 4 test), batch 4, ``small3dcnn`` at
    ``dropout``, sharded over ``mesh`` when given."""
    from neuroimagedisttraining_torch.algorithms import FedAvg, SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.parallel.mesh import shard_federated

    data = make_synthetic_federated(seed=data_seed, n_clients=n_clients,
                                    samples_per_client=8, test_per_client=4,
                                    sample_shape=tuple(sample_shape))
    if mesh is not None:
        data = shard_federated(data, mesh)
    spe = -(-int(np.max(np.asarray(data.n_train))) // 4)
    hp = HyperParams(lr=0.01, lr_decay=0.998, momentum=0.9,
                     weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                     steps_per_epoch=spe, batch_size=4)
    torch.manual_seed(0)
    model = create_model("small3dcnn", num_classes=1, dropout_rate=dropout)
    kw = dict(loss_type="bce", frac=frac, seed=0, agg_impl=agg_impl,
              agg_bucket_size=bucket_size, agg_hier_inner=hier_inner,
              agg_hier_wire=hier_wire, device="cpu")
    if algo == "salientgrads":
        return SalientGrads(model, data, hp, dense_ratio=0.5, **kw)
    return FedAvg(model, data, hp, **kw)


def _np_tree(t):
    return None if t is None else {k: v.detach().numpy() for k, v in t.items()}


def _state_np(state):
    return dict(global_params=_np_tree(state.global_params),
                personal=_np_tree(state.personal_params),
                residual=_np_tree(state.agg_residual))


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
            agg_residual=tensors(_whole(ranks, key, "residual")))

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
