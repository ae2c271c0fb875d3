"""Fused round blocks, the eval cache and subset, and stratified SNIP on the
port's client mesh, on the CPU: gloo ranks (``tests/_torch_mesh_workers.py``)
at D = 2 and one D = 4 set, ``small3dcnn``, 8 clients (data seed 4 for
SalientGrads, 9 for FedAvg, as ``tests/test_torch_port_mesh_round.py``).

* A fused mesh block (``run_rounds_fused``, the eval every round) is
  bitwise the same rounds run eagerly on the mesh: state, train losses and
  evals, on the dense, bf16 and int8 wires, at ``frac`` 1.0 and 0.5, with
  the eval cache and the eval subset.
* Against the port's single-process fused block from the same state: the
  mask, the first round's trained models, loss, eval cache and personal
  eval bitwise; the global model within 1e-6 of its scale after the first
  round (bf16 1e-2, int8 5e-2), where the cross-rank sum reassociates; a
  selection that does not divide over the mesh (every rank reducing all
  rows off it) bitwise throughout.
* Against the JAX package's ``run_rounds_fused`` on its own mesh, fed its
  parameters, mask and epoch permutations: rtol 1e-5, atol 2e-7 after two
  rounds.
* ``eval_cache`` and ``eval_clients`` on the mesh: each round replayed off
  the mesh from the mesh's state before it (``replay_off_mesh``), the eval
  and the cache bitwise.
* Stratified SNIP ("exact" and "balanced") on the mesh: the mask bitwise
  the single-process port's on its own draws (dropout on, so the ranks make
  the other clients' dropout draws too), and on the reference's draws
  within the tolerances ``tests/test_torch_port_train_opts.py`` holds the
  single-process mask to the JAX mask.
* ``bench_torch.py``'s per-rank body over two gloo ranks at a narrow width,
  and a gloo mesh on the card refused by ``run_rounds_fused``.
* A rank that raises in a fused mesh run, through the CLI and through
  ``bench_torch.py``: it releases its graphs before its mesh is torn down,
  and the run ends with the rank's error within its time limit.

Each spawn of ranks has its own time limit (``SPAWN_TIMEOUT_S``).
"""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_mesh_workers as mw  # noqa: E402
import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import FedAvg as JFedAvg  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import SalientGrads as JSalientGrads  # noqa: E402
from neuroimagedisttraining_tpu.algorithms.base import \
    sample_client_indexes as jsample  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.data import make_synthetic_federated as jsynth  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_tpu.ops import sparsity as jsp  # noqa: E402
from neuroimagedisttraining_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from neuroimagedisttraining_tpu.parallel.mesh import shard_federated_hybrid  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.ops import sparsity as tsp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 2
SEEDS = {"salientgrads": 4, "fedavg": 9}
#: a spawn of ranks that runs longer fails
SPAWN_TIMEOUT_S = 240
#: (mesh width, algorithm, frac, agg_impl, build options): a fused mesh
#: block against the eager mesh rounds and the single-process fused block
FUSED = [
    (2, "salientgrads", 1.0, "dense", {}),
    (2, "salientgrads", 1.0, "bf16", {}),
    (2, "salientgrads", 1.0, "int8", {}),
    (2, "salientgrads", 0.5, "dense", {}),
    # partial participation: the on-mesh int8 uniforms, the other
    # clients' dropout draws
    (2, "salientgrads", 0.5, "int8", {"dropout": 0.5}),
    (2, "fedavg", 0.5, "bf16", {}),
    # S = 3 does not divide over 2 ranks: every rank reduces all rows
    (2, "fedavg", 0.375, "dense", {}),
    (2, "fedavg", 1.0, "dense", {"eval_cache": True}),
    (2, "fedavg", 0.5, "int8", {"eval_cache": True}),
    (2, "salientgrads", 0.5, "topk", {"eval_clients": 5}),
    (4, "salientgrads", 0.5, "int8", {}),
    (4, "fedavg", 1.0, "bf16", {"eval_cache": True}),
]
#: (algorithm, frac, agg_impl, build options) whose eager mesh rounds are
#: replayed off the mesh, the eval and the cache held bitwise (D = 2)
EVAL = [
    ("salientgrads", 1.0, "dense", {"eval_cache": True}),
    ("fedavg", 0.5, "dense", {"eval_cache": True}),
    ("salientgrads", 1.0, "dense", {"eval_clients": 5}),
    ("fedavg", 0.5, "int8", {"eval_clients": 5}),
]
#: per mesh width, the (algorithm, frac) held against the JAX package's
#: fused rounds on its mesh
JAX = {2: ("salientgrads", 1.0), 4: ("fedavg", 0.5)}
STRATIFIED = ("exact", "balanced")
#: the global model's bound against the single-process block after the
#: first round, of the tree's largest value, by wire
LOW_PRECISION = {"bf16": 1e-2, "int8": 5e-2}
SNIP_BS = 8


def _fused_id(cfg):
    d, algo, frac, impl, build = cfg
    extra = "-".join(f"{k}={v}" for k, v in build.items())
    return f"D{d}-{algo}-{frac}-{impl}" + (f"-{extra}" if extra else "")


def _eval_id(cfg):
    algo, frac, impl, build = cfg
    return f"{algo}-{frac}-{impl}-" + "-".join(build)


def _jax_algo(algo, frac, d):
    seed = SEEDS[algo]
    jd = jsynth(seed=seed, n_clients=8, samples_per_client=8,
                test_per_client=4, sample_shape=(8, 8, 8, 1))
    spe = -(-max(int(n) for n in np.asarray(jd.n_train)) // 4)
    hp = JHyperParams(lr=0.01, lr_decay=0.998, momentum=0.9,
                      weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                      steps_per_epoch=spe, batch_size=4)
    kw = dict(loss_type="bce", frac=frac, seed=0)
    model = jcreate("small3dcnn", num_classes=1)
    ja = (JSalientGrads(model, jd, hp, dense_ratio=0.5, **kw)
          if algo == "salientgrads" else JFedAvg(model, jd, hp, **kw))
    ja.data = shard_federated_hybrid(ja.data, jmake_mesh(d))
    return ja, jd, spe


def _jax_fused_run(algo, frac, d):
    """The reference's fused block of ROUNDS rounds with the eval every
    round on its ``d``-device mesh: its initial parameters and mask, per
    round the epoch permutations of its draws (per selected client), and
    its state and per-round metrics after the block."""
    ja, jd, spe = _jax_algo(algo, frac, d)
    nvals = [int(n) for n in np.asarray(jd.n_train)]
    state = ja.init_state(jax.random.PRNGKey(0))
    init = dict(params=pc.np_tree(state.global_params),
                mask=(pc.np_tree(state.mask) if algo == "salientgrads"
                      else None))
    rng, perms = state.rng, []
    for r in range(ROUNDS):
        rng, round_key = jax.random.split(rng)
        sel = jsample(r, 8, ja.clients_per_round)
        keys = jax.random.split(round_key, len(sel) + 1)
        perms.append([np.array(epoch_permutations(
            jax.random.split(keys[i])[0], jnp.int32(nvals[c]), 1, spe * 4,
            n_rows=jd.x_train.shape[1])) for i, c in enumerate(sel)])
    state, ys = ja.run_rounds_fused(state, 0, ROUNDS, eval_every=1)
    return dict(init=init, perms=perms, state=state,
                ys=ys.materialize())


def _stratified_jax(mode):
    """The reference's stratified SNIP mask on two clients of 50 rows
    (``tests/test_torch_port_train_opts.py``'s cohort), from its own
    parameters: the mask, the parameters and, for "balanced", its draws."""
    kw = dict(seed=1, n_clients=2, samples_per_client=50, test_per_client=4,
              sample_shape=(8, 8, 8, 1), uneven=False)
    jd = jsynth(**kw)
    jm = jcreate("small3dcnn", num_classes=1)
    hp = JHyperParams(lr=0.01, local_epochs=1, steps_per_epoch=7,
                      batch_size=SNIP_BS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jalgo = JSalientGrads(jm, jd, hp, loss_type="bce", frac=1.0, seed=0,
                              dense_ratio=0.5, agg_kernels="pallas",
                              stratified_sampling=True, stratified_mode=mode)
    p_rng, m_rng, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    jparams = jinit(jm, p_rng, (8, 8, 8, 1))
    jmask, _ = jalgo._global_mask_jit(jparams, jd.x_train, jd.y_train,
                                      jd.n_train, m_rng)
    y_host = np.asarray(jd.y_train)
    n = [int(v) for v in np.asarray(jd.n_train)]
    idx = None
    if mode == "balanced":
        idx = []
        for c, k in enumerate(jax.random.split(m_rng, 2)):
            valid = jnp.arange(y_host[c].shape[0]) < n[c]
            yc = jnp.clip(jnp.asarray(y_host[c]).astype(jnp.int32), 0, 1)
            counts = jnp.zeros((2,)).at[yc].add(valid.astype(jnp.float32))
            p = valid / jnp.maximum(counts[yc], 1.0)
            p = p / jnp.maximum(p.sum(), 1e-9)
            idx.append(np.stack([np.asarray(jax.random.choice(
                jax.random.split(kk)[0], y_host[c].shape[0], (SNIP_BS,),
                replace=True, p=p)) for kk in jax.random.split(k, 25)]))
    return dict(mask=jmask, idx=idx, params={
        k: v.numpy() for k, v in
        jax_params_to_torch(pc.np_tree(jparams)).items()})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The single-process side on one thread, as each rank runs (CPU
    convolutions sum in an order that follows the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(d):
    """Every case of the ``d``-rank mesh in one spawn."""
    cases = [("fused_case", dict(algo=a, data_seed=SEEDS[a], frac=f,
                                 agg_impl=i, rounds=ROUNDS, **b))
             for dd, a, f, i, b in FUSED if dd == d]
    algo, frac = JAX[d]
    jrun = _jax_fused_run(algo, frac, d)
    mask = jrun["init"]["mask"]
    cases.append(("fused_case", dict(
        algo=algo, data_seed=SEEDS[algo], frac=frac, agg_impl="dense",
        rounds=ROUNDS, perms=jrun["perms"],
        params={k: v.numpy() for k, v in
                jax_params_to_torch(jrun["init"]["params"]).items()},
        mask=None if mask is None else {
            k: v.numpy() for k, v in jax_params_to_torch(mask).items()})))
    extra = {}
    if d == 2:
        extra["eval"] = [("round_case", dict(
            algo=a, data_seed=SEEDS[a], frac=f, agg_impl=i, rounds=ROUNDS,
            **b)) for a, f, i, b in EVAL]
        extra["stratified"] = [("stratified_case", dict(
            mode=m, n_clients=4, dropout=0.5)) for m in STRATIFIED]
        sj = {m: _stratified_jax(m) for m in STRATIFIED}
        extra["stratified_jax"] = [("stratified_case", dict(
            mode=m, snip_idx=sj[m]["idx"], params=sj[m]["params"]))
            for m in STRATIFIED]
        extra["gloo_on_card"] = [("gloo_on_card_case", {})]
    flat = cases + [c for v in extra.values() for c in v]
    got = mw.run_ranks(d, flat, timeout=SPAWN_TIMEOUT_S)
    n = sum(1 for c in FUSED if c[0] == d)
    out = dict(fused=dict(zip([_fused_id(c) for c in FUSED if c[0] == d],
                              got[:n])),
               jax=(jrun, got[n]))
    at = n + 1
    for k, v in extra.items():
        out[k] = got[at:at + len(v)]
        at += len(v)
    if d == 2:
        out["stratified_jax_masks"] = {m: sj[m]["mask"] for m in STRATIFIED}
    return out


@pytest.fixture(scope="module")
def runs2():
    return _spawn(2)


@pytest.fixture(scope="module")
def runs4():
    return _spawn(4)


def _runs(request, d):
    return request.getfixturevalue(f"runs{d}")


def _eq(a, b):
    if a is None or b is None:
        return a is b
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in b)


def _block(tree, lo, hi):
    return None if tree is None else {k: v[lo:hi] for k, v in tree.items()}


def _rel(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in b) / \
        max(float(np.max(np.abs(v))) for v in b.values())


@pytest.mark.parametrize("cfg", FUSED, ids=[_fused_id(c) for c in FUSED])
def test_fused_mesh_block_is_the_eager_mesh_rounds(request, cfg):
    """Bitwise: the block's state (the rank's rows, the replicated global
    model and eval cache), its train losses and each round's eval."""
    ranks = _runs(request, cfg[0])["fused"][_fused_id(cfg)]
    for rank in ranks:
        for field in ("global_params", "personal", "residual",
                      "eval_cache"):
            assert _eq(rank["fused"][field], rank["eager"][field]), field
        for k, v in rank["ys"].items():
            np.testing.assert_array_equal(
                v, [m[k] for m in rank["mets"]], err_msg=k)
        assert rank["ys_eval"].keys() == rank["evals"][0].keys()
        for k, v in rank["ys_eval"].items():
            np.testing.assert_array_equal(
                v, [e[k] for e in rank["evals"]], err_msg=k)
        assert rank["graphs"] >= 1
    for rank in ranks[1:]:
        assert _eq(rank["fused"]["global_params"],
                   ranks[0]["fused"]["global_params"])


@pytest.mark.parametrize("cfg", FUSED, ids=[_fused_id(c) for c in FUSED])
def test_fused_mesh_block_against_single_process_block(request, cfg):
    """The single-process fused block from the same initial state (the
    generator in step): the mask, round 0's trained rows, loss, cache and
    personal eval bitwise, the global model within the wire's bound after
    round 0; everything bitwise where every rank reduces all rows."""
    d, algo, frac, impl, build = cfg
    ranks = _runs(request, d)["fused"][_fused_id(cfg)]
    a = mw.build_round_algo(algo, SEEDS[algo], frac, impl, **build)
    first = {}
    state, ys = a.run_rounds_fused(
        a.init_state(), 0, ROUNDS, eval_every=1,
        on_first_round=lambda s: first.update(state=mw._state_np(s)))
    ys = ys.materialize()
    one, one_first = mw._state_np(state), first["state"]
    fallback = a.clients_per_round % d != 0
    for rank in ranks:
        lo, hi = rank["lo"], rank["hi"]
        if algo == "salientgrads":
            assert _eq(rank["mask"], mw._np_tree(state.mask))
        for field in ("personal", "residual"):
            assert _eq(rank["first"][field],
                       _block(one_first[field], lo, hi)), field
        assert _eq(rank["first"]["eval_cache"], one_first["eval_cache"])
        assert rank["ys"]["train_loss"][0] == ys["train_loss"][0]
        for k in ("personal_acc", "personal_loss"):
            assert rank["ys_eval"][k][0] == ys["eval"][k][0], k
        g, want = (rank["first"]["global_params"],
                   one_first["global_params"])
        if fallback:
            assert _eq(g, want)
            for field in ("global_params", "eval_cache"):
                assert _eq(rank["fused"][field], one[field]), field
            assert _eq(rank["fused"]["personal"],
                       _block(one["personal"], lo, hi))
            for k, v in ys["eval"].items():
                np.testing.assert_array_equal(rank["ys_eval"][k], v)
        else:
            assert _rel(g, want) <= LOW_PRECISION.get(impl, 1e-6), \
                _rel(g, want)


@pytest.mark.parametrize("d", sorted(JAX))
def test_fused_mesh_block_matches_reference_fused_block(request, d):
    """The reference's ``run_rounds_fused`` on its own ``d``-device mesh
    against the port's fused mesh block on its parameters, mask and epoch
    permutations: rtol 1e-5, atol 2e-7 after two rounds."""
    jrun, ranks = _runs(request, d)["jax"]
    jstate, jys = jrun["state"], jrun["ys"]
    for rank in ranks:
        last = rank["fused"]
        pc.compare({k: torch.from_numpy(v) for k, v in
                    last["global_params"].items()},
                   jstate.global_params, "dense")
        lo, hi = rank["lo"], rank["hi"]
        for c in range(lo, hi):
            pc.compare({k: torch.from_numpy(v[c - lo]) for k, v in
                        last["personal"].items()},
                       jax.tree_util.tree_map(lambda x: x[c],
                                              jstate.personal_params),
                       "dense")
        np.testing.assert_allclose(rank["ys"]["train_loss"],
                                   np.asarray(jys["train_loss"]), rtol=1e-5)
        for k in ("global_acc", "personal_acc"):
            np.testing.assert_array_equal(rank["ys_eval"][k],
                                          np.asarray(jys["eval"][k]))
        for k in ("global_loss", "personal_loss"):
            np.testing.assert_allclose(rank["ys_eval"][k],
                                       np.asarray(jys["eval"][k]),
                                       rtol=1e-5)


@pytest.mark.parametrize("which", range(len(EVAL)),
                         ids=[_eval_id(c) for c in EVAL])
def test_mesh_eval_cache_and_subset_are_the_single_process_eval(runs2,
                                                                 which):
    """Each eager mesh round replayed off the mesh from the mesh's state
    before it: the train loss, the eval (over the ``eval_clients`` subset
    where set) and the eval cache bitwise, every rank holding the same
    cache."""
    algo, frac, impl, build = EVAL[which]
    ranks = runs2["eval"][which]
    a = mw.build_round_algo(algo, SEEDS[algo], frac, impl, **build)
    off = mw.replay_off_mesh(a, ranks, ROUNDS)
    for rank in ranks:
        for r in range(ROUNDS):
            assert _eq(rank["mets"][r], off["mets"][r]), r
            assert _eq(rank["evals"][r], off["evals"][r]), r
            assert _eq(rank["states"][r + 1]["eval_cache"],
                       off["states"][r]["eval_cache"]), r
        if "eval_clients" in build:
            assert rank["evals"][-1]["acc_per_client"].shape == (5,)


@pytest.mark.parametrize("mode", STRATIFIED)
def test_mesh_stratified_snip_is_the_single_process_mask(runs2, mode):
    """The ranks' draws of the clients they do not hold keep the generator
    the single process's: the mask bitwise, on every rank."""
    got = runs2["stratified"][STRATIFIED.index(mode)]
    a = mw.build_stratified_algo(mode, n_clients=4, dropout=0.5)
    want = mw._np_tree(a.init_state().mask)
    for mask in got:
        assert _eq(mask, want)


@pytest.mark.parametrize("mode", STRATIFIED)
def test_mesh_stratified_snip_matches_reference_mask(runs2, mode):
    """On the reference's parameters (and, "balanced", its draws) the mesh's
    mask agrees with the JAX package's on more than 99.9% of the weights,
    its density within 1e-3 of 0.5 and of the reference's."""
    got = runs2["stratified_jax"][STRATIFIED.index(mode)]
    jmask = runs2["stratified_jax_masks"][mode]
    want = jax_params_to_torch(pc.np_tree(jmask))
    for mask in got:
        m = {k: torch.from_numpy(v) for k, v in mask.items()}
        agree = sum(int((m[k] == v).sum()) for k, v in want.items())
        assert agree / sum(v.numel() for v in want.values()) > 0.999
        assert abs(tsp.mask_density(m) - 0.5) < 1e-3
        assert abs(tsp.mask_density(m)
                   - float(jsp.mask_density(jmask))) < 1e-3
    assert all(_eq(mask, got[0]) for mask in got[1:])


def test_gloo_mesh_on_the_card_refuses_fused_blocks(runs2):
    """A gloo group's collectives run on the host, so its fused block on
    the card is refused (no eager fallback), naming NCCL."""
    for msg in runs2["gloo_on_card"][0]:
        assert msg is not None and "NCCL" in msg and "client mesh" in msg


def test_bench_rank_body_on_two_gloo_ranks():
    """``bench_torch.py``'s per-rank body (``rank_main``, spawned by
    ``run_sharded``) on two gloo CPU ranks at a narrow width: rank 0's
    record has the one-card record's keys, the mesh's width, and the rates
    are finite; the ranks import nothing of JAX."""
    code = (
        "import json, sys\n"
        "import bench_torch as b\n"
        "cfg = dict(b.bench_config(''), model_key='small3dcnn',\n"
        "           sample_shape=(8, 8, 8, 1), samples_per_client=8,\n"
        "           steps=2, batch=4, timed_rounds=2, timed_rounds_eval=2,\n"
        "           warm_calls=1)\n"
        "rec = b.run_sharded(b.rank_main, 2, 'cpu', 'gloo', cfg)\n"
        "one = b.measure(cfg, 'cpu')\n"
        "jax = [m for m in sys.modules if m == 'jax' or\n"
        "       m.startswith('neuroimagedisttraining_tpu')]\n"
        "print(json.dumps({'rec': rec, 'one': one, 'jax': jax}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True,
                         timeout=SPAWN_TIMEOUT_S,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    rec, one = got["rec"], got["one"]
    assert got["jax"] == []
    assert sorted(rec) == sorted(one) and \
        sorted(rec["extra"]) == sorted(one["extra"])
    assert rec["metric"] == "salientgrads_rounds_per_sec_abcd_alexnet3d_" \
        "8clients"
    extra = rec["extra"]
    assert (extra["n_devices"], extra["client_mesh_devices"]) == (2, 2)
    assert (one["extra"]["n_devices"],
            one["extra"]["client_mesh_devices"]) == (1, 1)
    rates = [rec["value"]] + [v for k, v in extra.items()
                              if k.startswith("rounds_per_sec")]
    assert all(np.isfinite(r) and r > 0 for r in rates)
    assert rec["value"] == max(extra["rounds_per_sec_python_loop"],
                               extra["rounds_per_sec_fused"])
    np.testing.assert_allclose(
        extra["client_rounds_per_sec_per_chip"],
        rec["value"] * 8 / 2, rtol=1e-3)


#: a run of two gloo ranks whose rank 1 raises at its second fused block
#: (once a block has built its graphs); ``spawn`` imports this script in
#: each rank, so the rank's methods are wrapped there. Every rank notes
#: the raise, the graphs' release and the mesh's teardown in its own file.
FAILING_RANK = """
import json, sys
sys.path.insert(0, {root!r})
import torch.distributed as dist
from neuroimagedisttraining_torch.algorithms import base
from neuroimagedisttraining_torch.parallel import mesh as pmesh

def note(what):
    with open({log!r} + "." + str(dist.get_rank()), "a") as f:
        f.write(what + "\\n")

def wrap(cls, name, fn):
    inner = getattr(cls, name)
    setattr(cls, name, lambda self, *a, **k: fn(inner, self, *a, **k))

def fused(inner, self, *a, **k):
    self._calls = getattr(self, "_calls", 0) + 1
    if self._calls == 2 and dist.get_rank() == 1:
        note("raise")
        raise RuntimeError("rank 1 fails")
    return inner(self, *a, **k)

def release(inner, self):
    if self._fused is not None:
        note("release")
    inner(self)

def destroy(inner, self):
    note("destroy")
    inner(self)

wrap(base.FedAlgorithm, "run_rounds_fused", fused)
wrap(base.FedAlgorithm, "release_graphs", release)
wrap(pmesh.ClientMesh, "destroy", destroy)

if __name__ == "__main__":
    try:
        if {entry!r} == "runner":
            from neuroimagedisttraining_torch.experiments import runner
            runner.main(["--algo", "salientgrads", "--dataset", "synthetic",
                         "--model", "small3dcnn", "--comm_round", "4",
                         "--fuse_rounds", "2", "--mesh_devices", "2",
                         "--device", "cpu", "--results_dir", "",
                         "--log_dir", ""])
        else:
            import bench_torch as b
            cfg = dict(b.bench_config(""), model_key="small3dcnn",
                       sample_shape=(8, 8, 8, 1), samples_per_client=8,
                       steps=2, batch=4, timed_rounds=2,
                       timed_rounds_eval=2, warm_calls=1)
            b.run_sharded(b.rank_main, 2, "cpu", "gloo", cfg)
    except Exception as e:
        print(json.dumps({{"error": str(e)}}))
    else:
        print(json.dumps({{"error": None}}))
"""


@pytest.mark.parametrize("entry", ("runner", "bench"))
def test_mesh_rank_that_raises_releases_graphs_and_ends(tmp_path, entry):
    """A fused mesh run whose rank 1 raises at its second fused block: the
    rank releases its graphs (NCCL does not destroy a communicator while a
    graph holding its collectives lives, and the traceback keeps the
    algorithm reachable) before its mesh is torn down, and the run ends
    with the rank's error within its time limit instead of hanging."""
    script = tmp_path / "failing_rank.py"
    log = str(tmp_path / "notes")
    script.write_text(FAILING_RANK.format(root=str(ROOT), log=log,
                                          entry=entry))
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=180,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    # the error the spawn raises is the first rank's to fail: rank 1's, or
    # rank 0's when rank 1's teardown broke its pending collective first
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["error"] is not None, got
    with open(log + ".1") as f:
        assert f.read().split() == ["raise", "release", "destroy"]
