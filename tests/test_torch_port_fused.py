"""The port's fused round loop (``FedAlgorithm.run_rounds_fused``), on the CPU.

The port of ``tests/test_fused_rounds.py``'s cases that apply to its two
algorithms. On the CPU a fused block runs the same round body a CUDA graph
holds on the card, eagerly, on the same buffers (client ids, rate, epoch
permutations, dropout keep masks, int8 uniforms, state), with the host's
draws written into them from a copy of the state's generator in the order
``run_round`` draws them. So a block of K rounds is held bit for bit to K
``run_round`` + ``evaluate`` calls: losses, eval rows, global and personal
parameters, residual, the generator's state. On
``tests/test_torch_port_round.py``'s narrow cohort (data seed 9, uneven
shards, so a sampled draw changes the block's graph key).

Against the JAX package: its ``run_rounds_fused`` (Pallas in interpret mode)
for two rounds, the port's block fed the reference's epoch permutations at
the seams (dropout 0), on ``tests/test_torch_port_round.py``'s cohort and
tolerances (data seed 4, whose two rounds have no max-pool or relu tie flip
between the frameworks; rtol 1e-5, atol 2e-7 for the GroupNorm-fed biases;
per-client accuracies equal).

The baselines' fused blocks are in ``tests/test_torch_port_fused_baselines.py``
(which shares this module's cohort and one-thread fixture).
"""
import time

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import SalientGrads as JSalientGrads  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_torch.algorithms import (  # noqa: E402
    FedAvg,
    SalientGrads,
    SalientGradsState,
)
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import (  # noqa: E402
    HyperParams,
    broadcast_tree,
)
from neuroimagedisttraining_torch.models import create_model  # noqa: E402
from neuroimagedisttraining_torch.parallel import collectives as tc  # noqa: E402


@pytest.fixture(scope="module")
def cohort():
    return pc.cohort(seed=9)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These cases run many small CPU ops: among the suite's parallel
    workers, torch's default of a thread per core oversubscribes the
    machine, and every op's thread barrier waits on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _algo(c, name, impl="dense", frac=1.0, dropout=0.0):
    """The narrow cohort's algorithm; with ``dropout`` a model whose
    dropout layers draw (the main configuration's 0.5)."""
    model = c["tm"] if not dropout else create_model(
        "3dcnn_s2d", num_classes=1, widths=pc.WIDTHS, dropout_rate=dropout,
        sample_shape=pc.SS)
    kw = dict(loss_type="bce", frac=frac, agg_impl=impl,
              agg_bucket_size=pc.BUCKET, agg_topk_density=pc.DENSITY,
              device="cpu")
    hp = pc.hp(HyperParams, c["spe"])
    if name == "salientgrads":
        return SalientGrads(model, c["td"], hp, dense_ratio=0.5,
                            itersnip_iterations=1, **kw)
    return FedAvg(model, c["td"], hp, **kw)


def _eager(algo, state, rounds, eval_every=1, start=0):
    """``rounds`` run_round calls, the eval on the fused cadence: (state,
    losses, {round index: eval row})."""
    losses, evals = [], {}
    for i, r in enumerate(range(start, start + rounds)):
        state, met = algo.run_round(state, r)
        losses.append(float(met["train_loss"]))
        if eval_every and (r + 1) % eval_every == 0:
            evals[i] = {k: float(v) for k, v in algo.evaluate(state).items()
                        if not k.startswith("acc_per")}
    return state, losses, evals


def _assert_states_equal(a, b):
    for f in ("global_params", "personal_params", "agg_residual"):
        ta, tb = getattr(a, f), getattr(b, f)
        assert (ta is None) == (tb is None), f
        if ta is not None:
            assert all(torch.equal(ta[k], tb[k]) for k in ta), f
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _snapshot(state):
    return {f: {k: t.clone() for k, t in getattr(state, f).items()}
            for f in ("global_params", "personal_params")} | {
        "generator": state.generator.get_state().clone()}


CASES = [
    pytest.param("salientgrads", "dense", 2 / 3, 0.0, id="sg-dense-sampled"),
    pytest.param("salientgrads", "dense", 1.0, 0.5, id="sg-dense-full-dropout"),
    pytest.param("salientgrads", "int8", 2 / 3, 0.5,
                 id="sg-int8-sampled-dropout"),
    pytest.param("fedavg", "dense", 1.0, 0.0, id="fedavg-dense"),
    pytest.param("fedavg", "int8", 1.0, 0.0, id="fedavg-int8"),
    pytest.param("fedavg", "topk", 2 / 3, 0.0, id="fedavg-topk-sampled"),
]


@pytest.mark.parametrize("name,impl,frac,dropout", CASES)
def test_fused_block_bitwise_equals_run_round(cohort, name, impl, frac,
                                              dropout):
    """Two fused rounds with the eval after each equal two run_round +
    evaluate calls bit for bit, and leave their input state as it was."""
    algo = _algo(cohort, name, impl, frac, dropout)
    s0 = algo.init_state()
    keep = _snapshot(s0)
    su, losses, evals = _eager(algo, algo.clone_state(s0), 2)
    sf, ys = algo.run_rounds_fused(s0, 0, 2, eval_every=1)
    np.testing.assert_array_equal(ys["train_loss"], losses)
    assert set(ys["eval"]) == set(evals[0])
    assert not any(k.startswith("acc_per") for k in ys["eval"])
    for i, ev in evals.items():
        assert {k: float(v[i]) for k, v in ys["eval"].items()} == ev, i
    _assert_states_equal(su, sf)
    after = _snapshot(s0)
    for f in ("global_params", "personal_params"):
        assert all(torch.equal(keep[f][k], after[f][k]) for k in keep[f])
    assert torch.equal(keep["generator"], after["generator"])


def test_fused_eval_cadence_matches_frequency_of_the_test(cohort):
    """eval_every=2 over rounds 1..3: rounds 1 and 3 carry the eval (equal
    to run_round + evaluate there), round 2 zeros; a block of round 0 alone
    has no eval round and no eval series."""
    algo = _algo(cohort, "fedavg")
    s0 = algo.init_state()
    s1, ys0 = algo.run_rounds_fused(s0, 0, 1, eval_every=2)
    assert "eval" not in ys0 and "train_loss" in ys0
    _, losses, evals = _eager(algo, algo.clone_state(s1), 3, eval_every=2,
                              start=1)
    _, ys = algo.run_rounds_fused(s1, 1, 3, eval_every=2)
    np.testing.assert_array_equal(ys["train_loss"], losses)
    assert sorted(evals) == [0, 2]
    assert ys["eval"]["global_acc"][1] == 0.0
    for i in (0, 2):
        assert {k: float(v[i]) for k, v in ys["eval"].items()} == evals[i]


def test_returned_state_not_overwritten_by_next_block(cohort):
    """A block's output state is a copy: running the next block (which
    reuses the same buffers) leaves it as it was, and the next block
    continues it exactly as run_round would."""
    algo = _algo(cohort, "salientgrads", frac=2 / 3)
    s0 = algo.init_state()
    s1, _ = algo.run_rounds_fused(s0, 0, 2)
    keep = _snapshot(s1)
    s2, ys = algo.run_rounds_fused(s1, 2, 2)
    after = _snapshot(s1)
    for f in ("global_params", "personal_params"):
        assert all(torch.equal(keep[f][k], after[f][k]) for k in keep[f])
    su, losses, _ = _eager(algo, algo.clone_state(s1), 2, eval_every=0,
                           start=2)
    np.testing.assert_array_equal(ys["train_loss"], losses)
    _assert_states_equal(su, s2)


def test_round_graphs_bounded_by_lru(cohort, monkeypatch):
    """A sampled draw of uneven shards meets more step-count keys than the
    loop keeps graphs: the least recently used one is released, the cache
    never holds more than FUSED_MAX_GRAPHS, and a key met again after its
    eviction is built anew and still equals run_round bit for bit."""
    from neuroimagedisttraining_torch.algorithms import base

    monkeypatch.setattr(base, "FUSED_MAX_GRAPHS", 2)
    algo = _algo(cohort, "salientgrads", frac=2 / 3)
    keys = {algo._step_key([algo._n_train[int(c)] for c in
                            algo._selected_client_indexes(r)])
            for r in range(6)}
    assert len(keys) > 2, keys
    s0 = algo.init_state()
    su, losses, _ = _eager(algo, algo.clone_state(s0), 6, eval_every=0)
    sf, got = s0, []
    for r0 in range(0, 6, 2):
        sf, ys = algo.run_rounds_fused(sf, r0, 2)
        got += list(ys["train_loss"])
        assert len(algo._fused.rounds) <= 2
    assert algo._fused.evicted >= len(keys) - 2
    np.testing.assert_array_equal(got, losses)
    _assert_states_equal(su, sf)


def _counts(algo, r):
    return tuple(algo._n_train[int(c)] for c in
                 algo._selected_client_indexes(r))


def test_equal_step_counts_replay_one_graph(cohort):
    """Two draws whose clients' sample counts differ but whose step counts
    agree (shards of 6 and 7 rows at batch 4 both run 2 batches an epoch)
    share one round graph: the counts reach the body through the n_sel
    buffer (the aggregate's weights, the loss masks), and the blocks are
    bitwise the eager rounds."""
    algo = _algo(cohort, "salientgrads", frac=2 / 3)
    rounds = [r for r in range(40)
              if algo._step_key(_counts(algo, r)) == (2, 2)]
    r1 = rounds[0]
    r2 = next(r for r in rounds if _counts(algo, r) != _counts(algo, r1))
    assert algo._step_key(_counts(algo, r1)) == \
        algo._step_key(_counts(algo, r2))
    s0 = algo.init_state()
    su, sf, losses, got = algo.clone_state(s0), s0, [], []
    for r in (r1, r2):
        su, met = algo.run_round(su, r)
        losses.append(float(met["train_loss"]))
        sf, ys = algo.run_rounds_fused(sf, r, 1)
        got += list(ys["train_loss"])
    assert list(algo._fused.rounds) == [(2, 2)]
    assert algo._fused.evicted == 0
    np.testing.assert_array_equal(got, losses)
    _assert_states_equal(su, sf)


def test_uneven_shards_key_by_step_counts(cohort):
    """At ``frac`` 0.5 on uneven shards, eight one-round blocks create no
    more round graphs than the distinct step-count tuples their draws
    meet, fewer than the distinct sample-count tuples, and equal the eager
    rounds bit for bit."""
    algo = _algo(cohort, "fedavg", frac=0.5)
    counts = {_counts(algo, r) for r in range(8)}
    steps = {algo._step_key(c) for c in counts}
    assert len(steps) < len(counts), (steps, counts)
    s0 = algo.init_state()
    su, losses, _ = _eager(algo, algo.clone_state(s0), 8, eval_every=0)
    sf, got = s0, []
    for r in range(8):
        sf, ys = algo.run_rounds_fused(sf, r, 1)
        got += list(ys["train_loss"])
    assert set(algo._fused.rounds) == steps
    np.testing.assert_array_equal(got, losses)
    _assert_states_equal(su, sf)


def test_run_fuse_rounds_history_matches_unfused(cohort):
    """``run(fuse_rounds=3)`` over five rounds (an uneven tail block), eval
    every 2 and the final pass: the unfused history but ``round_time_s``,
    which is stamped at block flushes and sums to the wall time."""
    algo = _algo(cohort, "salientgrads", frac=2 / 3)
    s0 = algo.init_state()
    _, hist_u = algo.run(5, eval_every=2, state=algo.clone_state(s0))
    t0 = time.perf_counter()
    _, hist_f = algo.run(5, eval_every=2, state=algo.clone_state(s0),
                         fuse_rounds=3)
    elapsed = time.perf_counter() - t0
    times = [h["round_time_s"] for h in hist_f if h["round"] >= 0]
    assert all(t > 0 for t in times)
    assert 0.2 * elapsed < sum(times) <= 1.05 * elapsed, (sum(times), elapsed)
    assert [h["round"] for h in hist_f] == [h["round"] for h in hist_u]
    for hu, hf in zip(hist_u, hist_f):
        assert set(hu) - {"round_time_s"} == set(hf) - {"round_time_s"}
        for k in hu:
            if k != "round_time_s":
                assert hu[k] == hf[k], (hu["round"], k)
    assert "global_acc" in hist_f[1] and "global_acc" not in hist_f[0]


def test_fused_unsupported_algorithm_raises(cohort):
    class NoFused(FedAvg):
        supports_fused = False

    algo = NoFused(cohort["tm"], cohort["td"], pc.hp(HyperParams,
                                                     cohort["spe"]),
                   device="cpu")
    with pytest.raises(ValueError, match="fused"):
        algo.run_rounds_fused(algo.init_state(), 0, 2)
    with pytest.raises(ValueError, match="seams"):
        _algo(cohort, "fedavg").run_rounds_fused(
            algo.init_state(), 0, 2, seams=[{}])


def _cli(tmp_path, tag, *extra):
    from neuroimagedisttraining_torch.experiments import runner

    return runner.main([
        "--algo", "salientgrads", "--dataset", "synthetic", "--model",
        "small3dcnn", "--device", "cpu", "--client_num_in_total", "4",
        "--batch_size", "8", "--epochs", "1", "--comm_round", "5", "--lr",
        "0.05", "--lr_decay", "0.998", "--frequency_of_the_test", "2",
        "--frac", "0.5", "--results_dir", "", "--log_dir",
        str(tmp_path / f"LOG{tag}"), *extra])


def test_runner_fuse_rounds_matches_unfused(tmp_path):
    """``--fuse_rounds 2`` through the CLI (blocks of 2, 2 and 1, the rate
    decaying every round): the unfused history, the cost counters and the
    final eval."""
    out_u = _cli(tmp_path, "u")
    out_f = _cli(tmp_path, "f", "--fuse_rounds", "2")
    hu = [h for h in out_u["history"] if h["round"] >= 0]
    hf = [h for h in out_f["history"] if h["round"] >= 0]
    assert len(hf) == len(hu) == 5
    for a, b in zip(hu, hf):
        assert a == b, (a, b)
    assert "global_acc" in hf[1] and "global_acc" not in hf[0]
    assert out_u["history"][-1] == out_f["history"][-1]


def test_fused_matches_reference_run_rounds_fused():
    """Two rounds of the JAX package's ``run_rounds_fused`` (the main path's
    kernel flags, Pallas in interpret mode) and the port's, fed the
    reference's epoch permutations at the seams, from the reference's
    parameters and mask."""
    c = pc.cohort(seed=4)
    jalgo = JSalientGrads(c["jm"], c["jd"], pc.hp(JHyperParams, c["spe"]),
                          loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
                          itersnip_iterations=1, fused_kernels=True,
                          agg_kernels="pallas")
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    talgo = _algo(c, "salientgrads")
    g0 = jax_params_to_torch(pc.np_tree(jstate.global_params))
    state = SalientGradsState(
        global_params=g0, mask=jax_params_to_torch(pc.np_tree(jstate.mask)),
        personal_params=broadcast_tree(g0, pc.N_CLIENTS),
        generator=torch.Generator())
    rng, seams = jstate.rng, []
    for _ in range(2):
        rng, perms, _ = pc.draws(rng, c)
        seams.append({"perms": perms})
    jstate, jys = jalgo.run_rounds_fused(jstate, 0, 2, eval_every=1)
    state, ys = talgo.run_rounds_fused(state, 0, 2, eval_every=1,
                                       seams=seams)
    np.testing.assert_allclose(ys["train_loss"],
                               np.asarray(jys["train_loss"]), rtol=1e-5)
    for k in ("global_acc", "personal_acc"):
        np.testing.assert_allclose(ys["eval"][k], np.asarray(jys["eval"][k]),
                                   rtol=1.2e-7)
    np.testing.assert_array_equal(ys["eval"]["mask_density"],
                                  np.asarray(jys["eval"]["mask_density"]))
    pc.compare(state.global_params, jstate.global_params, "dense")
    pc.compare(state.personal_params, jstate.personal_params, "dense",
               stacked=True)
    jev, tev = jalgo.evaluate(jstate), talgo.evaluate(state)
    np.testing.assert_array_equal(tev["acc_per_client"].numpy(),
                                  np.asarray(jev["acc_per_client"]))


def test_fused_seams_match_run_round_seams(cohort):
    """Draws fed at the seams (numpy-made epoch permutations, dropout keep
    masks and int8 uniforms, as a test feeds the reference's) replace the
    generator's in a fused block exactly as in run_round."""
    c = cohort
    algo = _algo(c, "salientgrads", "int8", frac=2 / 3, dropout=0.5)
    s0 = algo.init_state()
    calls = algo._dropout_calls(s0.global_params)
    assert [slot for slot, _, _ in calls] == [0, 1]
    rs = np.random.RandomState(0)
    hp = algo.hp
    seams = []
    for r in range(2):
        n_sel = len(algo._selected_client_indexes(r))
        seams.append({
            "perms": [rs.randint(0, c["n_rows"], size=(
                hp.local_epochs, hp.steps_per_epoch * hp.batch_size))
                for _ in range(n_sel)],
            "dropout": [[[torch.from_numpy(rs.rand(*shape) < keep)
                          for _, shape, keep in calls]
                         for _ in range(hp.local_steps)]
                        for _ in range(n_sel)],
            "agg_uniforms": torch.from_numpy(rs.rand(
                n_sel, *tc.bucket_shape(c["n_params"], pc.BUCKET)).astype(
                    np.float32)),
        })
    su = algo.clone_state(s0)
    losses = []
    for r in range(2):
        su, met = algo.run_round(su, r, **seams[r])
        losses.append(float(met["train_loss"]))
    sf, ys = algo.run_rounds_fused(s0, 0, 2, seams=seams)
    np.testing.assert_array_equal(ys["train_loss"], losses)
    _assert_states_equal(su, sf)


# -- the personalized and decentralized baselines ----------------------------
