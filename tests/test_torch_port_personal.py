"""The port's personalized and decentralized baselines against the JAX
package's, on the CPU: Local, DPSGD, SubAvg and Ditto (DisPFL has
``tests/test_torch_port_dispfl.py``), and the pieces they share.

* Bitwise on identical inputs: ``neighbor_adjacency`` (every mode, partial
  and full participation, inactive clients); the ERK and uniform
  sparsities (the narrow and the full-width AlexNet3DS2D); the random
  masks from the reference's uniform scores; the cosine-annealed fire rate
  over whole schedules; fire, regrow and prune over every round of a
  schedule, on weights quantized so that ties abound, one client and
  stacked; live counts, mask distance and density. The reference side is
  jitted where its round program is (XLA turns a division by a constant
  into a product by the reciprocal there).
* ``mix_over_clients``: mask counts exact, sums within rtol 1e-6.
* The kernel route: the port's local step (the masked SGD kernel's
  ``mask_grads`` branch for DisPFL and SubAvg, no post-step mask; plain
  SGD over ones; Ditto's prox pull) bitwise the reference's kernel route
  (its Pallas kernel, the pull as it spells it), and against its default
  XLA chain zero off the mask on both sides and within one rounding on
  the rest (:func:`test_kernel_route_against_reference` says why).
* Two rounds of each algorithm on ``tests/_torch_port_cohort.py``'s narrow
  cohort (3 clients), the port fed the reference's draws at its seams
  (each leg's epoch permutations): train losses within rtol 1e-5,
  parameters within rtol 1e-5 (atol 1e-5 of the leaf's largest value),
  SubAvg's masks bitwise, per-client accuracies bitwise. Each reference
  run is made once per module. Data seed 4, but DPSGD's 5: DPSGD trains
  every weight from the gossip average, and on seeds 4, 6, 7 and 9 a
  max-pool or relu decision within float32 round-off of its tie goes the
  other way in the two frameworks by round 2 (the stem kernel 3e-4 to 3e-3
  of its scale off: a discrete flip, as FedAvg's on seeds 4, 6 and 7,
  ROADMAP "Near-ties"); seeds 3, 5 and 8 have none.
* The CLI: the five algorithms' namespaces and identities equal the JAX
  CLI's, its refusals for them word for word, and each runs end to end
  (synthetic, small3dcnn, 2 rounds) on the CPU with ``stat_info`` written;
  ``--fuse_rounds 2`` for ditto, local, dpsgd and ``dispfl --static``
  gives the unfused records.
"""
import dataclasses
import math
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu import algorithms as jalgos  # noqa: E402
from neuroimagedisttraining_tpu.core import optim as joptim  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.core.state import mix_over_clients as jmix  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.experiments import config as jconfig  # noqa: E402
from neuroimagedisttraining_tpu.experiments import runner as jrunner  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_tpu.ops import sparsity as jsp  # noqa: E402
from neuroimagedisttraining_tpu.ops.s2d import phased_sample_shape  # noqa: E402
from neuroimagedisttraining_tpu.parallel import topology as jtopo  # noqa: E402
from neuroimagedisttraining_torch import algorithms as talgos  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402
from neuroimagedisttraining_torch.core.state import mix_over_clients  # noqa: E402
from neuroimagedisttraining_torch.core.trainer import optimizer_step  # noqa: E402
from neuroimagedisttraining_torch.experiments import config as tconfig  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402
from neuroimagedisttraining_torch.models import create_model  # noqa: E402
from neuroimagedisttraining_torch.ops import sparsity as tsp  # noqa: E402
from neuroimagedisttraining_torch.parallel import topology as ttopo  # noqa: E402

N = pc.N_CLIENTS
f32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cohort():
    return pc.cohort()


# -- topology and the gossip contraction ----------------------------------------

@pytest.mark.parametrize("mode", ["random", "ring", "full"])
def test_neighbor_adjacency_bitwise(mode):
    rs = np.random.RandomState(0)
    for n, per in ((8, 3), (8, 8), (5, 1), (3, 2)):
        for active in (None, rs.randint(0, 2, n), np.ones(n, np.int64)):
            for r in range(4):
                want = jtopo.neighbor_adjacency(r, n, per, mode=mode,
                                                active=active)
                got = ttopo.neighbor_adjacency(r, n, per, mode=mode,
                                               active=active)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown neighbor mode"):
        ttopo.neighbor_adjacency(0, 4, 2, mode="star")


def test_mix_over_clients():
    rs = np.random.RandomState(1)
    adj = (rs.rand(N, N) < 0.6).astype(np.float32)
    np.fill_diagonal(adj, 1.0)
    mix = adj / adj.sum(axis=1, keepdims=True)
    masks = {"a": (rs.rand(N, 40, 7) < 0.5).astype(np.float32),
             "b": (rs.rand(N, 333) < 0.3).astype(np.float32)}
    params = {k: rs.randn(*v.shape).astype(np.float32) for k, v in
              masks.items()}
    jc = jmix(jnp.asarray(adj), {k: jnp.asarray(v) for k, v in masks.items()})
    tc = mix_over_clients(torch.from_numpy(adj),
                          {k: torch.from_numpy(v) for k, v in masks.items()})
    for k in masks:  # small integers in float32: exact
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    jp = jax.jit(jmix)(jnp.asarray(mix),
                       {k: jnp.asarray(v) for k, v in params.items()})
    tp = mix_over_clients(torch.from_numpy(mix),
                          {k: torch.from_numpy(v) for k, v in params.items()})
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


# -- the sparsity functions -----------------------------------------------------

def _shape_pairs(widths=pc.WIDTHS, volume=(69, 69, 69)):
    """Both sides' kernel shapes (reference layout, leaf order); the
    models' own widths with ``widths`` None."""
    ss = phased_sample_shape(volume)
    kw = dict(num_classes=1) if widths is None else dict(num_classes=1,
                                                         widths=widths)
    jm = jcreate("3dcnn_s2d", **kw)
    jp = jax.eval_shape(lambda: jinit(jm, jax.random.PRNGKey(0), ss))
    tm = create_model("3dcnn_s2d", sample_shape=ss, **kw)
    tp = {k: v.detach() for k, v in tm.named_parameters()}
    return jsp.param_shapes(jp), tsp.param_shapes(tp)


@pytest.mark.parametrize("width", ["narrow", "full"])
def test_erk_and_uniform_sparsities_bitwise(width):
    js, ts = (_shape_pairs() if width == "narrow"
              else _shape_pairs(widths=None, volume=(121, 145, 121)))
    assert list(js.values()) == list(ts.values())
    for ratio in (0.2, 0.4, 0.5, 0.6, 0.8, 1.0):
        for power in (1.0, 0.5):
            want = list(jsp.erk_sparsities(js, ratio, power).values())
            got = list(tsp.erk_sparsities(ts, ratio, power).values())
            assert got == want, (ratio, power)
        assert list(tsp.uniform_sparsities(ts, ratio).values()) == \
            list(jsp.uniform_sparsities(js, ratio).values())


def test_random_masks_bitwise(cohort):
    key = jax.random.PRNGKey(3)
    for shape, density in (((5, 7, 3), 0.4), ((100,), 0.0), ((100,), 1.0),
                           ((13, 17), 0.77)):
        want = np.asarray(jsp.random_mask_array(key, shape, density))
        size = int(np.prod(shape))
        scores = torch.from_numpy(np.array(jax.random.uniform(key, (size,))))
        got = tsp.random_mask_array(shape, density, scores=scores)
        np.testing.assert_array_equal(got.numpy(), want)
    # the tree version: each kernel leaf's scores from its split key
    c = cohort
    jp = jinit(c["jm"], jax.random.PRNGKey(0), phased_sample_shape(
        (69, 69, 69)))
    shapes = jsp.param_shapes(jp)
    sp = jsp.erk_sparsities(shapes, 0.5)
    want = jsp.random_masks_from_sparsities(jp, lambda n, s: sp[n], key)
    tp = jax_params_to_torch(pc.np_tree(jp))
    order = tsp.reference_leaf_order(tp)
    keys = jax.random.split(key, len(order))
    flags = tsp.kernel_flags(tp)
    scores = {k: torch.from_numpy(np.array(jax.random.uniform(
        keys[i], (tp[k].numel(),)))) for i, k in enumerate(order) if flags[k]}
    tsps = tsp.erk_sparsities(tsp.param_shapes(tp), 0.5)
    got = tsp.random_masks_from_sparsities(tp, lambda n, s: tsps[n],
                                           scores=scores)
    for k, v in jax_params_to_torch(pc.np_tree(want)).items():
        assert torch.equal(got[k], v), k


def test_cosine_annealing_bitwise():
    for total in (1, 3, 7, 10, 50, 100, 300, 1000):
        for factor in (0.5, 0.3):
            fn = jax.jit(lambda r: jsp.cosine_annealing(factor, r, total))
            for r in range(total + 1):
                want = np.asarray(fn(jnp.float32(r)))
                got = tsp.cosine_annealing(factor, r, total)
                assert got.dtype == torch.float32
                assert got.numpy() == want, (total, factor, r)


def _tie_tree(rs, shapes, lead=()):
    """Weights quantized to eighths: many exact ties of magnitude."""
    return {k: np.round(rs.randn(*(lead + s)) * 8).astype(np.float32) / 8
            for k, s in shapes.items()}


def test_fire_regrow_prune_bitwise_over_a_schedule():
    """Every round of a 12-round schedule of DisPFL's evolution (the rate,
    fire, the live counts, regrow) and SubAvg's prune, one client (jitted
    as in the round program) and three stacked (vmapped), bitwise."""
    rs = np.random.RandomState(2)
    shapes = {"l0.kernel": (6, 4, 3), "l1.kernel": (50,), "l1.bias": (5,),
              "l2.kernel": (7, 9)}
    total = 12

    def nest(tree):  # the reference's nested scopes
        out = {}
        for k, v in tree.items():
            scope, leaf = k.split(".")
            out.setdefault(scope, {})[leaf] = v
        return out

    def flat(tree):
        return {f"{s}.{k}": v for s, d in tree.items() for k, v in d.items()}

    def j_evolve(m, p, g, r):
        rate = jsp.cosine_annealing(0.5, r, total)
        before = jsp.live_counts(m)
        fired = jsp.fire_mask(m, p, drop_rate=rate)
        n = jax.tree_util.tree_map(lambda b, f: b - f, before,
                                   jsp.live_counts(fired))
        return fired, jsp.regrow_mask(fired, g, n), \
            jsp.magnitude_prune_mask(m, p, 0.2), \
            jsp.mask_distance(m, fired), jsp.mask_density(p)

    one = jax.jit(j_evolve)
    stacked = jax.jit(jax.vmap(j_evolve, in_axes=(0, 0, 0, None)))
    for lead, fn in (((), one), ((N,), stacked)):
        masks = {k: (rs.rand(*(lead + s)) < 0.5).astype(np.float32)
                 for k, s in shapes.items()}
        masks["l1.bias"][...] = 1.0
        t_masks = {k: torch.from_numpy(v) for k, v in masks.items()}
        for r in range(total + 1):
            p, g = _tie_tree(rs, shapes, lead), _tie_tree(rs, shapes, lead)
            p["l0.kernel"] *= 0  # a leaf of zeros: all tied
            jfired, jnew, jpruned, jdist, jdens = fn(
                nest(masks), nest(p), nest(g), jnp.float32(r))
            jfired, jnew, jpruned = flat(jfired), flat(jnew), flat(jpruned)
            tp = {k: torch.from_numpy(v) for k, v in p.items()}
            tg = {k: torch.from_numpy(v) for k, v in g.items()}
            lead_n = len(lead)
            rate = tsp.cosine_annealing(0.5, r, total)
            before = tsp.live_counts(t_masks, lead=lead_n)
            fired = tsp.fire_mask(t_masks, tp, rate, lead=lead_n)
            after = tsp.live_counts(fired, lead=lead_n)
            new = tsp.regrow_mask(fired, tg, {k: before[k] - after[k]
                                              for k in before}, lead=lead_n)
            pruned = tsp.magnitude_prune_mask(t_masks, tp, 0.2, lead=lead_n)
            for k in shapes:
                np.testing.assert_array_equal(fired[k].numpy(),
                                              np.asarray(jfired[k]))
                np.testing.assert_array_equal(new[k].numpy(),
                                              np.asarray(jnew[k]))
                np.testing.assert_array_equal(pruned[k].numpy(),
                                              np.asarray(jpruned[k]))
                # fire then regrow keeps the live counts (no ties at the
                # regrow threshold here: the scores are fresh draws)
            assert tsp.mask_distance(t_masks, fired, lead=lead_n).numpy() \
                .tolist() == np.asarray(jdist).tolist()
            assert tsp.mask_density_f32(tp, lead=lead_n).numpy().tolist() \
                == np.asarray(jdens).tolist()
            masks = {k: np.asarray(v) for k, v in jnew.items()}
            t_masks = new


# -- the kernel route ---------------------------------------------------------

def _j_chain(hp, mask_grads, post, prox):
    """The reference's local optimizer step (``core/trainer.py``'s
    ``apply_update``, its XLA chain), spelled with its functions."""
    def step(params, mom, grads, mask, lr, target):
        grads = joptim.clip_by_global_norm(grads, hp.grad_clip)
        if mask_grads:
            grads = jax.tree_util.tree_map(lambda g, m: g * m, grads, mask)
        params, mom = joptim.sgd_momentum_step(
            params, mom, grads, lr, hp.momentum, hp.weight_decay)
        if prox:
            params = jax.tree_util.tree_map(
                lambda p, g: p - lr.astype(p.dtype) * prox * (p - g),
                params, target)
        if post:
            params = jax.tree_util.tree_map(lambda p, m: p * m, params, mask)
        return params, mom

    return jax.jit(step)


@pytest.mark.parametrize("route", ["dispfl", "subavg", "plain", "prox"])
def test_kernel_route_against_reference(route):
    """Ten local optimizer steps, carried, from weights that are zero off
    the mask with zero momentum (small gradients: the clip scale is
    exactly 1): DisPFL's and SubAvg's step (the masked SGD kernel's
    ``mask_grads`` branch, no post-step mask), Local's, DPSGD's and
    Ditto's (plain SGD over an all-ones mask) and Ditto's personal step
    (then the prox pull).

    * Bitwise the reference's kernel route: its Pallas masked SGD kernel
      (interpret mode), which skips the post-step mask under
      ``mask_grads`` too, and for the pull the reference's own spelling of
      it, jitted (XLA contracts it into one fused multiply-add).
    * Against its default XLA chain, which masks the gradient and (DisPFL)
      the weights after the step, from the same inputs each step: the
      off-mask weights and momenta zero on both sides (the post-step mask
      changes no bit); the rest within one rounding: XLA:CPU fuses the
      step's multiply-adds its own way (``g * mask + wd * p`` becomes
      ``fma(g, mask, wd * p)``, rounding ``wd * p`` first, and which
      products it contracts changes with the fusion around them), where
      the kernel rounds each multiply-add once. So the momenta agree
      within one ulp of the decayed gradient plus their own rounding, the
      weights within that through the rate plus theirs."""
    from neuroimagedisttraining_tpu.ops import pallas_kernels as pk

    hp = HyperParams(lr=0.05, momentum=0.9, weight_decay=5e-4,
                     grad_clip=10.0)
    jhp = JHyperParams(lr=0.05, momentum=0.9, weight_decay=5e-4,
                       grad_clip=10.0)
    prox = 0.5 if route == "prox" else 0.0
    masked = route in ("dispfl", "subavg")
    chain = _j_chain(jhp, mask_grads=masked, post=route == "dispfl",
                     prox=prox)
    kernel = jax.jit(lambda p, m, g, k, lr: pk.fused_masked_sgd_step(
        p, m, joptim.clip_by_global_norm(g, jhp.grad_clip), k, lr,
        momentum=jhp.momentum, wd=jhp.weight_decay, mask_grads=masked))
    # the pull as the reference's core/trainer.py spells it
    pull_ref = jax.jit(lambda params, target, lr: jax.tree_util.tree_map(
        lambda p, g: p - lr.astype(p.dtype) * prox * (p - g), params,
        target))
    rs = np.random.RandomState(5)
    shapes = {"a.kernel": (64, 9), "b.kernel": (300,), "b.bias": (7,)}
    mask = {k: ((rs.rand(*s) < 0.5) if masked else np.ones(s)).astype(
        np.float32) for k, s in shapes.items()}
    params = {k: (rs.randn(*s).astype(np.float32) * mask[k])
              for k, s in shapes.items()}
    target = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    mom = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    names = list(shapes)
    t_p = [torch.from_numpy(params[k].copy()) for k in names]
    t_m = [torch.zeros(shapes[k]) for k in names]
    lr = torch.tensor(f32(0.05) * f32(0.998) ** 3)
    jlr = jnp.asarray(lr.numpy())
    pull = -(lr * torch.tensor(prox, dtype=torch.float32)) if prox else None
    live = [torch.from_numpy(mask[k]) != 0 for k in names]
    for _ in range(10):
        grads = {k: (rs.randn(*s) * 0.01).astype(np.float32)
                 for k, s in shapes.items()}
        same = ({k: p.numpy().copy() for k, p in zip(names, t_p)},
                {k: m.numpy().copy() for k, m in zip(names, t_m)})
        params, mom = kernel(params, mom, grads, mask, jlr)
        if prox:
            params = pull_ref(params, target, jlr)
        cp, cm = chain(*same, grads, mask, jlr, target)
        optimizer_step(t_p, t_m, [torch.from_numpy(grads[k]) for k in names],
                       [torch.from_numpy(mask[k]) for k in names], lr, hp,
                       mask_grads=masked, pull=pull,
                       targets=[torch.from_numpy(target[k]) for k in names])
        for i, k in enumerate(names):
            gp, gm = t_p[i].numpy(), t_m[i].numpy()
            for got, want in ((gp, params[k]), (gm, mom[k])):
                np.testing.assert_array_equal(
                    got.view(np.int32), np.asarray(want).view(np.int32),
                    err_msg=k)
            off = ~live[i].numpy()
            wp, wm = np.asarray(cp[k]), np.asarray(cm[k])
            assert not (gp[off].any() or wp[off].any() or gm[off].any()
                        or wm[off].any())
            g_wd = (np.abs(grads[k]) + 5e-4 * np.abs(same[0][k])).astype(
                np.float32)
            bound = np.spacing(g_wd) + np.spacing(np.abs(wm))
            assert (np.abs(gm - wm) <= bound).all(), k
            bound = float(lr) * bound + 2 * np.spacing(np.abs(wp))
            assert (np.abs(gp - wp) <= bound).all(), k


# -- two rounds of each algorithm against the reference -------------------------

def _perms(keys, c, epochs=1):
    return [np.array(epoch_permutations(
        jax.random.split(keys[i])[0], jnp.int32(c["nvals"][int(s)]), epochs,
        c["spe"] * pc.BS, n_rows=c["n_rows"]))
        for i, s in enumerate(c["sel"])]


def _draws(name, rng, c):
    """The reference's draws of one round of ``name`` from its state key:
    the next key and the port's seams (each leg's epoch permutations)."""
    s = len(c["sel"])
    if name == "ditto":
        rng, k_global, k_personal = jax.random.split(rng, 3)
        return rng, dict(
            perms=_perms(jax.random.split(k_global, s + 1), c),
            perms_2=_perms(jax.random.split(k_personal, s), c,
                           epochs=PERSONAL_EPOCHS))
    rng, round_key = jax.random.split(rng)
    keys = jax.random.split(round_key, s)
    seams = dict(perms=_perms(keys, c))
    epochs = RUNS[name][2]
    if name == "subavg" and epochs > 1:  # the later epochs' leg
        seams["perms_2"] = _perms([jax.random.fold_in(k, 1) for k in keys],
                                  c, epochs=epochs - 1)
    return rng, seams


#: Ditto's personal-leg epochs (``--local_epochs``)
PERSONAL_EPOCHS = 2
#: algorithm -> (its options, frac, local epochs, data seed)
RUNS = {
    "local": (dict(), 0.67, 1, 4),
    "dpsgd": (dict(neighbor_mode="random"), 0.34, 1, 5),
    "subavg": (dict(acc_thresh=0.4), 0.67, 2, 4),
    "ditto": (dict(lamda=0.5), 0.67, 1, 4),
}
_REFERENCE = {}
_COHORTS = {}


def _cohort(name):
    seed = RUNS[name][3]
    if seed not in _COHORTS:
        _COHORTS[seed] = pc.cohort(seed)
    return _COHORTS[seed]


def _hps(name, c):
    epochs = RUNS[name][2]
    return (dataclasses.replace(pc.hp(HyperParams, c["spe"]),
                                local_epochs=epochs),
            pc.hp(JHyperParams, c["spe"]).replace(local_epochs=epochs))


def _algo(name, c, jax_side):
    hp, jhp = _hps(name, c)
    opts, frac = RUNS[name][:2]
    kw = dict(loss_type="bce", frac=frac, seed=0, **opts)
    if name == "ditto":  # the personal leg's --local_epochs
        kw["personal_hp"] = (
            jhp.replace(local_epochs=PERSONAL_EPOCHS) if jax_side else
            dataclasses.replace(hp, local_epochs=PERSONAL_EPOCHS))
    cls = {"local": "LocalOnly", "dpsgd": "DPSGD", "subavg": "SubAvg",
           "ditto": "Ditto"}[name]
    if jax_side:
        return getattr(jalgos, cls)(c["jm"], c["jd"], jhp, **kw)
    return getattr(talgos, cls)(c["tm"], c["td"], hp, device="cpu", **kw)


def reference(name):
    """A run's reference rounds, made once per module: its initial state,
    and after each round its state, metrics, eval and draws."""
    c = _cohort(name)
    if name not in _REFERENCE:
        jalgo = _algo(name, c, jax_side=True)
        jstate = jalgo.init_state(jax.random.PRNGKey(0))
        rounds, rng, s = [], jstate.rng, jstate
        for r in range(2):
            sel = (np.arange(N) if name == "dpsgd"
                   else jalgo._selected_client_indexes(r))
            rng, seams = _draws(name, rng, dict(c, sel=sel))
            s, met = jalgo.run_round(s, r)
            ev = jalgo.evaluate(s)
            rounds.append((s, {k: float(v) for k, v in met.items()},
                           {k: np.asarray(v) for k, v in ev.items()}, seams))
        _REFERENCE[name] = dict(init=jstate, rounds=rounds)
    return _REFERENCE[name]


@pytest.mark.parametrize("name", list(RUNS))
def test_two_rounds_match_reference(name):
    c, ref = _cohort(name), reference(name)
    algo = _algo(name, c, jax_side=False)
    init = ref["init"]
    if hasattr(init, "global_params"):
        params = jax_params_to_torch(pc.np_tree(init.global_params))
    else:
        params = {k: v[0] for k, v in pc.stack(init.personal_params).items()}
    state = algo.init_state(params=params)
    masks_changed = False
    for r, (jstate, jmet, jev, seams) in enumerate(ref["rounds"]):
        state, met = algo.run_round(state, r, **seams)
        assert sorted(met) == sorted(jmet)
        for k in met:
            np.testing.assert_allclose(float(met[k]), jmet[k], rtol=1e-5,
                                       err_msg=f"{name} round {r} {k}")
        for field in ("global_params", "personal_params"):
            if hasattr(jstate, field):
                pc.compare(getattr(state, field), getattr(jstate, field),
                           "f32", stacked=field == "personal_params",
                           leaf_scale=True)
        if name == "subavg":
            want = pc.stack(jstate.masks)
            for k, v in want.items():
                assert torch.equal(state.masks[k], v), (r, k)
            masks_changed |= any(bool((v == 0).any()) for v in want.values())
        ev = algo.evaluate(state)
        assert sorted(ev) == sorted(jev)
        np.testing.assert_array_equal(ev["acc_per_client"].numpy(),
                                      jev["acc_per_client"])
        for k in ev:
            if k != "acc_per_client":
                np.testing.assert_allclose(float(ev[k]), float(jev[k]),
                                           rtol=2e-5, err_msg=k)
    if name == "subavg":
        assert masks_changed  # the gates accepted a pruned mask


def test_personal_algorithms_refuse_central_options(cohort):
    c = cohort
    for cls in (talgos.LocalOnly, talgos.DPSGD, talgos.DisPFL,
                talgos.SubAvg):
        with pytest.raises(ValueError, match="no central aggregate"):
            cls(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                device="cpu", fault_spec="drop=0.2")
    # the fused loop runs them: the unfused history but round_time_s
    algo = talgos.LocalOnly(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                            device="cpu", frac=0.67)
    s0 = algo.init_state()
    _, hist_u = algo.run(2, state=algo.clone_state(s0))
    _, hist_f = algo.run(2, state=s0, fuse_rounds=2)
    assert [{k: v for k, v in h.items() if k != "round_time_s"}
            for h in hist_f] == [{k: v for k, v in h.items()
                                  if k != "round_time_s"} for h in hist_u]


# -- the CLI --------------------------------------------------------------------

SMALL = ["--dataset", "synthetic", "--model", "small3dcnn"]
ALGOS = ("dispfl", "subavg", "ditto", "local", "dpsgd")
CLI_LINES = [
    ("dispfl", SMALL + ["--cs", "ring", "--active", "0.7", "--uniform",
                        "--different_initial", "--save_masks",
                        "--record_mask_diff"]),
    (None, ["--algo", "dispfl", "--static", "--diff_spa",
            "--dis_gradient_check", "--erk_power_scale", "0.5"] + SMALL),
    ("subavg", SMALL + ["--each_prune_ratio", "0.3", "--dist_thresh",
                        "0.01", "--acc_thresh", "0.6"]),
    (None, ["--algo", "ditto", "--lamda", "0.1", "--local_epochs", "3",
            "--agg_impl", "int8"] + SMALL),
    ("local", SMALL + ["--frac", "0.5"]),
    (None, ["--algo", "dpsgd", "--cs", "full"] + SMALL),
]


@pytest.mark.parametrize("algo,argv", CLI_LINES,
                         ids=[" ".join([a or "unified"] + v)
                              for a, v in CLI_LINES])
def test_cli_namespaces_and_identities_match_reference(algo, argv):
    j = jconfig.parse_args(argv, algo)
    t = tconfig.parse_args(argv, algo)
    tv = vars(t)
    assert tv.pop("device") == "cuda"
    assert tv == vars(j)
    for ck in (False, True):
        assert tconfig.run_identity(t, algo, for_checkpoint=ck) == \
            jconfig.run_identity(j, algo, for_checkpoint=ck)


#: (argv, what the refusal says): the JAX CLI's refusals for these
#: algorithms: fused blocks of evolving masks (dynamic DisPFL, SubAvg) and of
#: the two algorithms without a fused loop among them
CLI_REFUSALS = [
    (["--algo", "dispfl", "--agg_impl", "int8"], "--agg_impl int8 routes"),
    (["--algo", "ditto", "--agg_impl", "topk"], "--agg_impl topk carries"),
    (["--algo", "ditto", "--agg_impl", "sparse"], "--agg_impl sparse needs"),
    (["--algo", "ditto", "--defense_type", "weak_dp"],
     "--defense_type weak_dp guards"),
    (["--algo", "ditto", "--eval_cache", "1"], "--eval_cache caches"),
    (["--algo", "subavg", "--fault_spec", "drop=0.2"],
     "--fault_spec/--guard protect"),
    (["--algo", "dpsgd", "--robust_agg", "median"],
     "--robust_agg median replaces"),
    (["--algo", "subavg", "--fuse_rounds", "2"],
     "--fuse_rounds: subavg's per-round cost accounting"),
    (["--algo", "dispfl", "--fuse_rounds", "2"],
     "--fuse_rounds: dispfl's per-round cost accounting"),
    (["--algo", "dispfl", "--active", "0.5", "--dis_gradient_check",
      "--fuse_rounds", "3"], "--fuse_rounds: dispfl's per-round cost"),
    (["--algo", "subavg", "--epochs", "2", "--fuse_rounds", "4"],
     "--fuse_rounds: subavg's per-round cost accounting"),
    (["--algo", "fedfomo", "--fuse_rounds", "2"],
     "--fuse_rounds: fedfomo has data-dependent per-round host work"),
    (["--algo", "turboaggregate", "--fuse_rounds", "2"],
     "--fuse_rounds: turboaggregate has data-dependent per-round host work"),
]


@pytest.mark.parametrize("argv,says", CLI_REFUSALS,
                         ids=[" ".join(a) for a, _ in CLI_REFUSALS])
def test_cli_refusals_match_reference(tmp_path, argv, says):
    def full(side):
        return argv + SMALL + ["--comm_round", "1", "--results_dir",
                               str(tmp_path / side / "res"), "--log_dir", ""]

    with pytest.raises(SystemExit) as e:
        trunner.main(full("t") + ["--device", "cpu"])
    msg = str(e.value.code)
    assert msg.startswith(says), msg
    assert not (tmp_path / "t").exists()
    with pytest.raises(SystemExit) as je:
        jrunner.main(full("j"))
    assert str(je.value.code) == msg


@pytest.mark.parametrize("algo", ["ditto", "local", "dpsgd", "dispfl"])
def test_cli_fused_loop_refused_by_item(tmp_path, algo):
    """``--fuse_rounds 2`` for ditto, local, dpsgd and ``dispfl --static``
    (the baselines the JAX CLI fuses) through ``runner.main``: three rounds
    in blocks of 2 and 1, the eval after each, every record the unfused
    run's but ``round_time_s`` (DisPFL's local-test series and mask change
    included), the cost counters and the final eval too."""
    extra = ["--static"] if algo == "dispfl" else []

    def run(tag, *fuse):
        return trunner.main(["--algo", algo, "--comm_round", "3", "--frac",
                             "0.5", "--device", "cpu", "--results_dir",
                             str(tmp_path / tag), "--log_dir", ""]
                            + SMALL + extra + list(fuse))

    unfused, fused = run("u"), run("f", "--fuse_rounds", "2")

    def records(res):
        return [{k: v for k, v in h.items() if k != "round_time_s"}
                for h in res["history"]]

    assert records(fused) == records(unfused)
    assert len([h for h in fused["history"] if h["round"] >= 0]) == 3
    if algo == "dispfl":
        assert all("old_mask_test_acc" in h and "mask_change" in h
                   for h in fused["history"] if h["round"] >= 0)
    assert {k: float(v) for k, v in fused["final_eval"].items()
            if np.ndim(v) == 0} == {k: float(v) for k, v in
                                    unfused["final_eval"].items()
                                    if np.ndim(v) == 0}


CLI_RUNS = [(a, ["--save_masks", "--record_mask_diff"] if a == "dispfl"
             else []) for a in ALGOS] + [
    # Ditto's global leg under faults, the guard and a robust statistic on
    # the int8 wire
    ("ditto", ["--fault_spec", "drop=0.25,nan=0.25", "--robust_agg",
               "median", "--agg_impl", "int8"]),
]


@pytest.mark.parametrize("algo,extra", CLI_RUNS,
                         ids=[" ".join([a] + e) for a, e in CLI_RUNS])
def test_cli_runs_end_to_end(tmp_path, algo, extra):
    """Each algorithm through ``runner.main`` (and its ``main_<algo>``'s
    module) on the CPU: two rounds, the eval after each, ``stat_info`` with
    the JAX CLI's keys, the cost counters, DisPFL's extras."""
    argv = SMALL + ["--comm_round", "2", "--frac", "0.5", "--device", "cpu",
                    "--results_dir", str(tmp_path / "res"), "--log_dir",
                    str(tmp_path / "log")] + extra
    mod = __import__(f"neuroimagedisttraining_torch.experiments.main_{algo}",
                     fromlist=["main"])
    res = mod.main(argv, algo=algo)
    rounds = [h for h in res["history"] if h["round"] >= 0]
    assert len(rounds) == 2
    assert all(math.isfinite(h["train_loss"]) for h in rounds)
    assert all(h["sum_training_flops"] > 0 for h in rounds)
    with open(res["stat_path"], "rb") as f:
        stat = pickle.load(f)
    assert os.path.isfile(res["stat_path"] + ".json")
    assert stat["avg_inference_flops"] > 0
    if algo == "dispfl":
        assert len(stat["old_mask_test_acc"]) == 2
        assert len(stat["new_mask_test_acc"]) == 2
        assert set(stat["final_masks"]) == set(res["state"].masks)
        assert stat["mask_distance_matrix"].shape == (8, 8)
    if algo in ("dispfl", "subavg"):
        assert "mean_mask_density" in stat["final_eval"]


def test_cli_stat_info_matches_reference(tmp_path):
    """The per-client-mask algorithms' ``stat_info`` has the JAX CLI's
    keys, and its cost counters count every client DisPFL trains each
    round (the sampled ones for SubAvg). The counts themselves follow each
    side's own draws: regrow grows every dead weight tied at the threshold
    (a zero gradient ties many), and a bias a dead unit never moves stays
    zero, so they are not compared across frameworks."""
    for algo in ("dispfl", "subavg"):
        def argv(side):
            return ["--algo", algo] + SMALL + [
                "--comm_round", "2", "--frac", "0.5", "--results_dir",
                str(tmp_path / side), "--log_dir", ""]

        t = trunner.main(argv("t") + ["--device", "cpu"])
        j = jrunner.main(argv("j"))
        with open(t["stat_path"], "rb") as f:
            ts = pickle.load(f)
        with open(j["stat_path"], "rb") as f:
            js = pickle.load(f)
        assert sorted(ts) == sorted(k for k in js if k != "obs_metrics")
        assert sorted(ts["final_eval"]) == sorted(js["final_eval"])
        per_round = [h["sum_training_flops"] for h in t["history"]
                     if h["round"] >= 0]
        assert 0 < per_round[0] < per_round[1]
        built = trunner.build_algorithm(
            tconfig.parse_args(argv("t2") + ["--device", "cpu"]), algo)[0]
        assert built.cost_trained_clients_per_round() == (
            8 if algo == "dispfl" else 4)
