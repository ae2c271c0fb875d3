"""SalientGrads on ``resnet18`` (``num_blocks`` (1, 1, 1, 1)) with the crop
and flip, against the JAX package run in float64, on the CPU:
``tests/test_torch_port_augment_round.py``'s cohort, draws and bounds
otherwise (its module docstring says why the reference's float32 run is no
measure here). The comparison runs in a subprocess whose JAX is in x64 mode
(its draws too, which the port is fed), in about two minutes; the port
runs the rounds in float32 and in float64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


#: the rows' bound, elementwise (``test_torch_port_resnet3d_round.py``'s)
RTOL, ATOL = 1e-5, 2e-7
#: a float32 leaf the reference's own float32 run keeps within this of
#: its float64 one (norm-wise) is well-conditioned: the port's float32 run
#: is held there to the same distance
WELL_CONDITIONED = 1e-5
#: every float32 leaf's cap against the float64 reference, norm-wise
#: (twice the port's worst leaf, 2.4e-2, a GroupNorm bias; the reference's
#: own float32 run reaches 1.3e-1 there)
F32_CAP = 5e-2

#: the float64 comparison of ``resnet18``, run in a subprocess whose JAX is
#: in x64 mode (draws and all): prints one JSON line of per-leaf errors
#: against the reference's float64 run: the port's float32 rows'
#: (norm-wise), the reference's float32 rows' (norm-wise), and the port's
#: float64 rows' (the largest ratio of an element's distance to
#: ``ATOL + RTOL * |want|``) and their dtype
_F64_CODE = """
import json, sys, dataclasses
import jax
RTOL, ATOL = %r, %r
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp, torch
import test_torch_port_augment_round as t
torch.set_num_threads(1)
def f64(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)
def run(dtype):
    jd, td = t._data()
    if dtype == "f64":
        jd = dataclasses.replace(jd, x_train=jd.x_train.astype(jnp.float64),
                                 x_test=jd.x_test.astype(jnp.float64))
    ja, ta = t._algos("salientgrads", "resnet18", jd, td)
    js = ja.init_state(jax.random.PRNGKey(0))
    g0 = t.jax_params_to_torch(t.pc.np_tree(js.global_params))
    js = dataclasses.replace(js, mask=jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), js.mask))
    if dtype == "f64":
        js = dataclasses.replace(js, global_params=f64(js.global_params),
                                 personal_params=f64(js.personal_params),
                                 mask=f64(js.mask))
    return ja, ta, jd, td, js, g0
ja, ta, jd, td, js, g0 = run("f64")
ja32, _, jd32, _, js32, _ = run("f32")
idx, aug = t._snip_draws()
_, m_rng, _ = jax.random.split(jax.random.PRNGKey(0), 3)
ckeys = jax.random.split(m_rng, t.N_CLIENTS)
jscore = jax.jit(t.jsp.make_snip_score_fn(
    t.japply(ja.model), "ce", t.BS, augment_fn=ja.augment_fn),
    static_argnums=5)
tscore = t.tsp.make_snip_score_fn(t.make_apply_fn(ta.model), "ce", t.BS,
                                  augment_fn=ta.augment_fn)
jscore32 = jax.jit(t.jsp.make_snip_score_fn(
    t.japply(ja32.model), "ce", t.BS, augment_fn=ja32.augment_fn),
    static_argnums=5)
def scores(fn, st, d, c):
    return t.jax_params_to_torch(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), fn(
            st.global_params, d.x_train[c], d.y_train[c],
            jnp.int32(t.SAMPLES), ckeys[c], 1)))
snip = []
for c in range(t.N_CLIENTS):
    want = scores(jscore, js, jd, c)
    ref32 = scores(jscore32, js32, jd32, c)
    got = tscore(g0, td.x_train[c], td.y_train[c], t.SAMPLES, 1,
                 idx=idx[c], augment=aug[c])
    snip.append([max(t.pc.rel(got[k].double(), want[k]) for k in want),
                 max(t.pc.rel(ref32[k], want[k]) for k in want)])
init = ta.init_state(params=g0, snip_idx=idx, snip_augment=aug)
jmask = t.jax_params_to_torch(jax.tree_util.tree_map(np.asarray, js.mask))
agree = sum(int((init.mask[k] == v.float()).sum()) for k, v in jmask.items())
state = t.SalientGradsState(
    global_params=g0, mask={k: v.float() for k, v in jmask.items()},
    personal_params=t.broadcast_tree(g0, t.N_CLIENTS),
    generator=torch.Generator())
_, ta64 = t._algos("salientgrads", "resnet18", jd, dataclasses.replace(
    td, x_train=td.x_train.double(), x_test=td.x_test.double()))
g64 = {k: v.double() for k, v in g0.items()}
state64 = t.SalientGradsState(
    global_params=g64, mask=dict(state.mask),
    personal_params=t.broadcast_tree(g64, t.N_CLIENTS),
    generator=torch.Generator())
rng, losses = js.rng, []
for r in range(2):
    rng, perms, augs = t._round_draws(rng, ta.hp.local_steps)
    js, jmet = ja.run_round(js, r)
    js32, _ = ja.run_round(js32, r)
    state, tmet = ta.run_round(state, r, perms=perms, augment=augs)
    state64, _ = ta64.run_round(state64, r, perms=perms, augment=augs)
    losses.append([float(tmet["train_loss"]), float(jmet["train_loss"])])
def rows(tree, lead):
    return t.jax_params_to_torch(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), tree), lead=lead)
out = {"snip": snip, "mask_agree": agree / sum(v.numel()
                                               for v in jmask.values()),
       "losses": losses, "leaves": {}}
for f, lead in (("global_params", 0), ("personal_params", 1)):
    want, ref32 = rows(getattr(js, f), lead), rows(getattr(js32, f), lead)
    got, got64 = getattr(state, f), getattr(state64, f)
    for k in want:
        w = want[k].numpy()
        out["leaves"][f + "." + k] = [
            t.pc.rel(got[k].double(), want[k]),
            t.pc.rel(ref32[k], want[k]),
            float(np.max(np.abs(got64[k].numpy() - w)
                         / (ATOL + RTOL * np.abs(w)))),
            str(got64[k].dtype)]
print(json.dumps(out))
""" % (RTOL, ATOL)


def test_resnet18_augmented_against_float64_reference():
    """SalientGrads on ``resnet18`` with the crop and flip against the
    reference's float64 run (module docstring). The port in float64: every
    row after 2 rounds, of every leaf, elementwise within rtol 1e-5 and
    atol 2e-7. The port in float32: each client's SNIP scores within 1e-4
    of the distance the reference's own float32 run keeps from float64
    (the worst leaf of a client's scores, norm-wise); the mask within 0.1%
    of the float64 SNIP's; the train losses within rtol 1e-5; each row
    norm-wise within 1e-5 of float64 where the reference's float32 row is
    (WELL_CONDITIONED), else no further than the reference's float32 row
    plus 1e-5, and under F32_CAP."""
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _F64_CODE], cwd=here,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(got <= ref + 1e-4 for got, ref in res["snip"]), res["snip"]
    assert res["mask_agree"] > 0.999
    for got, want in res["losses"]:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    leaves = res["leaves"]
    assert {v[3] for v in leaves.values()} == {"torch.float64"}
    off64 = {k: v[2] for k, v in leaves.items() if v[2] > 1.0}
    assert not off64, off64
    well = {k: v[0] for k, v in leaves.items() if v[1] < WELL_CONDITIONED}
    assert well and all(v <= WELL_CONDITIONED for v in well.values()), well
    worse = {k: v[:2] for k, v in leaves.items()
             if v[0] > min(v[1] + 1e-5, F32_CAP)}
    assert not worse, worse
