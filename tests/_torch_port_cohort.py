"""Shared by the port's wire tests (``tests/test_torch_port_wires.py``,
``tests/test_torch_port_fedavg.py``) and CLI and data tests
(``tests/test_torch_port_cli.py``, ``tests/test_torch_port_data.py``):
``tests/test_torch_port_round.py``'s narrow cohort, the reference's per-round
random draws (epoch permutations, the int8 wire's uniforms) and the
comparisons of the two sides' trees and datasets."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from neuroimagedisttraining_tpu.core.trainer import epoch_permutations
from neuroimagedisttraining_tpu.data import make_synthetic_federated as jsynth
from neuroimagedisttraining_tpu.models import create_model as jcreate
from neuroimagedisttraining_tpu.ops.s2d import phased_sample_shape
from neuroimagedisttraining_torch.convert import jax_params_to_torch
from neuroimagedisttraining_torch.data import make_synthetic_federated
from neuroimagedisttraining_torch.models import create_model
from neuroimagedisttraining_torch.parallel import collectives as tc

WIDTHS = (8, 16, 16, 16, 16)
SS = phased_sample_shape((69, 69, 69))
N_CLIENTS, SAMPLES, TEST, BS = 3, 6, 5, 4
#: 4096-value buckets cut inside the narrow model's leaves
BUCKET, DENSITY = 4096, 0.1
AGG_SALT = 0x616767  # the reference's fold_in of the int8 draw ("agg")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def models():
    kw = dict(num_classes=1, widths=WIDTHS, dropout_rate=0.0)
    return (jcreate("3dcnn_s2d", **kw),
            create_model("3dcnn_s2d", sample_shape=SS, **kw))


def data(seed=4):
    kw = dict(seed=seed, n_clients=N_CLIENTS, samples_per_client=SAMPLES,
              test_per_client=TEST, sample_shape=SS, uneven=True)
    return jsynth(**kw), make_synthetic_federated(**kw)


def hp(cls, spe):
    return cls(lr=0.01, lr_decay=0.998, momentum=0.9, weight_decay=5e-4,
               grad_clip=10.0, local_epochs=1, steps_per_epoch=spe,
               batch_size=BS)


def cohort(seed=4):
    """Both sides' models and data (of data seed ``seed``), the step count,
    the shard length and the parameter count."""
    jm, tm = models()
    jd, td = data(seed)
    nvals = [int(n) for n in np.asarray(jd.n_train)]
    n_params = sum(p.numel() for p in tm.parameters())
    return dict(jm=jm, tm=tm, jd=jd, td=td, nvals=nvals,
                spe=-(-max(nvals) // BS), n_rows=jd.x_train.shape[1],
                n_params=n_params)


def stack(j_stacked):
    """A reference ``[C, ...]`` stack as this package's stacked tree."""
    rows = [jax_params_to_torch(np_tree(jax.tree_util.tree_map(
        lambda a: a[c], j_stacked))) for c in range(N_CLIENTS)]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def to_jax_tree(tree, template, lead=0):
    """This package's (stacked, with ``lead`` leading axes) tree as a
    reference param tree shaped like ``template`` (numpy leaves): the
    inverse of ``jax_params_to_torch``, each leaf in the reference's
    layout."""
    from neuroimagedisttraining_torch.convert import to_reference_layout

    def skeleton(node):
        return {k: skeleton(v) for k, v in node.items()} \
            if hasattr(node, "items") else None

    out = skeleton(template)
    for k, t in tree.items():
        *scope, leaf = k.split(".")
        node = out
        for name in scope:
            node = node[name]
        if set(node) == {"Conv_0"}:
            node = node["Conv_0"]
        node[leaf] = np.ascontiguousarray(
            to_reference_layout(k, t, lead=lead).numpy())
    return out


def perms_from_keys(keys, c):
    """The reference's epoch permutation of the client update run on
    ``keys[i]``, for every client."""
    return [np.array(epoch_permutations(
        jax.random.split(keys[i])[0], jnp.int32(c["nvals"][i]), 1,
        c["spe"] * c.get("bs", BS), n_rows=c["n_rows"]))
        for i in range(len(c["nvals"]))]


def draws(rng, c):
    """The reference's round draws from its state key: the next key, each
    client's epoch permutation and the int8 wire's uniforms."""
    rng, round_key = jax.random.split(rng)
    keys = jax.random.split(round_key, N_CLIENTS + 1)
    nb, b = tc.bucket_shape(c["n_params"], BUCKET)
    u = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(round_key, AGG_SALT), (N_CLIENTS, nb, b))))
    return rng, perms_from_keys(keys, c), u


def rel(a, b):
    return float(torch.linalg.vector_norm(a - b) /
                 max(float(torch.linalg.vector_norm(b)), 1e-30))


def compare(t_tree, j_tree, impl, stacked=False, tol=1e-4, leaf_scale=False):
    """The two sides' trees: norm-wise within ``tol`` on the rounding wires
    (int8, bf16), else per leaf within rtol 1e-5 and atol 2e-7 (the conv
    biases ahead of a GroupNorm hold only round-off, ~1e-10). With
    ``leaf_scale`` the atol is 1e-5 of the leaf's largest value instead,
    where every weight trains and an element's error follows its leaf's
    scale, not its own."""
    want = stack(j_tree) if stacked else jax_params_to_torch(np_tree(j_tree))
    assert sorted(want) == sorted(t_tree)
    if impl in ("int8", "bf16"):
        flat_t = torch.cat([t_tree[k].reshape(-1) for k in sorted(want)])
        flat_j = torch.cat([want[k].reshape(-1) for k in sorted(want)])
        assert rel(flat_t, flat_j) < tol, (impl, rel(flat_t, flat_j))
        return
    for k, v in want.items():
        atol = max(2e-7, 1e-5 * float(v.abs().max())) if leaf_scale else 2e-7
        np.testing.assert_allclose(t_tree[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=atol, err_msg=f"{impl} {k}")


def compare_residual(t_res, j_res, j_locals):
    """The top-k residual: the same coordinates shipped (zero residual) on
    both sides, and the rest within 1e-5 of the scale of the locals it is a
    difference of (|local - global| can be far below |local|, so a residual
    value's own relative error is not the measure)."""
    want, locals_ = stack(j_res), stack(j_locals)
    for k, v in want.items():
        assert torch.equal(t_res[k] == 0, v == 0), k
        err = float((t_res[k] - v).abs().max())
        assert err <= 1e-5 * float(locals_[k].abs().max()) + 2e-7, (k, err)


def wire_flips(t_locals, j_locals, impl, u) -> int:
    """Wire values (the int8 payload, or the bf16 casts) that differ between
    the two sides' last round, from each side's stacked locals on the same
    uniforms."""
    tm = tc.stacked_to_mat(t_locals)
    jm = tc.stacked_to_mat(stack(j_locals))
    if impl == "bf16":
        return int((tm.to(torch.bfloat16) != jm.to(torch.bfloat16)).sum())
    tq, _ = tc._quantize_int8(tc._buckets(tm, BUCKET), u)
    jq, _ = tc._quantize_int8(tc._buckets(jm, BUCKET), u)
    return int((tq != jq).sum())


FIELDS = ("x_train", "y_train", "n_train", "x_test", "y_test", "n_test",
          "x_val", "y_val", "n_val")


def write_cohort_file(path, volume, n, seed=0, sites=2):
    """An ABCD cohort file at ``path``: ``n`` uniform random volumes of
    ``volume``, random labels, ``sites`` sites of equal size; written by
    the port's writer (bitwise the reference's)."""
    from neuroimagedisttraining_torch.data import write_abcd_h5

    rng = np.random.RandomState(seed)
    write_abcd_h5(path, rng.rand(n, *volume).astype(np.float32),
                  rng.randint(0, 2, n), np.repeat(np.arange(sites),
                                                  n // sites))
    return path


def assert_data_equal(t, j):
    """Every array of two FederatedData bit for bit, ``class_num`` and the
    dtypes included (a missing validation split on both sides is equal)."""
    assert t.class_num == j.class_num
    for f in FIELDS:
        tv, jv = getattr(t, f), getattr(j, f)
        assert (tv is None) == (jv is None), f
        if tv is None:
            continue
        jv = np.asarray(jv)
        if tv.dtype == torch.bfloat16:
            assert str(jv.dtype) == "bfloat16", f
            tv, jv = tv.float().numpy(), jv.astype(np.float32)
        else:
            tv = tv.numpy()
        assert tv.dtype == jv.dtype, (f, tv.dtype, jv.dtype)
        np.testing.assert_array_equal(tv, jv, err_msg=f)
