"""The port's data layer and cost accounting against the JAX package's, on
the CPU, on the same numpy inputs: the partitioners, the synthetic and ABCD
loaders (one cohort file written by ``write_abcd_h5`` into ``tmp_path``, read
by both sides in the channels, flat and s2d layouts) bit for bit, and the
FLOPs and communication counters exactly.
"""
import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from _torch_port_cohort import assert_data_equal  # noqa: E402
from neuroimagedisttraining_tpu import data as jdata  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_tpu.ops.s2d import phased_sample_shape  # noqa: E402
from neuroimagedisttraining_tpu.utils import flops as jflops  # noqa: E402
from neuroimagedisttraining_torch import data as tdata  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.data import partition as tpart  # noqa: E402
from neuroimagedisttraining_torch.models import create_model  # noqa: E402
from neuroimagedisttraining_torch.utils import flops as tflops  # noqa: E402

# -- partitioners ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_partitioners_match_reference(seed):
    labels = np.random.RandomState(seed).randint(0, 10, size=1200)

    def same(a, b):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))

    t = tpart.dirichlet_partition(labels, 8, 10, 0.5,
                                  rng=np.random.RandomState(seed))
    j = jdata.dirichlet_partition(labels, 8, 10, 0.5,
                                  rng=np.random.RandomState(seed))
    same(t, j)
    assert tpart.record_data_stats(labels, t) == \
        jdata.record_data_stats(labels, j)
    for part, alpha in (("dir", 0.3), ("n_cls", 2), ("my_part", 2)):
        same(tpart.class_prior_partition(labels, 8, 10, part, alpha, seed),
             jdata.class_prior_partition(labels, 8, 10, part, alpha, seed))
    counts = tpart.record_data_stats(labels, t)
    y_test = np.random.RandomState(seed + 100).randint(0, 10, size=400)
    same(tpart.proportional_test_indices(y_test, counts, 8, 10,
                                         rng=np.random.RandomState(seed)),
         jdata.proportional_test_indices(y_test, counts, 8, 10,
                                         rng=np.random.RandomState(seed)))
    site = np.random.RandomState(seed).randint(0, 5, size=90)
    same(tpart.site_partition(site), jdata.site_partition(site))
    same(tpart.contiguous_reshard(101, 7), jdata.contiguous_reshard(101, 7))
    assert sorted(tdata.site_train_test_split(site)) == \
        sorted(jdata.site_train_test_split(site))
    for k, (tr, te) in tdata.site_train_test_split(site).items():
        jtr, jte = jdata.site_train_test_split(site)[k]
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(te, jte)


@pytest.mark.parametrize("val_fraction", [0.0, 0.1])
def test_load_federated_data_synthetic(val_fraction):
    kw = dict(client_number=5, val_fraction=val_fraction, seed=42,
              sample_shape=(8, 8, 8, 1), samples_per_client=16)
    assert_data_equal(tdata.load_federated_data("synthetic", **kw),
                      jdata.load_federated_data("synthetic", **kw))


def test_unported_datasets_refused():
    for name in ("cifar10", "cifar100", "tiny"):
        with pytest.raises(ValueError, match="ROADMAP item 11"):
            tdata.load_federated_data(name)
    assert tdata.AUGMENTABLE_DATASETS == jdata.AUGMENTABLE_DATASETS
    for name in ("cifar10", "Tiny", "abcd", "synthetic"):
        assert tdata.dataset_is_augmentable(name) == \
            jdata.dataset_is_augmentable(name)


# -- ABCD cohort files -------------------------------------------------------

@pytest.fixture(scope="module")
def cohort_file(tmp_path_factory):
    """Four sites of unequal size, 13x12x11 volumes, written by the port's
    writer; the test reads it back with the reference's writer too."""
    rng = np.random.RandomState(3)
    n = 70
    X = rng.rand(n, 13, 12, 11).astype(np.float32)
    y = rng.randint(0, 2, size=n)
    site = rng.choice([3, 5, 8, 11], size=n, p=[0.4, 0.3, 0.2, 0.1])
    d = tmp_path_factory.mktemp("abcd")
    path = str(d / "final_dataset_70subs.h5")
    tdata.write_abcd_h5(path, X, y, site)
    jpath = str(d / "reference_written.h5")
    jdata.write_abcd_h5(jpath, X, y, site)
    return path, jpath


def test_write_abcd_h5_matches_reference(cohort_file):
    path, jpath = cohort_file
    with h5py.File(path, "r") as a, h5py.File(jpath, "r") as b:
        for k in ("X", "y", "site"):
            np.testing.assert_array_equal(a[k][()], b[k][()])
            assert a[k].dtype == b[k].dtype and a[k].chunks == b[k].chunks
    assert tdata.abcd_site_count(path) == 4


@pytest.mark.parametrize("dataset", ["abcd", "abcd_site", "abcd_rescale"])
@pytest.mark.parametrize("layout,spec", [("channels", None), ("flat", None),
                                         ("s2d", (5, 0)), ("s2d", (3, 1))])
@pytest.mark.parametrize("val_fraction", [0.0, 0.1])
def test_abcd_loaders_match_reference(cohort_file, dataset, layout, spec,
                                      val_fraction):
    path, _ = cohort_file
    kw = dict(data_dir=path, client_number=3, val_fraction=val_fraction,
              layout=layout)
    if spec is not None:
        kw["s2d_spec"] = spec
    t = tdata.load_federated_data(dataset, **kw)
    assert_data_equal(t, jdata.load_federated_data(dataset, **kw))
    assert isinstance(t.x_train, torch.Tensor) and t.x_train.device.type \
        == "cpu"


@pytest.mark.parametrize("loader", ["abcd", "rescale"])
def test_abcd_normalize_match_reference(cohort_file, loader):
    path, _ = cohort_file
    kw = dict(normalize=True, val_fraction=0.2)
    if loader == "abcd":
        t = tdata.load_partition_data_abcd(path, **kw)
        j = jdata.load_partition_data_abcd(path, **kw)
    else:
        t = tdata.load_partition_data_abcd_rescale(path, 4, **kw)
        j = jdata.load_partition_data_abcd_rescale(path, 4, **kw)
    assert_data_equal(t, j)


def test_abcd_layout_refused(cohort_file):
    with pytest.raises(ValueError, match="layout"):
        tdata.load_partition_data_abcd(cohort_file[0], layout="nope")


# -- cost accounting ---------------------------------------------------------

def _models(key):
    """Both sides' model, the reference's params and their conversion, the
    sample shape and the per-layer key map (reference path -> port layer)."""
    if key == "3dcnn_s2d":
        ss = phased_sample_shape((69, 69, 69))
        kw = dict(num_classes=1, widths=(8, 16, 16, 16, 16))
        jm, tm = jcreate(key, **kw), create_model(key, sample_shape=ss, **kw)
    elif key == "small3dcnn_s2d":
        ss = phased_sample_shape((12, 10, 14), 3, 1)
        jm, tm = jcreate(key, num_classes=1), create_model(key)
    else:
        ss = (9, 10, 11, 1)
        jm, tm = jcreate(key, num_classes=1), create_model(key)
    jp = jax.tree_util.tree_map(np.asarray,
                                jinit(jm, jax.random.PRNGKey(0), ss))
    return jm, tm, jp, jax_params_to_torch(jp), ss


def _layer_name(path):
    """A reference layer path as the port's layer name (``Conv3d_i`` wraps
    one flax ``Conv_0``)."""
    path = tuple(p for p in path if p != "Conv_0")
    return ".".join(path)


def _sparsify(jp, seed):
    """A {0, 1} mask over every leaf (kernels about half dense) and the
    params with some exact zeros of their own."""
    rng = np.random.RandomState(seed)
    mask = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape) < 0.5).astype(np.float32), jp)
    params = jax.tree_util.tree_map(
        lambda a: np.where(rng.rand(*a.shape) < 0.1, 0.0, a)
        .astype(np.float32), jp)
    return params, mask


@pytest.mark.parametrize("key", ["small3dcnn", "small3dcnn_s2d", "3dcnn_s2d"])
def test_flops_and_comm_counters_match_reference(key):
    jm, tm, jp, tp, ss = _models(key)
    jdense = jflops.per_layer_flops(jm, jp, ss)
    tdense = tflops.per_layer_flops(tm, tp, ss)
    assert tdense == {_layer_name(p): v for p, v in jdense.items()}

    params, mask = _sparsify(jp, 1)
    tparams, tmask = jax_params_to_torch(params), jax_params_to_torch(mask)
    assert tflops.nonzero_fraction(tparams, tmask) == {
        _layer_name(p): v
        for p, v in jflops.nonzero_fraction(params, mask).items()}
    assert tflops.count_params(tparams) == jflops.count_params(params)
    for m, tm_ in ((mask, tmask), (None, None)):
        assert tflops.count_communication_params(tparams, tm_) == \
            jflops.count_communication_params(params, m)
    assert tflops.inference_flops(tm, tparams, ss, tmask) == \
        jflops.inference_flops(jm, params, ss, mask)
    assert tflops.training_flops(tm, tparams, ss, tmask, n_samples=5) == \
        jflops.training_flops(jm, params, ss, mask, n_samples=5)

    # three recorded rounds: a snapshot, a repeat, a denser snapshot
    jt = jflops.CostTracker(model=jm, sample_shape=ss)
    tt = tflops.CostTracker(model=tm, sample_shape=ss)
    assert tt.record_round(tparams, tmask, n_clients=8,
                           samples_per_client=21) == \
        jt.record_round(params, mask, n_clients=8, samples_per_client=21)
    assert tt.record_repeat() == jt.record_repeat()
    p2, m2 = _sparsify(jp, 2)
    assert tt.record_round(jax_params_to_torch(p2), jax_params_to_torch(m2),
                           n_clients=3, samples_per_client=7) == \
        jt.record_round(p2, m2, n_clients=3, samples_per_client=7)
    assert tt.sum_training_flops == jt.sum_training_flops
    assert tt.sum_comm_params == jt.sum_comm_params
    assert tt.per_round == jt.per_round
