"""The port's image data path against the JAX package, on the CPU, on the
same files and numpy inputs: the CIFAR-10/100 loaders (pickled batches the
test writes) for each partition mode, with and without the validation
split; Tiny-ImageNet on ``tests/test_tiny_imagenet.py``'s miniature layout;
``partition_and_pack``; ``preprocess_abcd`` with an injected volume loader;
every array bit for bit and the pad value equal. ``random_crop_flip`` fed
the reference's own draws is bitwise the reference's op.
"""
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from _torch_port_cohort import assert_data_equal  # noqa: E402
from neuroimagedisttraining_tpu import data as jdata  # noqa: E402
from neuroimagedisttraining_tpu.data import cifar as jcifar  # noqa: E402
from neuroimagedisttraining_tpu.data import packing as jpacking  # noqa: E402
from neuroimagedisttraining_tpu.data import preprocess as jpre  # noqa: E402
from neuroimagedisttraining_torch import data as tdata  # noqa: E402
from neuroimagedisttraining_torch.data import cifar as tcifar  # noqa: E402
from neuroimagedisttraining_torch.data import preprocess as tpre  # noqa: E402

PER_BATCH, TEST, CLIENTS = 30, 40, 4


def _write_cifar(root, name, seed):
    """The pickled batch layout of ``name`` under ``root``: CIFAR-10's five
    train files of PER_BATCH images and a test file, or CIFAR-100's train
    and test files (fine labels)."""
    rng = np.random.RandomState(seed)

    def batch(n, key, classes):
        return {"data": rng.randint(0, 256, (n, 3072), np.uint8),
                key: rng.randint(0, classes, n).tolist()}

    if name == "cifar10":
        base = os.path.join(root, "cifar-10-batches-py")
        os.makedirs(base)
        files = {f"data_batch_{i}": batch(PER_BATCH, "labels", 10)
                 for i in range(1, 6)}
        files["test_batch"] = batch(TEST, "labels", 10)
    else:
        base = os.path.join(root, "cifar-100-python")
        os.makedirs(base)
        files = {"train": batch(5 * PER_BATCH, "fine_labels", 100),
                 "test": batch(TEST, "fine_labels", 100)}
    for fname, d in files.items():
        with open(os.path.join(base, fname), "wb") as f:
            pickle.dump(d, f)


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    _write_cifar(str(root), "cifar10", 0)
    _write_cifar(str(root), "cifar100", 1)
    return str(root)


def _same(t, j):
    assert_data_equal(t, j)
    assert t.aug_pad_value == j.aug_pad_value


@pytest.mark.parametrize("dataset", ["cifar10", "cifar100"])
@pytest.mark.parametrize("method,alpha", [("homo", 0.3), ("n_cls", 2),
                                          ("dir", 0.3), ("my_part", 2)])
@pytest.mark.parametrize("val_fraction", [0.0, 0.1])
def test_cifar_loaders_match_reference(cifar_root, dataset, method, alpha,
                                       val_fraction):
    kw = dict(data_dir=cifar_root, client_number=CLIENTS,
              partition_method=method, partition_alpha=alpha,
              val_fraction=val_fraction, seed=42)
    t = tdata.load_federated_data(dataset, **kw)
    j = jdata.load_federated_data(dataset, **kw)
    _same(t, j)
    assert t.class_num == (10 if dataset == "cifar10" else 100)
    assert t.sample_shape == (32, 32, 3)
    mean, std = ((tcifar.CIFAR10_MEAN, tcifar.CIFAR10_STD)
                 if dataset == "cifar10" else
                 (tcifar.CIFAR100_MEAN, tcifar.CIFAR100_STD))
    assert t.aug_pad_value == tcifar.black_pad_value(mean, std)


def test_cifar_raw_readers_match_reference(cifar_root):
    for tfn, jfn in ((tcifar.load_cifar10_raw, jcifar.load_cifar10_raw),
                     (tcifar.load_cifar100_raw, jcifar.load_cifar100_raw)):
        for a, b in zip(tfn(cifar_root), jfn(cifar_root)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    for c in ("MEAN", "STD"):
        for name in ("CIFAR10_", "CIFAR100_"):
            np.testing.assert_array_equal(getattr(tcifar, name + c),
                                          getattr(jcifar, name + c))


def test_partition_and_pack_matches_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(90, 4, 4, 3).astype(np.float32)
    y = rng.randint(0, 5, 90)
    xt = rng.randn(30, 4, 4, 3).astype(np.float32)
    yt = rng.randint(0, 5, 30)
    for val in (0.0, 0.2):
        args = (x, y, xt, yt, 5, 3, "dir", 0.5, val, 7)
        _same(tdata.partition_and_pack(*args, aug_pad_value=(1.0, 2.0, 3.0)),
              jpacking.partition_and_pack(*args,
                                          aug_pad_value=(1.0, 2.0, 3.0)))


@pytest.fixture(scope="module")
def tin_root(tmp_path_factory):
    """``tests/test_tiny_imagenet.py``'s miniature layout."""
    import test_tiny_imagenet as tt

    return tt.tin_root.__wrapped__(tmp_path_factory)


@pytest.mark.parametrize("name,method,val_fraction",
                         [("tiny_imagenet", "dir", 0.0),
                          ("tiny", "homo", 0.25),
                          ("tiny-imagenet-200", "n_cls", 0.1)])
def test_tiny_imagenet_matches_reference(tin_root, name, method,
                                         val_fraction):
    kw = dict(data_dir=tin_root, client_number=2, partition_method=method,
              partition_alpha=2 if method == "n_cls" else 10.0,
              val_fraction=val_fraction, seed=0)
    t = tdata.load_federated_data(name, **kw)
    _same(t, jdata.load_federated_data(name, **kw))
    assert t.sample_shape == (64, 64, 3) and t.class_num == 4


def test_preprocess_abcd_matches_reference(tmp_path):
    """The same BIDS tree, site table and injected volumes through both
    pipelines: the same mask and the same h5 contents."""
    rng = np.random.RandomState(5)
    vols = {}
    rows = ["subject sex site"]
    for i in range(7):
        sub = f"sub-{i:03d}"
        d = tmp_path / "bids" / sub / "anat"
        os.makedirs(d)
        path = str(d / tpre.T1_FILENAME)
        open(path, "w").close()
        vols[path] = rng.rand(6, 5, 4).astype(np.float32)
        rows.append(f"{sub} {'F' if i % 2 else 'M'} site{i % 3}")
    info = tmp_path / "info.txt"
    info.write_text("\n".join(rows) + "\n")
    outs = []
    for mod, tag in ((tpre, "t"), (jpre, "j")):
        out, mask = mod.preprocess_abcd(
            str(tmp_path / "bids"), str(info),
            out_path=str(tmp_path / f"{tag}.h5"),
            load_volume=lambda p: vols[p])
        with h5py.File(out, "r") as f:
            outs.append(({k: f[k][()] for k in f}, mask))
    (t, tmask), (j, jmask) = outs
    np.testing.assert_array_equal(tmask, jmask)
    assert sorted(t) == sorted(j)
    for k in t:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def _reference_draws(key, b, padding=4):
    """``random_crop_flip``'s draws from its key: (dy, dx, flip)."""
    k1, k2, k3 = jax.random.split(key, 3)
    return np.stack([
        np.asarray(jax.random.randint(k1, (b,), 0, 2 * padding + 1)),
        np.asarray(jax.random.randint(k2, (b,), 0, 2 * padding + 1)),
        np.asarray(jax.random.bernoulli(k3, 0.5, (b,))).astype(np.int64)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad", [None, (-1.98, -1.98, -1.71)])
def test_random_crop_flip_matches_reference(dtype, pad):
    rng = np.random.RandomState(6)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jcifar.random_crop_flip(
            key, jx, padding=4,
            pad_value=None if pad is None else np.asarray(pad, np.float32))
        draws = torch.from_numpy(_reference_draws(key, 8))
        got = tdata.random_crop_flip(tx, draws, padding=4, pad_value=pad)
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the algorithms' callable: the same bits
    aug = tdata.CropFlip(pad, padding=4)
    np.testing.assert_array_equal(
        aug(tx, draws).float().numpy(),
        tdata.random_crop_flip(tx, draws, pad_value=pad).float().numpy())
    # from a generator: offsets in range, a flip flag
    d = tdata.crop_flip_draws(torch.Generator().manual_seed(0), 64)
    assert d.shape == (3, 64) and int(d[:2].min()) >= 0 and \
        int(d[:2].max()) <= 8 and set(d[2].tolist()) <= {0, 1}
