"""ABCD neuroimaging data path: HDF5 cohort -> FederatedData (counterpart of
``neuroimagedisttraining_tpu/data/abcd.py``).

* :func:`load_abcd_h5` opens the cohort file lazily (rows are read one
  client at a time through h5py, never the whole cohort).
* :func:`site_train_test_split` is the per-site 80/20 split with the fixed
  seed-42 shuffle re-applied before every site.
* :func:`load_partition_data_abcd`: one client per acquisition site.
* :func:`load_partition_data_abcd_rescale`: the sites' pools merged, then
  resharded contiguously into ``client_number`` equal clients (the entry
  SalientGrads uses).

Both return this package's :class:`FederatedData` as CPU tensors, bitwise
the reference's arrays (the ``val_fraction`` validation split included); the
runner moves them to the device once. ``h5py`` is imported inside the
functions that read or write a file, so the package imports without it. The
reference's ``client_filter`` (one process's clients of a multi-process
run) comes with the multi-process path (ROADMAP item 15).
"""
from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np

from .types import FederatedData, pad_stack

logger = logging.getLogger(__name__)

ABCD_VOLUME_SHAPE = (121, 145, 121)
ABCD_SPLIT_SEED = 42
ABCD_TEST_RATIO = 0.2

LAYOUTS = ("channels", "flat", "s2d")


def load_abcd_h5(path: str):
    """Open the cohort file ``final_dataset_<N>subs.h5`` and return
    ``(X, y, site)``: ``X`` stays an h5py dataset so callers can slice per
    site without loading the cohort."""
    import h5py

    f = h5py.File(path, "r")
    return f["X"], np.asarray(f["y"][()]), np.asarray(f["site"][()])


def site_train_test_split(
    site: np.ndarray,
    test_ratio: float = ABCD_TEST_RATIO,
    seed: int = ABCD_SPLIT_SEED,
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Per-site train/test index split, the same fixed seed re-applied
    before each site's shuffle. Returns {site_value: (train_idx,
    test_idx)}."""
    site = np.asarray(site).ravel()
    out = {}
    for s in np.unique(site):
        idx = np.where(site == s)[0]
        n_test = int(len(idx) * test_ratio)
        n_train = len(idx) - n_test
        np.random.seed(seed)
        np.random.shuffle(idx)
        out[int(s)] = (np.sort(idx[:n_train]), np.sort(idx[n_train:]))
    return out


def _gather_rows(X, idx: np.ndarray) -> np.ndarray:
    """Rows ``idx`` of an h5py dataset (or ndarray), read in increasing
    order (h5py's fancy indexing needs it; batching reshuffles anyway)."""
    idx = np.sort(np.asarray(idx))
    if len(idx) == 0:
        return np.zeros((0,) + tuple(X.shape[1:]), dtype=np.float32)
    return np.asarray(X[idx], dtype=np.float32)


def _finalize(xs_tr, ys_tr, xs_te, ys_te, val_fraction: float, seed: int,
              normalize: bool, layout: str = "channels",
              s2d_spec=None) -> FederatedData:
    """Stack per-client splits into FederatedData, with optional
    per-volume standardization and a validation split of ``val_fraction``
    carved from each client's train rows (drawn per client id).
    ``layout``:
    ``"channels"`` keeps ``(..., D, H, W, 1)``, ``"flat"`` stores
    ``(..., D, H, W)`` and ``"s2d"`` phase-decomposes to
    ``(..., D', H', 8, W')`` for the stem ``s2d_spec = (kernel, pad)``
    (default the AlexNet3D stem's (5, 0))."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")

    def prep(x):
        x = np.asarray(x, np.float32)
        if normalize and x.size:
            flat = x.reshape(x.shape[0], -1)
            mu = flat.mean(axis=1)
            sd = flat.std(axis=1) + 1e-6
            x = (x - mu[(...,) + (None,) * (x.ndim - 1)]) / \
                sd[(...,) + (None,) * (x.ndim - 1)]
        if layout == "channels":
            if x.ndim >= 2 and x.shape[-1] != 1:
                x = x[..., None]
        else:
            # cohort files come with and without a trailing channel axis
            if x.ndim >= 3 and x.shape[-1] == 1:
                x = x[..., 0]
            if layout == "s2d":
                from ..ops.s2d import phase_decompose

                k, pd = s2d_spec or (5, 0)
                x = np.asarray(phase_decompose(x, kernel=k, pad=pd))
        return x

    xs_va, ys_va = [], []
    if val_fraction > 0:
        new_tr_x, new_tr_y = [], []
        for gid, (x, y) in enumerate(zip(xs_tr, ys_tr)):
            rng = np.random.RandomState((seed * 100003 + int(gid)) % 2**31)
            n_val = int(len(y) * val_fraction)
            perm = rng.permutation(len(y))
            new_tr_x.append(x[perm[n_val:]])
            new_tr_y.append(y[perm[n_val:]])
            xs_va.append(x[perm[:n_val]])
            ys_va.append(y[perm[:n_val]])
        xs_tr, ys_tr = new_tr_x, new_tr_y

    x_train, n_train = pad_stack([prep(x) for x in xs_tr])
    y_train, _ = pad_stack([np.asarray(y, np.int32) for y in ys_tr])
    x_test, n_test = pad_stack([prep(x) for x in xs_te])
    y_test, _ = pad_stack([np.asarray(y, np.int32) for y in ys_te])
    kwargs = {}
    if val_fraction > 0:
        x_val, n_val = pad_stack([prep(x) for x in xs_va])
        y_val, _ = pad_stack([np.asarray(y, np.int32) for y in ys_va])
        kwargs = dict(x_val=x_val, y_val=y_val, n_val=n_val)
    return FederatedData(x_train=x_train, y_train=y_train, n_train=n_train,
                         x_test=x_test, y_test=y_test, n_test=n_test,
                         class_num=2, **kwargs)


def abcd_site_count(data_path: str) -> int:
    """Number of acquisition sites (= site-clients) in a cohort file; reads
    only the ``site`` vector."""
    import h5py

    with h5py.File(data_path, "r") as f:
        return len(np.unique(np.asarray(f["site"][()])))


def load_partition_data_abcd(
    data_path: str,
    val_fraction: float = 0.0,
    normalize: bool = False,
    seed: int = ABCD_SPLIT_SEED,
    layout: str = "channels",
    s2d_spec=None,
) -> FederatedData:
    """One federated client per acquisition site, read site by site and
    split 80/20."""
    X, y, site = load_abcd_h5(data_path)
    splits = site_train_test_split(site, seed=seed)
    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    for s, (tr, te) in splits.items():
        xs_tr.append(_gather_rows(X, tr))
        ys_tr.append(y[tr])
        xs_te.append(_gather_rows(X, te))
        ys_te.append(y[te])
        logger.info("site %s: %d train / %d test", s, len(tr), len(te))
    _close_if_h5(X)
    return _finalize(xs_tr, ys_tr, xs_te, ys_te, val_fraction, seed,
                     normalize, layout, s2d_spec=s2d_spec)


def load_partition_data_abcd_rescale(
    data_path: str,
    client_number: int,
    val_fraction: float = 0.0,
    normalize: bool = False,
    seed: int = ABCD_SPLIT_SEED,
    layout: str = "channels",
    s2d_spec=None,
) -> FederatedData:
    """All sites' train/test pools merged in site order, then resharded
    contiguously: client i holds train rows ``[i*s, (i+1)*s)`` of the merged
    pool and the matching 20%-scaled window of the merged test pool."""
    X, y, site = load_abcd_h5(data_path)
    splits = site_train_test_split(site, seed=seed)
    tr_idx = np.concatenate([tr for tr, _ in splits.values()])
    te_idx = np.concatenate([te for _, te in splits.values()])

    s_tr = len(tr_idx) // client_number
    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    for c in range(client_number):
        rows_tr = tr_idx[c * s_tr: (c + 1) * s_tr]
        lo = int(c * s_tr * ABCD_TEST_RATIO)
        hi = int((c + 1) * s_tr * ABCD_TEST_RATIO)
        rows_te = te_idx[lo:hi]
        xs_tr.append(_gather_rows(X, rows_tr))
        ys_tr.append(y[np.sort(rows_tr)])
        xs_te.append(_gather_rows(X, rows_te))
        ys_te.append(y[np.sort(rows_te)])
        logger.info("client %d: %d train / %d test", c, len(rows_tr),
                    len(rows_te))
    _close_if_h5(X)
    return _finalize(xs_tr, ys_tr, xs_te, ys_te, val_fraction, seed,
                     normalize, layout, s2d_spec=s2d_spec)


def _close_if_h5(X) -> None:
    f = getattr(X, "file", None)
    if f is not None:
        try:
            f.close()
        except Exception:  # pragma: no cover
            pass


def write_abcd_h5(path: str, X: np.ndarray, y: np.ndarray,
                  site: np.ndarray) -> None:
    """Write a cohort file in the layout :func:`load_abcd_h5` reads (keys
    X, y, site)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("X", data=np.asarray(X, np.float32),
                         chunks=(1,) + tuple(np.asarray(X).shape[1:]))
        f.create_dataset("y", data=np.asarray(y))
        f.create_dataset("site", data=np.asarray(site))
