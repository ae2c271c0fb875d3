"""Offline ABCD preprocessing: BIDS tree -> masked volumes -> HDF5 cohort
(counterpart of ``neuroimagedisttraining_tpu/data/preprocess.py``):

* walk the BIDS tree for the smoothed modulated gray-matter T1 maps
  (``Sm6mwc1pT1.nii``, 121x145x121) and join the subject ids against the
  ``ABCDSexSiteInfo.txt`` metadata table (subject, sex, site columns);
* the mean volume across subjects -> brain mask ``mean > 0.2`` -> every
  subject's volume masked;
* stack X, label-encode the site, y = sex, and write
  ``final_dataset_<N>subs.h5`` with keys X/y/site (the file the ABCD
  loaders read), through this package's ``write_abcd_h5``.

Volume loading is injected through a ``load_volume`` callable (nibabel by
default, imported only then), so the pipeline itself (discovery, masking,
stacking, the HDF5 write) runs without it.
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from .abcd import write_abcd_h5

logger = logging.getLogger(__name__)

T1_FILENAME = "Sm6mwc1pT1.nii"
MASK_THRESHOLD = 0.2


def _nibabel_loader(path: str) -> np.ndarray:  # pragma: no cover
    import nibabel as nib

    return np.asarray(nib.load(path).get_fdata(), dtype=np.float32)


def discover_t1_volumes(
    bids_root: str, filename: str = T1_FILENAME
) -> Dict[str, str]:
    """Walk a BIDS-like tree and map subject id (the ``sub-*`` path
    component) to its T1 map path."""
    found: Dict[str, str] = {}
    for dirpath, _dirnames, filenames in os.walk(bids_root):
        if filename in filenames:
            parts = dirpath.split(os.sep)
            subject = next(
                (p for p in parts if p.startswith("sub-")),
                os.path.basename(dirpath),
            )
            found[subject] = os.path.join(dirpath, filename)
    return found


def read_site_info(path: str) -> Dict[str, Tuple[int, str]]:
    """Parse ``ABCDSexSiteInfo.txt``-style metadata: whitespace/comma rows of
    (subject, sex, site). Returns {subject: (sex_code, site_name)} with
    sex_code 1 for female (the reference's y = female indicator)."""
    table: Dict[str, Tuple[int, str]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.lower().startswith(("subject", "src_subject")):
                continue
            row = line.replace(",", " ").split()
            if len(row) < 3:
                continue
            subject, sex, site = row[0], row[1], row[2]
            sex_code = 1 if sex.upper() in ("F", "FEMALE", "2") else 0
            table[subject] = (sex_code, site)
    return table


def compute_brain_mask(
    volumes: Sequence[np.ndarray], threshold: float = MASK_THRESHOLD
) -> np.ndarray:
    """Mean volume across subjects thresholded at ``mean > threshold``: the
    group-level gray-matter mask."""
    acc = np.zeros_like(np.asarray(volumes[0], np.float64))
    for v in volumes:
        acc += v
    mean = acc / len(volumes)
    return (mean > threshold).astype(np.float32)


def preprocess_abcd(
    bids_root: str,
    site_info_path: str,
    out_path: Optional[str] = None,
    load_volume: Optional[Callable[[str], np.ndarray]] = None,
    mask_threshold: float = MASK_THRESHOLD,
    limit: Optional[int] = None,
):
    """Full pipeline: discover -> load -> mask -> stack -> HDF5.

    Two passes over the subject list (first for the mean and the mask,
    second to apply it), so peak memory is one volume and the accumulator,
    not the cohort.
    """
    load_volume = load_volume or _nibabel_loader
    paths = discover_t1_volumes(bids_root)
    meta = read_site_info(site_info_path)
    subjects = sorted(set(paths) & set(meta))
    if limit:
        subjects = subjects[:limit]
    if not subjects:
        raise ValueError(
            "no subjects found with both a T1 volume and metadata")
    logger.info("preprocessing %d subjects", len(subjects))

    # pass 1: group mean -> mask
    acc = None
    for s in subjects:
        v = np.asarray(load_volume(paths[s]), np.float32)
        acc = v.astype(np.float64) if acc is None else acc + v
    mask = ((acc / len(subjects)) > mask_threshold).astype(np.float32)

    # pass 2: apply mask, stack, encode labels
    sites = sorted({meta[s][1] for s in subjects})
    site_code = {name: i for i, name in enumerate(sites)}
    X = np.zeros((len(subjects),) + mask.shape, np.float32)
    y = np.zeros(len(subjects), np.int64)
    site = np.zeros(len(subjects), np.int64)
    for i, s in enumerate(subjects):
        X[i] = np.asarray(load_volume(paths[s]), np.float32) * mask
        y[i] = meta[s][0]
        site[i] = site_code[meta[s][1]]

    out_path = out_path or os.path.join(
        bids_root, f"final_dataset_{len(subjects)}subs.h5")
    write_abcd_h5(out_path, X, y, site)
    logger.info("wrote %s (%d subjects, %d sites)", out_path, len(subjects),
                len(sites))
    return out_path, mask
