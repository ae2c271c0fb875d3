from .abcd import (
    abcd_site_count,
    load_abcd_h5,
    load_partition_data_abcd,
    load_partition_data_abcd_rescale,
    site_train_test_split,
    write_abcd_h5,
)
from .partition import (
    class_prior_partition,
    contiguous_reshard,
    dirichlet_partition,
    proportional_test_indices,
    record_data_stats,
    site_partition,
)
from .synthetic import device_synthetic_federated, make_synthetic_federated
from .types import FederatedData, pad_stack

# Dataset names whose loaders declare the reference's RandomCrop+flip train
# transform (the reference's data/__init__.py:25-34); read by run_identity.
# None of them is ported yet (ROADMAP item 11).
AUGMENTABLE_DATASETS = (
    "cifar10", "cifar100", "tiny_imagenet", "tiny-imagenet-200", "tiny")


def dataset_is_augmentable(dataset: str) -> bool:
    return dataset.lower() in AUGMENTABLE_DATASETS


def load_federated_data(
    dataset: str,
    data_dir: str = "",
    client_number: int = 8,
    partition_method: str = "dir",
    partition_alpha: float = 0.3,
    val_fraction: float = 0.0,
    seed: int = 42,
    **kwargs,
) -> FederatedData:
    """Dataset dispatcher (counterpart of the reference's
    ``data/__init__.py::load_federated_data``): the ABCD cohort files and
    the synthetic stand-in, as CPU tensors, with a validation split of
    ``val_fraction`` (which only fedfomo reads). ``partition_method`` and
    ``partition_alpha`` are read only by the image datasets, which are not
    ported yet."""
    name = dataset.lower()
    if name in ("abcd", "abcd_rescale"):
        if name == "abcd" and not client_number:
            return load_partition_data_abcd(
                data_dir, val_fraction=val_fraction, **kwargs)
        return load_partition_data_abcd_rescale(
            data_dir, client_number, val_fraction=val_fraction, **kwargs)
    if name == "abcd_site":
        return load_partition_data_abcd(
            data_dir, val_fraction=val_fraction, **kwargs)
    if name in ("cifar10", "cifar100", "tiny_imagenet", "tiny-imagenet-200",
                "tiny"):
        raise ValueError(f"dataset {dataset!r} is not ported yet (ROADMAP "
                         "item 11)")
    if name in ("synthetic", "abcd_synth"):
        spc = kwargs.get("samples_per_client", 24)
        val_per_client = (
            max(1, int(val_fraction * spc)) if val_fraction > 0 else 0)
        return make_synthetic_federated(
            seed=seed, n_clients=client_number,
            val_per_client=val_per_client, **kwargs)
    raise ValueError(f"unknown dataset {dataset!r}")


__all__ = [
    "AUGMENTABLE_DATASETS",
    "FederatedData",
    "abcd_site_count",
    "class_prior_partition",
    "contiguous_reshard",
    "dataset_is_augmentable",
    "device_synthetic_federated",
    "dirichlet_partition",
    "load_abcd_h5",
    "load_federated_data",
    "load_partition_data_abcd",
    "load_partition_data_abcd_rescale",
    "make_synthetic_federated",
    "pad_stack",
    "proportional_test_indices",
    "record_data_stats",
    "site_partition",
    "site_train_test_split",
    "write_abcd_h5",
]
