"""Utilities: deferred metric records and cost accounting (counterpart of
``neuroimagedisttraining_tpu/utils``)."""
