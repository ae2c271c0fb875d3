"""The stem-stage entry points (counterpart of
``neuroimagedisttraining_tpu/ops/experimental/``).

The reference keeps four Pallas forms of the AlexNet3D stem stage here, on
no product path of its own. The port keeps their names and public layouts
(phased ``(B, D', H', 8, W')`` input, NDHWC outputs), and all four run on
the two hand-written kernels that also carry the port's training path
(``ops/kernels.py``: ``stem_fwd``, ``stem_bwd``; the model's
``models/alexnet3d.py::StemStage``):

* ``pallas_stem.py`` — ``stem_conv_pallas``: the conv alone;
* ``pallas_stem_fused.py`` — ``fused_stem_fwd``: conv, max-pool and the
  GroupNorm statistics in one pass;
* ``pallas_stem_v3.py`` — ``make_stem_lhs``, ``fused_stem_fwd_v3``: the
  same from the staged-unfold lhs, with bias;
* ``pallas_stem_bwd.py`` — ``pool_sum_sumsq``: max-pool and sums with the
  one-pass backward (ties split evenly).

Each module's ``ref`` is the reference's plain spelling in PyTorch.
"""
