"""The port's CLI on the 3D-ResNet (``--model 3dresnet``, with ``--layout
s2d`` its phased twin ``3dresnet_s2d``) against the JAX CLI, on the CPU, on
one 29x33x29 cohort file (two sites, 12 volumes) the test writes.

FedAvg, one round, the eval after it, no fine-tune, both layouts: the
cohort each side's CLI loads bitwise (phased for the twin's k3/p3 stem,
``S2D_SPECS``), the JAX CLI's run identity and ``stat_info`` path and
top-level keys, and its history: the same rounds with the same record
keys. The JAX CLI's history is taken from its run of the same command line
on ``small3dcnn``: on the ResNet it spends most of a minute counting
nonzero weights (``utils/flops.py::nonzero_fraction``, per leaf, eagerly),
and the record keys do not depend on the model. The cost counters
themselves are held exactly to the JAX package's on identical ResNet
parameters in ``tests/test_torch_port_data.py``.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.experiments import config as jconfig  # noqa: E402
from neuroimagedisttraining_tpu.experiments import runner as jrunner  # noqa: E402
from neuroimagedisttraining_torch.experiments import config as tconfig  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many CPU ops on one worker of the suite's parallel run: one thread
    (see ``tests/test_torch_port_fused.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(path, layout, model="3dresnet"):
    return ["--dataset", "abcd_site", "--data_dir", path, "--layout", layout,
            "--model", model, "--client_num_in_total", "0",
            "--batch_size", "2", "--epochs", "1", "--comm_round", "1",
            "--final_finetune", "0", "--log_dir", ""]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """The cohort file, and the JAX CLI's run of the same command line on
    ``small3dcnn`` (its history and ``stat_info``)."""
    d = tmp_path_factory.mktemp("abcd")
    path = pc.write_cohort_file(str(d / "c29.h5"), (29, 33, 29), 12, seed=6)
    j = jrunner.main(_argv(path, "s2d", "small3dcnn")
                     + ["--results_dir", str(d / "j")], "fedavg")
    with open(j["stat_path"], "rb") as f:
        js = pickle.load(f)
    return path, j, js


@pytest.mark.parametrize("layout,key,stem", [
    ("s2d", "3dresnet_s2d", "S2DResNetStem_0.kernel"),
    ("channels", "3dresnet", "Conv3d_0.kernel")])
def test_cli_resnet3d_matches_reference(tmp_path, cohort, layout, key, stem):
    path, j, js = cohort
    argv = _argv(path, layout)
    j_args = jconfig.parse_args(argv, "fedavg")
    t_args = tconfig.parse_args(argv + ["--device", "cpu"], "fedavg")
    assert trunner._model_key(t_args) == key
    pc.assert_data_equal(trunner.build_data(t_args),
                         jrunner.build_data(j_args))
    t = trunner.main(argv + ["--results_dir", str(tmp_path / "t"),
                             "--device", "cpu"], "fedavg")
    identity = jconfig.run_identity(j_args, "fedavg")
    assert t["identity"] == identity
    assert t["stat_path"] == str(tmp_path / "t" / "abcd_site" / identity)
    assert [h["round"] for h in t["history"]] == \
        [h["round"] for h in j["history"]] == [0]
    assert [sorted(h) for h in t["history"]] == \
        [sorted(h) for h in j["history"]]
    assert np.isfinite(t["history"][0]["train_loss"])
    params = t["state"].global_params
    assert stem in params and params["Dense_0.kernel"].shape == (512, 256)
    with open(t["stat_path"], "rb") as f:
        ts = pickle.load(f)
    assert sorted(ts) == sorted(js)
    for k in ("sum_comm_params", "sum_training_flops",
              "avg_inference_flops"):
        assert ts[k] > 0, k
