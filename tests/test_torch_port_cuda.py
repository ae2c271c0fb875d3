"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips itself without an NVIDIA GPU. This file
imports no JAX, so it runs where only PyTorch is installed:
``python -m pytest tests/test_torch_port_cuda.py -m cuda``.
"""
import pytest

torch = pytest.importorskip("torch")

from neuroimagedisttraining_torch.ops import kernels  # noqa: E402
from neuroimagedisttraining_torch.ops import topk_select as tts  # noqa: E402

LR = 1e-3 * 0.998 ** 3
MOM, WD = 0.9, 5e-4


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """On the card: each kernel equals its plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with sm_90a (H100)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [(64, 8, 3, 3, 3), (1000,), (33, 9), (7,)]
    for mask_grads in (False, True):
        ps = [torch.randn(s, generator=g, device=dev) for s in shapes]
        ms = [torch.randn(s, generator=g, device=dev) for s in shapes]
        gs = [torch.randn(s, generator=g, device=dev) for s in shapes]
        ks = [(torch.rand(s, generator=g, device=dev) > 0.5).float()
              for s in shapes]
        want = [kernels.masked_sgd_plain(p, m, gg, k, LR, MOM, WD,
                                         mask_grads)
                for p, m, gg, k in zip(ps, ms, gs, ks)]
        kernels.fused_masked_sgd_step(ps, ms, gs, ks, LR,
                                      momentum=MOM, wd=WD,
                                      mask_grads=mask_grads)
        for (wp, wm), p, m in zip(want, ps, ms):
            assert torch.equal(wp, p) and torch.equal(wm, m)
    av = torch.rand((3, 5000), generator=g, device=dev)
    assert torch.equal(kernels.threshold_topk(av, 999),
                       tts.exact_threshold(av, 999))
    s = torch.rand(4000, generator=g, device=dev)
    norm = s.sum()
    thr = tts.exact_threshold((s / norm)[None], 2000).reshape(())
    assert torch.equal(kernels.fused_score_mask([s], norm, thr)[0],
                       kernels.score_mask_plain(s, norm, thr))
