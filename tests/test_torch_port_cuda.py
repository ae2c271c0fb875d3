"""The CUDA kernels against their plain versions, and the aggregate against
the CPU's, on the card.

Marked ``cuda``: each test skips itself without an NVIDIA GPU. This file
imports no JAX, so it runs where only PyTorch is installed:
``python -m pytest tests/test_torch_port_cuda.py -m cuda``.
"""
import pytest

torch = pytest.importorskip("torch")

from neuroimagedisttraining_torch.ops import kernels  # noqa: E402
from neuroimagedisttraining_torch.ops import topk_select as tts  # noqa: E402
from neuroimagedisttraining_torch.core.state import weighted_sum  # noqa: E402
from neuroimagedisttraining_torch.parallel import collectives as tc  # noqa: E402

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


def _card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA GPU with sm_90a (H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_aggregation_kernels_match_plain():
    """Mask apply, the weighted sum and the int8 quantize-reduce (a
    1024-multiple bucket, b = 1000, an all-zero bucket) bit for bit; the
    threshold on an [8, n] row block."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    shapes = {"a": (64, 8, 3, 3, 3), "b": (1000,), "c": (33, 9)}
    ps = {k: torch.randn(s, generator=g, device=dev) for k, s in
          shapes.items()}
    ms = {k: (torch.rand(s, generator=g, device=dev) > 0.5).float()
          for k, s in shapes.items()}
    got = kernels.fused_mask_apply(ps, ms)
    for k in shapes:
        assert torch.equal(got[k], kernels.mask_apply_plain(ps[k], ms[k]))
    xs = {k: torch.randn((8,) + s, generator=g, device=dev)
          for k, s in shapes.items()}
    w = torch.rand(8, generator=g, device=dev)
    w = w / w.sum()
    got = kernels.fused_weighted_sum(xs, w)
    for k in shapes:
        assert torch.equal(got[k], weighted_sum(xs[k], w))
    for nb, b in ((3, 4096), (5, 1000)):
        x = torch.randn((8, nb, b), generator=g, device=dev)
        x[:, 0] = 0.0
        u = torch.rand((8, nb, b), generator=g, device=dev)
        s = tc._int8_scale(x)[..., 0].contiguous()
        got = kernels.fused_quantize_reduce(x, w, u, s)
        assert torch.equal(got, kernels.quantize_reduce_plain(x, w, u, s))
    av = torch.rand((8, 70000), generator=g, device=dev)
    assert torch.equal(kernels.threshold_topk(av, 7000),
                       tts.exact_threshold(av, 7000))


@pytest.mark.cuda
def test_cuda_threshold_edge_cases_match_plain():
    """The radix select bit for bit against the plain search and its own
    plain spelling: +inf, NaN and -0.0 in a row (NaN counts as +inf), k = 1
    and k = n, all-zero and few-valued rows, n not a multiple of 4, and a
    contiguous [C, n] view whose base is off a 16-byte boundary."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    n = 100_003
    row = torch.rand((1, n), generator=g, device=dev)
    r = torch.rand((1, n), generator=g, device=dev)
    special = torch.where(r < 0.02, float("inf"), row)
    special = torch.where((r >= 0.02) & (r < 0.04), float("nan"), special)
    special = torch.where((r >= 0.04) & (r < 0.2), -0.0, special)
    few = torch.randint(0, 3, (2, n), generator=g, device=dev).float() / 3
    c, m = 8, 50_001
    big = torch.rand(c * m + 1, generator=g, device=dev)
    offset = big[1:].view(c, m)
    assert offset.data_ptr() % 16 == 4
    cases = [(special, 1), (special, 29), (special, n // 2), (special, n),
             (row, 1), (row, n), (torch.zeros((3, n), device=dev), 7),
             (few, n // 3), (offset, 1), (offset, m // 10), (offset, m)]
    for av, k in cases:
        kernels.reset_launches()
        got = kernels.threshold_topk(av, k).view(torch.int32)
        assert kernels.LAUNCHES["threshold"] == 1
        assert torch.equal(got, tts.exact_threshold(av, k).view(torch.int32))
        assert torch.equal(got, tts.radix_threshold(av, k).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 8, 16, 20])
def test_cuda_weighted_sum_edge_leaves_match_plain(c):
    """Both paths of the weighted sum in one launch, bit for bit: aligned
    leaves (16-byte path), n % 4 != 0, an offset base, tiny leaves; 20
    clients run as two chunks, the second resuming from the first's sums."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5 + c)
    big = torch.randn(c * 3000 + 4, generator=g, device=dev)
    xs = {"aligned": torch.randn((c, 64, 4, 4), generator=g, device=dev),
          "odd": torch.randn((c, 1001), generator=g, device=dev),
          "offset": big[1:1 + c * 3000].view(c, 3000),
          "offset16": big[4:4 + c * 3000].view(c, 3000),
          "tiny": torch.randn((c, 3), generator=g, device=dev),
          "one": torch.randn((c,), generator=g, device=dev)}
    want_vec = {"aligned": True, "odd": False, "offset": False,
                "offset16": True, "tiny": False, "one": False}
    assert {k: kernels.weighted_sum_vector_leaf(v) for k, v in xs.items()} \
        == want_vec
    w = torch.rand(c, generator=g, device=dev)
    w = w / w.sum()
    kernels.reset_launches()
    got = kernels.fused_weighted_sum(xs, w)
    assert kernels.LAUNCHES["weighted_sum"] == 1
    for k, x in xs.items():
        assert torch.equal(got[k], weighted_sum(x, w)), k


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1000, 1001, 1024, 262144])
@pytest.mark.parametrize("c", [1, 3, 8, 16, 17, 33])
def test_cuda_quantize_reduce_edges_match_plain(c, b):
    """The int8 quantize-reduce bit for bit against its plain version on
    both of its paths, over one to three launches of 16 clients: an
    all-zero bucket (scale 1.0), a bucket with +0.0 and -0.0 among its
    values, a bucket whose scale is a quarter of its max-abs/127 (values
    clip at +-127), a bucket of subnormal values (a subnormal scale), and
    the same inputs as contiguous views 4 bytes off a 16-byte boundary (the
    scalar path)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(100 * c + b % 97)
    nb = 4
    n = c * nb * b
    big = torch.randn(2 * n + 8, generator=g, device=dev)
    big[n + 4:] = torch.rand(n + 4, generator=g, device=dev)
    x = big[:n].view(c, nb, b)
    x[:, 0] = 0.0
    x[:, 1, ::3] = 0.0
    x[:, 1, 1::3] = -0.0
    x[:, 3] *= 1e-40
    u = big[n + 4:2 * n + 4].view(c, nb, b)
    s = tc._int8_scale(x)[..., 0].contiguous()
    s[:, 2] *= 0.25
    assert 0.0 < float(s[:, 3].max()) < torch.finfo(torch.float32).tiny
    w = torch.rand(c, generator=g, device=dev)
    w = w / w.sum()
    assert float(s[0, 0]) == 1.0
    x_off = torch.empty(n + 1, device=dev)[1:].view(c, nb, b)
    u_off = torch.empty(n + 1, device=dev)[1:].view(c, nb, b)
    x_off.copy_(x)
    u_off.copy_(u)
    assert x_off.data_ptr() % 16 == 4
    want = kernels.quantize_reduce_plain(x, w, u, s)
    q = torch.floor(x[:, 2] / s[:, 2, None])
    assert bool((q.abs() > 127).any())  # the clip is exercised
    for xx, uu, vec in ((x, u, b % 4 == 0), (x_off, u_off, False)):
        plan = kernels.quantize_reduce_plan(
            c, nb, b, [xx.data_ptr(), uu.data_ptr(), 0])
        assert plan["vec"] == vec
        assert len(plan["chunks"]) == -(-c // 16)
        kernels.reset_launches()
        got = kernels.fused_quantize_reduce(xx, w, uu, s)
        assert kernels.LAUNCHES["quantize_reduce"] == 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert bool(torch.all(got[0] == 0))


@pytest.mark.cuda
def test_cuda_aggregate_ignores_tf32():
    """The f32 wires contract without a matmul, so TF32 cannot touch them:
    the card's aggregate equals the CPU's bit for bit with TF32 on."""
    dev = _card()
    g = torch.Generator().manual_seed(2)
    tree = {"k": torch.randn(8, 40, 300, generator=g),
            "b": torch.randn(8, 300, generator=g)}
    w = torch.rand(8, generator=g)
    w = w / w.sum()
    want = tc.weighted_mean(tree, w, bucket_size=4096)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = tc.weighted_mean({k: v.to(dev) for k, v in tree.items()},
                               w.to(dev), bucket_size=4096)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    for k in tree:
        assert torch.equal(got[k].cpu(), want[k])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["dense", "int8", "topk"])
def test_cuda_fedavg_round_and_finetune_match_cpu(impl):
    """A FedAvg round on each of its wires and the final fine-tune, on the
    CPU and on the card from the same parameters, batch order and int8
    uniforms, with cuDNN's TF32 off: the card launches the kernels of the
    path, and the models agree (round-off on the dense wire; norm-wise
    within 1e-2 where an int8 rounding or a top-k selection within
    round-off of its edge may flip)."""
    from neuroimagedisttraining_torch.algorithms import FedAvg
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.core.trainer import epoch_permutations
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model, init_params

    dev = _card()
    clients, steps, bs, bucket = 4, 2, 4, 1024
    data = make_synthetic_federated(seed=5, n_clients=clients,
                                    samples_per_client=8, test_per_client=4,
                                    sample_shape=(8, 8, 8, 1))
    hp = HyperParams(lr=0.05, momentum=0.9, local_epochs=1,
                     steps_per_epoch=steps, batch_size=bs)
    g = torch.Generator().manual_seed(0)
    params = init_params(create_model("small3dcnn", num_classes=1), g)
    n_rows = data.x_train.shape[1]
    perms = [[epoch_permutations(g, int(n), 1, steps * bs, n_rows=n_rows)
              for n in data.n_train] for _ in range(2)]
    n = sum(v.numel() for v in params.values())
    u = torch.rand((clients,) + tc.bucket_shape(n, bucket), generator=g)
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # f32 convs, as on the CPU
    try:
        for device in ("cpu", dev):
            algo = FedAvg(create_model("small3dcnn", num_classes=1), data,
                          hp, loss_type="bce", agg_impl=impl,
                          agg_bucket_size=bucket, device=device)
            state = algo.init_state(params=params)
            kernels.reset_launches()
            state, met = algo.run_round(state, 0, perms=perms[0],
                                        agg_uniforms=u)
            launches = dict(kernels.LAUNCHES)
            state, rec = algo.finalize(state, perms=perms[1])
            out[device] = (
                {k: v.cpu() for k, v in state.global_params.items()},
                {k: v.cpu() for k, v in state.personal_params.items()},
                float(met["train_loss"]), rec, launches)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (gc, pc_, lc, rc, _), (gg, pg, lg, rg, lau) = out["cpu"], out[dev]
    groups = len(tc.topk_groups(pc_, bucket)) if impl == "topk" else 0
    assert lau == {"masked_sgd": clients * steps, "threshold": groups,
                   "score_mask": 0, "mask_apply": 0,
                   "weighted_sum": 0 if impl == "int8" else 1,
                   "quantize_reduce": 1 if impl == "int8" else 0,
                   "stem_fwd": 0, "stem_bwd": 0}, lau
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    tol = 1e-5 if impl == "dense" else 1e-2
    for a, b in ((gg, gc), (pg, pc_)):
        va, vb = tc.tree_to_vec(a), tc.tree_to_vec(b)
        err = float((va - vb).norm() / vb.norm())
        assert err < tol, (impl, err)
    for k in ("global_loss", "personal_loss"):
        assert abs(float(rg[k]) - float(rc[k])) <= tol * abs(float(rc[k]))


def _check_stem_fwd(x, w, bias):
    """``kernels.stem_fwd`` on the card against its plain version: the conv
    within one ulp of the working type or, where it cancels to near zero,
    within 1e-5 of the sum of its terms' magnitudes (in f32, TF32 off,
    within that everywhere); zs bitwise that conv plus the bias, rounded in
    the working type; pooled bitwise the max-pool of the kernel's own zs;
    the sums within 1e-5 of the sums of the kernel's zs. Returns the
    kernel's (zs, pooled, s1, s2)."""
    kernels.reset_launches()
    zs, pooled, s1, s2 = kernels.stem_fwd(x, w, bias)
    assert kernels.LAUNCHES["stem_fwd"] == 1
    conv, _, _, _ = kernels.stem_fwd(x, w, None, pool=False, stats=False)
    want, _, _, _ = kernels.stem_fwd_plain(x, w, None, pool=False,
                                           stats=False)
    terms, _, _, _ = kernels.stem_fwd_plain(
        x.abs(), w.abs(), None, pool=False, stats=False)
    near = (conv.float() - want.float()).abs() <= 1e-5 * terms.float()
    if x.dtype == torch.float32:
        assert bool(near.all())
    # the conv within one ulp, but where it cancels to near zero; the bias
    # added to the rounded conv in the working type
    assert bool(((kernels.ulp_distance(conv, want) <= 1) | near).all())
    assert torch.equal(zs, conv + bias)
    ncdhw = zs.permute(0, 4, 1, 2, 3)
    assert torch.equal(pooled, torch.nn.functional.max_pool3d(
        ncdhw, 3, 3).permute(0, 2, 3, 4, 1))
    p1, p2 = kernels.stem_stats_plain(zs)
    mag = zs.double().abs().sum((1, 2, 3))
    assert bool(((s1.double() - p1.double()).abs() <= 1e-5 * mag).all())
    assert bool(((s2 - p2).abs() <= 1e-5 * p2.abs()).all())
    return zs, pooled, s1, s2


def _stem_inputs(g, dev, shape, f, dt):
    x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(dt)
    w = (0.2 * torch.randn((f, 8, 3, 3, 3), generator=g, device=dev)).to(dt)
    bias = (0.1 * torch.randn(f, generator=g, device=dev)).to(dt)
    return x, w, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_stem_kernels_match_plain(dtype):
    """The stem forward against its plain version (``_check_stem_fwd``),
    and the stem backward bitwise under both tie rules, at narrow shapes
    with ragged windows and more than one block of window columns."""
    dev = _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(3)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        # F = 8 and 48 take the CUDA-core path in bf16, 16 and 64 the
        # tensor cores; W' = 101 spans two w-tiles of either
        for shape, f in (((2, 11, 13, 8, 11), 8), ((2, 12, 14, 8, 13), 64),
                         ((1, 8, 9, 8, 101), 16), ((1, 7, 8, 8, 70), 48)):
            x, w, bias = _stem_inputs(g, dev, shape, f, dt)
            zs, pooled, s1, s2 = _check_stem_fwd(x, w, bias)
            # the backward on the kernel's own zs, real ties in bf16
            gp = torch.randn(pooled.shape, generator=g, device=dev).to(dt)
            g1 = torch.randn(s1.shape, generator=g, device=dev)
            g2 = 0.01 * torch.randn(s1.shape, generator=g, device=dev)
            for ties in kernels.STEM_TIES:
                got = kernels.stem_bwd(zs, pooled, gp, g1, g2, ties=ties)
                assert torch.equal(got, kernels.stem_bwd_plain(
                    zs, pooled, gp, g1, g2, ties=ties)), (shape, ties)
            assert kernels.LAUNCHES["stem_bwd"] == 2
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("shape,f", [
    ((8, 38, 38, 8, 40), 64),   # 1,152 tiles, more than the grid's blocks
    ((2, 9, 10, 8, 140), 16),   # W' > 66: three w-tiles
    ((2, 10, 8, 8, 70), 32),    # W' > 66: two w-tiles
    ((3, 12, 14, 8, 13), 64),   # D = 10, H = 12: partial 3-row tiles
    ((1, 8, 9, 8, 101), 64),    # B = 1
    ((1, 5, 5, 8, 5), 64),      # one window, boxes larger than the volume
])
def test_cuda_stem_fwd_tensor_core_shapes(shape, f):
    """The persistent tensor-core stem forward (bf16, F = 16, 32 or 64)
    against its plain version (``_check_stem_fwd``) at shapes that take
    every path of its tile loop, and a second launch on the same inputs
    bitwise equal to the first (zs, pooled, s1, s2)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x, w, bias = _stem_inputs(g, dev, shape, f, torch.bfloat16)
        first = _check_stem_fwd(x, w, bias)
        again = kernels.stem_fwd(x, w, bias)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
        cfg = kernels.stem_fwd_config(shape[0], shape[1], shape[2],
                                      shape[4], f)
        # pool-aligned tiles of 3 d-planes x 3 h-rows x 63 w-columns
        d, h, wd = shape[1] - 2, shape[2] - 2, shape[4] - 2
        assert cfg["tiles"] == shape[0] * (-(-d // 3)) * (-(-h // 3)) * (
            -(-wd // 63))
        assert 1 <= cfg["grid"] <= cfg["tiles"]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [
    (2, 9, 10, 11, 64),    # D, H, W = 0, 1, 2 mod 3
    (2, 10, 11, 9, 16),    # D, H, W = 1, 2, 0 mod 3
    (1, 11, 9, 99, 48),    # four w-chunks of 10 windows, the last ragged
    (2, 8, 7, 101, 64),    # five w-chunks of 8 windows, the last ragged
    (1, 4, 5, 200, 8),     # two w-chunks of 64 windows at F = 8
    (1, 3, 3, 3, 16),      # one window
    (2, 2, 4, 5, 8),       # no whole window (D < 3)
])
def test_cuda_stem_bwd_slab_shapes(shape, dtype):
    """The slab-loop stem backward at shapes that take every edge of its
    slabs: dzs bitwise its plain version under both tie rules (zs on a grid
    of 1/4, so windows tie), with and without the bias gradient; dbias
    within one ulp of the plain per-channel sum of dzs, or within 1e-5 of
    the channel's sum of magnitudes where that sum cancels; a second launch
    bitwise equal to the first."""
    dev = _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(17)
    zs = (torch.round(4 * torch.randn(shape, generator=g, device=dev)) / 4
          ).to(dt)
    b, d, h, w, f = shape
    if min(d, h, w) >= 3:
        pooled = torch.nn.functional.max_pool3d(
            zs.permute(0, 4, 1, 2, 3), 3, 3).permute(0, 2, 3, 4,
                                                     1).contiguous()
    else:  # no whole window: torch's max-pool refuses an empty output
        pooled = zs.new_empty((b, d // 3, h // 3, w // 3, f))
    gp = torch.randn(pooled.shape, generator=g, device=dev).to(dt)
    g1 = torch.randn((shape[0], shape[4]), generator=g, device=dev)
    g2 = 0.01 * torch.randn((shape[0], shape[4]), generator=g, device=dev)
    args = (zs, pooled, gp, g1, g2)
    for ties in kernels.STEM_TIES:
        want = kernels.stem_bwd_plain(*args, ties=ties)
        got = kernels.stem_bwd(*args, ties=ties)
        fused, dbias = kernels.stem_bwd(*args, ties=ties, bias_grad=True)
        again, dbias2 = kernels.stem_bwd(*args, ties=ties, bias_grad=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want), ties
        assert torch.equal(fused, want) and torch.equal(again, want), ties
        assert torch.equal(dbias, dbias2), ties
        assert kernels.dbias_agreement(dbias, want)[1] <= 1e-5, ties
    cfg = kernels.stem_bwd_config(*shape, dt)
    assert 1 <= cfg["grid"] <= cfg["slabs"]


@pytest.mark.cuda
def test_cuda_stem_bwd_under_autograd():
    """The stem backward launched by autograd, which runs a backward on a
    thread of its own (the kernel's tensor maps are encoded there):
    ``pool_sum_sumsq``'s cotangent bitwise the plain version's (split
    ties), and ``StemStage``'s bias gradient within one ulp of the plain
    sum of its dzs (or 1e-5 of its magnitude where that sum cancels)."""
    from neuroimagedisttraining_torch.models.alexnet3d import StemStage
    from neuroimagedisttraining_torch.ops.experimental import pallas_stem_bwd

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(19)
    bf = torch.bfloat16
    zs = (torch.round(4 * torch.randn((2, 9, 12, 10, 64), generator=g,
                                      device=dev)) / 4).to(bf)
    zr = zs.clone().requires_grad_(True)
    m, s1, s2 = pallas_stem_bwd.pool_sum_sumsq(zr)
    gp = torch.randn(m.shape, generator=g, device=dev).to(bf)
    g1 = torch.randn(s1.shape, generator=g, device=dev)
    g2 = 0.01 * torch.randn(s1.shape, generator=g, device=dev)
    (dz,) = torch.autograd.grad([m, s1, s2], [zr], [gp, g1, g2])
    assert torch.equal(dz, kernels.stem_bwd_plain(
        zs, m.detach(), gp, g1, g2, ties="split"))
    x, w, bias = _stem_inputs(g, dev, (2, 11, 14, 8, 12), 64, bf)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    outs = StemStage.apply(*leaves)
    cts = [torch.randn(o.shape, generator=g, device=dev).to(o.dtype)
           for o in outs]
    kernels.reset_launches()
    _, _, dbias = torch.autograd.grad(outs, leaves, cts)
    assert kernels.LAUNCHES["stem_bwd"] == 1
    zs2, pooled, _, _ = kernels.stem_fwd(x, w, bias)
    gpool = cts[0].permute(0, 2, 3, 4, 1).contiguous()
    dzs = kernels.stem_bwd_plain(zs2, pooled, gpool, cts[1], cts[2],
                                 ties="first")
    assert kernels.dbias_agreement(dbias, dzs)[1] <= 1e-5


@pytest.mark.cuda
def test_cuda_round_leaves_its_input_state_unchanged():
    """On the card, as ``tests/test_torch_port_state.py`` on the CPU: a
    round leaves the state it is given bitwise as it was (its generator
    too), and two rounds from ``clone_state`` copies agree bitwise."""
    dev = _card()
    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    ss = phased_sample_shape((69, 69, 69))
    data = make_synthetic_federated(seed=9, n_clients=3, samples_per_client=6,
                                    test_per_client=5, sample_shape=ss,
                                    uneven=True)
    hp = HyperParams(lr=0.01, momentum=0.9, weight_decay=5e-4,
                     local_epochs=1, steps_per_epoch=2, batch_size=4)
    algo = SalientGrads(create_model("3dcnn_s2d", num_classes=1,
                                     widths=(16, 16, 16, 16, 16),
                                     dropout_rate=0.0, sample_shape=ss),
                        data, hp, dense_ratio=0.5, agg_impl="topk",
                        agg_bucket_size=4096, compute_dtype="bfloat16",
                        device=dev)
    state = algo.init_state()
    keep = algo.clone_state(state)
    gen = state.generator.get_state().clone()
    new, _ = algo.run_round(state, 0)
    for name in ("global_params", "mask", "personal_params", "agg_residual"):
        a, b = getattr(state, name), getattr(keep, name)
        assert all(torch.equal(a[k], b[k]) for k in b), name
    assert torch.equal(state.generator.get_state(), gen)
    a, ma = algo.run_round(algo.clone_state(state), 0)
    b, mb = algo.run_round(algo.clone_state(state), 0)
    assert torch.equal(ma["train_loss"], mb["train_loss"])
    for name in ("global_params", "personal_params", "agg_residual"):
        x, y = getattr(a, name), getattr(b, name)
        assert all(torch.equal(x[k], y[k]) for k in x), name


@pytest.mark.cuda
def test_cuda_masked_sgd_lr_by_pointer_matches_by_value():
    """The launch that reads the learning rate on the card (the one a CUDA
    graph replays with a new rate) equals the by-value launch and the plain
    version bit for bit, in both masking modes."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    shapes = [(64, 8, 3, 3, 3), (1000,), (33, 9), (7,)]
    lr_dev = torch.tensor(LR, dtype=torch.float32, device=dev)
    for mask_grads in (False, True):
        ps = [torch.randn(s, generator=g, device=dev) for s in shapes]
        ms = [torch.randn(s, generator=g, device=dev) for s in shapes]
        gs = [torch.randn(s, generator=g, device=dev) for s in shapes]
        ks = [(torch.rand(s, generator=g, device=dev) > 0.5).float()
              for s in shapes]
        by_value = ([p.clone() for p in ps], [m.clone() for m in ms])
        kernels.fused_masked_sgd_step(*by_value, gs, ks, LR, momentum=MOM,
                                      wd=WD, mask_grads=mask_grads)
        kernels.fused_masked_sgd_step(ps, ms, gs, ks, lr_dev, momentum=MOM,
                                      wd=WD, mask_grads=mask_grads)
        for p, m, vp, vm in zip(ps, ms, *by_value):
            assert torch.equal(p, vp) and torch.equal(m, vm)
    with pytest.raises(ValueError, match="0-d float32"):
        kernels.fused_masked_sgd_step(ps, ms, gs, ks, lr_dev[None],
                                      momentum=MOM, wd=WD)


def _narrow_algo(dev, name, impl, frac=1.0, batch_size=4, steps=2,
                 **extra):
    from neuroimagedisttraining_torch.algorithms import FedAvg, SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    ss = phased_sample_shape((69, 69, 69))
    # shards of 9, 10, 10 and 12 rows
    data = make_synthetic_federated(seed=9, n_clients=4, samples_per_client=8,
                                    test_per_client=5, sample_shape=ss)
    hp = HyperParams(lr=0.01, lr_decay=0.9, momentum=0.9, weight_decay=5e-4,
                     local_epochs=1, steps_per_epoch=steps,
                     batch_size=batch_size)
    model = create_model("3dcnn_s2d", num_classes=1,
                         widths=(16, 16, 16, 16, 16), dropout_rate=0.5,
                         sample_shape=ss)
    kw = dict(frac=frac, agg_impl=impl, agg_bucket_size=4096,
              compute_dtype="bfloat16", device=dev, **extra)
    if name == "salientgrads":
        return SalientGrads(model, data, hp, dense_ratio=0.5, **kw)
    return FedAvg(model, data, hp, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name,impl,frac", [
    ("salientgrads", "dense", 1.0), ("salientgrads", "int8", 0.5),
    ("fedavg", "dense", 1.0)])
def test_cuda_fused_graph_matches_eager(name, impl, frac):
    """On the card at a narrow width (dropout 0.5, bf16): three rounds, each
    one replay of the captured round graph and one of the eval's, equal
    three ``run_round`` + ``evaluate`` calls from the same state bit for
    bit (losses, eval rows, parameters, generator), launch the kernels the
    eager rounds launch, and leave the input state as it was."""
    dev = _card()
    from neuroimagedisttraining_torch.algorithms.base import FUSED_WARMUPS

    algo = _narrow_algo(dev, name, impl, frac)
    s0 = algo.init_state()
    keep = algo.clone_state(s0)
    su, losses, evals = algo.clone_state(s0), [], []
    kernels.reset_launches()
    for r in range(3):
        su, met = algo.run_round(su, r)
        losses.append(float(met["train_loss"]))
        evals.append({k: float(v) for k, v in algo.evaluate(su).items()
                      if not k.startswith("acc_per")})
    eager = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    sf, ys = algo.run_rounds_fused(s0, 0, 3, eval_every=1)
    host = ys.materialize()
    fused = dict(kernels.LAUNCHES)
    assert [float(v) for v in host["train_loss"]] == losses
    for i, ev in enumerate(evals):
        assert {k: float(v[i]) for k, v in host["eval"].items()} == ev
    for f in ("global_params", "personal_params"):
        a, b = getattr(su, f), getattr(sf, f)
        assert all(torch.equal(a[k], b[k]) for k in a), f
    assert torch.equal(su.generator.get_state(), sf.generator.get_state())
    assert all(torch.equal(s0.global_params[k], keep.global_params[k])
               for k in keep.global_params)
    assert torch.equal(s0.generator.get_state(), keep.generator.get_state())
    # eager: 3 rounds and 3 evals, and the dropout probe's one forward at
    # the algorithm's first round; fused: the rounds and evals plus
    # FUSED_WARMUPS warm-up runs of each graph (a round graph per key: the
    # sampled draws of uneven shards have several)
    fz = algo._fused
    assert frac < 1 or len(fz.rounds) == 1
    for k, n in eager.items():
        warm = sum(g.launches.get(k, 0) for g in fz.rounds.values()) + \
            fz.eval.launches.get(k, 0)
        assert fused[k] == n - (k == "stem_fwd") + FUSED_WARMUPS * warm, k
    # a second block replays the graphs and continues the first exactly
    s2, ys2 = algo.run_rounds_fused(sf, 3, 1)
    su2, met = algo.run_round(su, 3)
    assert float(ys2["train_loss"][0]) == float(met["train_loss"])
    assert all(torch.equal(su2.global_params[k], s2.global_params[k])
               for k in s2.global_params)
    # the state the first block returned is not the graph's buffers
    assert all(torch.equal(sf.global_params[k], su.global_params[k])
               for k in su.global_params)


@pytest.mark.cuda
@pytest.mark.parametrize("name,frac,extra", [
    ("salientgrads", 0.5, dict(eval_cache=True)),
    ("fedavg", 1.0, dict(eval_cache=True)),
    ("salientgrads", 0.5, dict(eval_clients=3))])
def test_cuda_eval_protocol_fused_matches_eager(name, frac, extra):
    """The eval protocol under capture, at a narrow width: with
    ``eval_cache`` the round graph refreshes the cache (at ``frac`` 0.5 by
    gathers and scatters through the device client ids) and the eval graph
    re-reduces it; with ``eval_clients`` the eval graph covers the subset.
    Three fused rounds with the eval after each equal three ``run_round`` +
    ``evaluate`` calls bit for bit, the cache included, and leave the input
    state's cache as it was."""
    dev = _card()
    algo = _narrow_algo(dev, name, "dense", frac, **extra)
    s0 = algo.init_state()
    keep = algo.clone_state(s0)
    su, losses, evals = algo.clone_state(s0), [], []
    for r in range(3):
        su, met = algo.run_round(su, r)
        losses.append(float(met["train_loss"]))
        evals.append({k: float(v) for k, v in algo.evaluate(su).items()
                      if not k.startswith("acc_per")})
    sf, ys = algo.run_rounds_fused(s0, 0, 3, eval_every=1)
    host = ys.materialize()
    assert [float(v) for v in host["train_loss"]] == losses
    for i, ev in enumerate(evals):
        assert {k: float(v[i]) for k, v in host["eval"].items()} == ev
    for f in ("global_params", "personal_params", "eval_cache"):
        a, b = getattr(su, f), getattr(sf, f)
        assert (a is None) == (b is None) == (
            f == "eval_cache" and "eval_cache" not in extra), f
        if a is not None:
            assert all(torch.equal(a[k], b[k]) for k in a), f
    if s0.eval_cache is not None:
        assert all(torch.equal(s0.eval_cache[k], keep.eval_cache[k])
                   for k in keep.eval_cache)


@pytest.mark.cuda
def test_cuda_round_graph_in_segments_matches_eager(monkeypatch):
    """A round graph captured as a chain (``core.capture``), its node budget
    set so low that every local step closes a graph of the chain: two
    fused rounds equal two ``run_round`` calls bit for bit (losses,
    parameters, generator), and the chain holds one graph per local step
    and one for the aggregate, each with the nodes the CUDA driver
    counted."""
    dev = _card()
    from neuroimagedisttraining_torch.core import capture

    monkeypatch.setattr(capture, "SEGMENT_NODES", 1)
    algo = _narrow_algo(dev, "salientgrads", "dense", steps=3)
    s0 = algo.init_state()
    su, losses = algo.clone_state(s0), []
    for r in range(2):
        su, met = algo.run_round(su, r)
        losses.append(float(met["train_loss"]))
    sf, ys = algo.run_rounds_fused(s0, 0, 2)
    host = ys.materialize()
    (graph,) = algo._fused.rounds.values()
    nodes = graph.graph.nodes
    algo.release_graphs()
    assert [float(v) for v in host["train_loss"]] == losses
    for f in ("global_params", "personal_params"):
        a, b = getattr(su, f), getattr(sf, f)
        assert all(torch.equal(a[k], b[k]) for k in a), f
    assert torch.equal(su.generator.get_state(), sf.generator.get_state())
    # 4 clients of 3 steps each (shards of 9 to 12 rows, batch 4)
    assert len(nodes) == 4 * 3 + 1, nodes
    assert all(n is not None and n > 0 for n in nodes), nodes


@pytest.mark.cuda
def test_cuda_round_graphs_bounded_at_sampled_uneven_cohort():
    """Two of four uneven shards a round, at batch 1 (so each shard's step
    count is its row count), meet more step-count keys than
    the loop keeps round graphs: it never holds more than
    FUSED_MAX_GRAPHS, an evicted graph's memory pool goes back to the card
    (after the run, the reserved memory exceeds what the full cache took by
    less than one graph's share of it), and sixteen one-round blocks still
    equal sixteen ``run_round`` calls bit for bit."""
    dev = _card()
    from neuroimagedisttraining_torch.algorithms.base import FUSED_MAX_GRAPHS

    algo = _narrow_algo(dev, "salientgrads", "dense", frac=0.5,
                        batch_size=1, steps=12)
    rounds = 16
    keys = [algo._step_key([algo._n_train[int(c)] for c in
                            algo._selected_client_indexes(r)])
            for r in range(rounds)]
    assert len(set(keys)) >= FUSED_MAX_GRAPHS + 2, keys
    s0 = algo.init_state()
    su, losses = algo.clone_state(s0), []
    for r in range(rounds):
        su, met = algo.run_round(su, r)
        losses.append(float(met["train_loss"]))

    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev)

    base, full, sf, got = reserved(), None, s0, []
    for r in range(rounds):
        sf, ys = algo.run_rounds_fused(sf, r, 1)
        got.append(float(ys["train_loss"][0]))
        assert len(algo._fused.rounds) <= FUSED_MAX_GRAPHS
        if full is None and len(algo._fused.rounds) == FUSED_MAX_GRAPHS:
            full = reserved()
    end = reserved()
    assert algo._fused.evicted >= 2
    assert got == losses
    assert all(torch.equal(su.global_params[k], sf.global_params[k])
               for k in su.global_params)
    assert end - full < (full - base) / FUSED_MAX_GRAPHS, (base, full, end)


@pytest.mark.cuda
def test_cuda_capture_error_raises():
    """A body the card cannot capture (it waits on the card) raises
    ``ValueError`` naming what was captured, and the card keeps working."""
    dev = _card()
    from neuroimagedisttraining_torch.algorithms.base import _Graph

    x = torch.ones(4, device=dev)

    def body(warm):
        return torch.full((), float((x * 2).sum()), device=dev)

    with pytest.raises(ValueError, match="the probe cannot be captured"):
        _Graph(body, dev, "the probe")
    assert float((x + 1).sum()) == 8.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["DisPFL", "SubAvg"])
def test_cuda_personal_round_matches_cpu(name):
    """A DisPFL round (fire and regrow on the screening gradient) and a
    SubAvg round (both legs, the prune, the gates) on the CPU and on the
    card from the same parameters, masks and draws, cuDNN's TF32 off: the
    card launches the masked SGD kernel's ``mask_grads`` branch once a
    step; the masks agree but for decisions within round-off of a
    threshold (at most 1e-3 of them); losses within 1e-5 and the kernel
    leaves within 1e-5 norm-wise where the masks agree."""
    from neuroimagedisttraining_torch import algorithms
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.core.trainer import epoch_permutations
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model, init_params

    dev = _card()
    clients, steps, bs = 4, 2, 4
    data = make_synthetic_federated(seed=5, n_clients=clients,
                                    samples_per_client=8, test_per_client=4,
                                    sample_shape=(8, 8, 8, 1))
    hp = HyperParams(lr=0.05, momentum=0.9, local_epochs=2,
                     steps_per_epoch=steps, batch_size=bs)
    g = torch.Generator().manual_seed(0)
    params = init_params(create_model("small3dcnn", num_classes=1), g)
    n_rows = data.x_train.shape[1]
    seams = dict(
        perms=[epoch_permutations(g, int(n), 2, steps * bs, n_rows=n_rows)
               for n in data.n_train],
        perms_2=[epoch_permutations(g, int(n), 1, steps * bs, n_rows=n_rows)
                 for n in data.n_train],
        screen_idx=[torch.randint(0, int(n), (bs,), generator=g)
                    for n in data.n_train])
    kw = (dict(dense_ratio=0.5, total_rounds=4) if name == "DisPFL"
          else dict(acc_thresh=0.0))
    out, masks = {}, None
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # f32 convs, as on the CPU
    try:
        for device in ("cpu", dev):
            algo = getattr(algorithms, name)(
                create_model("small3dcnn", num_classes=1), data, hp,
                loss_type="bce", device=device, **kw)
            init = dict(params=params)
            if name == "DisPFL":
                init["masks"] = masks
            state = algo.init_state(**init)
            if masks is None and name == "DisPFL":
                masks = {k: v.cpu() for k, v in state.masks.items()}
            kernels.reset_launches()
            state, met = algo.run_round(
                state, 0, **{k: v for k, v in seams.items()
                             if k != "perms_2" or name == "SubAvg"})
            launches = dict(kernels.LAUNCHES)
            launches.update(kernels.BRANCH_LAUNCHES)
            field = ("personal_params" if name == "DisPFL"
                     else "global_params")
            out[device] = ({k: v.cpu() for k, v in
                            getattr(state, field).items()},
                           {k: v.cpu() for k, v in state.masks.items()},
                           float(met["train_loss"]), launches)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (pc_, mc, lc, _), (pg, mg, lg, lau) = out["cpu"], out[dev]
    step_count = clients * 2 * steps  # every client, two epochs
    assert lau["masked_sgd"] == step_count, lau
    assert lau["masked_sgd_mask_grads"] == step_count, lau
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    same = {k: mg[k] == mc[k] for k in mc}
    agree = sum(int(v.sum()) for v in same.values()) / sum(
        v.numel() for v in same.values())
    assert agree >= 1 - 1e-3, agree
    for k, c in pc_.items():
        if not k.endswith(".kernel"):
            continue
        w = same[k] if name == "DisPFL" else same[k].all(dim=0)
        err = float(((pg[k] - c) * w).norm() / (c * w).norm())
        assert err < 1e-5, (name, k, err)
