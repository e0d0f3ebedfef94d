"""The CUDA kernels (the live-row compactions, K1, K2) against their plain
PyTorch versions, on the card.

Needs no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m gpu

Tolerances: the kernel and the plain version multiply the same bf16 values
with f32 accumulation, in a different order, so ``s`` agrees to rtol 1e-3.
K2 rounds ``exp`` to bf16 before its second product, and an order-of-sum
difference can flip that rounding by one bf16 step (2^-8 relative) on single
entries, so ``M`` is held to rtol 1e-2 with atol 1e-2 * max|M|.  The
compactions are exact: same indices, same order, same count as torch.nonzero
and, for every class at once, as ``class_live_rows_plain``.
"""

import pytest
import torch

from css_tpu_torch.ops.kernels import contrastive_kernels as ck


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(device, q, d, n, seed, dead_tail=0.0, thinned=False):
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.nn.functional.normalize(torch.randn(q, d, generator=g), dim=1)
    r = torch.nn.functional.normalize(torch.randn(n, d, generator=g), dim=1)
    if thinned:
        lam = torch.rand(n, generator=g) * (512.0 / n) * 2.0
        w = ck.thinned_multiplicities(torch.rand(n, generator=g), lam)
    else:
        w = torch.rand(n, generator=g)
    if dead_tail:
        w[int(n * (1 - dead_tail)):] = 0.0
    return (a.to(device).to(torch.bfloat16), r.to(device).to(torch.bfloat16),
            w.to(device))


def _close_m(got, want):
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("q,d,n,dead,thinned", [
    (256, 256, 262144, 0.5, False),   # main-path shape, dead unlabeled half
    (256, 256, 262144, 0.5, True),    # main-path shape, thinned multiplicities
    (256, 256, 297992, 0.5, True),    # Cityscapes table (8 x 193^2 rows), thinned: a
                                      # multiple of neither the 64-row tile nor 2048
    (16, 128, 4 * 2048, 0.5, False),  # dead tiles at the TPU test's shape
    (13, 48, 500, 0.0, False),        # odd Q and D, ragged N
    (64, 64, 65, 0.0, False),         # one row past a tile
])
def test_kernels_match_plain(cuda, q, d, n, dead, thinned):
    a, r, w = _case(cuda, q, d, n, seed=q + d + n, dead_tail=dead, thinned=thinned)
    inv_t = 2.0
    s = ck.softsum_kernel(a, r, w, inv_t)
    m = ck.softsum_moment_kernel(a, r, w, inv_t)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, ck.softsum_plain(a, r, w, inv_t), rtol=1e-3, atol=1e-6)
    _close_m(m, ck.softsum_moment_plain(a, r, w, inv_t))


@pytest.mark.gpu
def test_all_dead_weights_give_zeros(cuda):
    a, r, w = _case(cuda, 64, 256, 4096, seed=5)
    w.zero_()
    assert torch.count_nonzero(ck.softsum_kernel(a, r, w, 2.0)) == 0
    assert torch.count_nonzero(ck.softsum_moment_kernel(a, r, w, 2.0)) == 0


@pytest.mark.gpu
def test_kernels_reproduce_bit_for_bit(cuda):
    a, r, w = _case(cuda, 256, 256, 100_000, seed=7)
    s1, s2 = ck.softsum_kernel(a, r, w, 2.0), ck.softsum_kernel(a, r, w, 2.0)
    m1, m2 = (ck.softsum_moment_kernel(a, r, w, 2.0),
              ck.softsum_moment_kernel(a, r, w, 2.0))
    assert torch.equal(s1, s2) and torch.equal(m1, m2)


@pytest.mark.gpu
def test_autograd_function_uses_both_kernels(cuda):
    a, r, w = _case(cuda, 32, 256, 10_000, seed=9)
    a = a.float().requires_grad_(True)
    ck.reset_launches()
    torch.log(ck.weighted_exp_softsum(a, r, w, 2.0)).sum().backward()
    assert ck.LAUNCHES == {"class_live_rows": 0, "live_rows_compact": 1,
                           "weighted_exp_softsum_fwd": 1, "weighted_exp_softsum_bwd": 1}

    a_ref = a.detach().clone().requires_grad_(True)
    logits = (a_ref.to(torch.bfloat16).float() @ r.float().T) * 2.0
    torch.log((torch.exp(logits) * w[None]).sum(1)).sum().backward()
    torch.testing.assert_close(a.grad, a_ref.grad, rtol=5e-2, atol=1e-3)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_bad_operands(cuda):
    a, r, w = _case(cuda, 16, 128, 256, seed=3)
    with pytest.raises(TypeError):
        ck.softsum_kernel(a, r.float(), w, 2.0)
    with pytest.raises(ValueError):
        ck.softsum_kernel(a, r, w.cpu(), 2.0)


def _live_weights(n, pattern, seed):
    """Weights with a given set of live rows: ``single`` (one row), ``all``
    (every row), ``run:<start>:<length>`` (a contiguous run) or ``scattered``
    (thinned multiplicities over the whole table, sum(lam) = 512)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    w = torch.zeros(n)
    if pattern == "single":
        w[n // 3] = 1.5
    elif pattern == "all":
        w = torch.rand(n, generator=g) + 0.1
    elif pattern.startswith("run:"):
        start, length = (int(x) for x in pattern.split(":")[1:])
        w[start:start + length] = torch.rand(length, generator=g) + 0.1
    else:
        lam = torch.rand(n, generator=g) * (1024.0 / n)
        w = ck.thinned_multiplicities(torch.rand(n, generator=g), lam)
    return w


@pytest.mark.gpu
@pytest.mark.parametrize("q,d,n,pattern", [
    (64, 256, 100_000, "single"),              # one live row
    (128, 128, 5_000, "all"),                  # every row live
    (256, 256, 20_000, "run:3000:6417"),       # 101 live tiles over 66 chunks (132 SMs):
                                               # chunk boundaries inside the run, uneven split
    (256, 256, 50_000, "run:777:129"),         # L one past a multiple of 64
    (256, 256, 262_144, "scattered"),          # thinned over the whole table
    (13, 48, 3_000, "scattered"),              # odd Q and D
    (192, 256, 30_000, "scattered"),           # three anchor blocks: one idle warpgroup
])
def test_kernels_match_plain_live_patterns(cuda, q, d, n, pattern):
    a, r, _ = _case(cuda, q, d, n, seed=q + d + n)
    w = _live_weights(n, pattern, seed=n).to(cuda)
    s = ck.softsum_kernel(a, r, w, 2.0)
    m = ck.softsum_moment_kernel(a, r, w, 2.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, ck.softsum_plain(a, r, w, 2.0), rtol=1e-3, atol=1e-6)
    _close_m(m, ck.softsum_moment_plain(a, r, w, 2.0))


@pytest.mark.gpu
@pytest.mark.parametrize("n,pattern", [
    (262_144, "scattered"), (262_144, "run:131072:131072"), (297_992, "scattered"),
    (297_992, "run:297900:92"), (5_000, "all"),
    (100_000, "single"), (4_096, "run:0:0"), (2_049, "run:2040:9")])
def test_compaction_matches_nonzero(cuda, n, pattern):
    w = _live_weights(n, pattern, seed=n).to(cuda)
    idx, wv, n_live = ck.compact_live_rows_kernel(w)
    want = torch.nonzero(w).flatten()
    count = int(n_live.item())
    assert count == want.numel()
    assert torch.equal(idx[:count].long(), want)
    assert torch.equal(wv[:count], w[want])


@pytest.mark.gpu
def test_no_host_sync_on_the_path(cuda):
    a, r, _ = _case(cuda, 256, 256, 50_000, seed=11)
    w = _live_weights(50_000, "scattered", seed=11).to(cuda)
    a = a.float().requires_grad_(True)
    ck.weighted_exp_softsum(a, r, w, 2.0)   # build and bind the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = ck.weighted_exp_softsum(a, r, w, 2.0)
        torch.log(s).sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(a.grad).all()


@pytest.mark.gpu
def test_kernels_launch_on_their_tensors_device(cuda):
    """Tensors on cuda:1 while cuda:0 is current: the wrappers launch on
    the tensors' device (the library sets its attribute and launches on
    the current one), forward and backward."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: the tensors' device must differ from the current one")
    other = torch.device("cuda:1")
    a, r, _ = _case(other, 256, 256, 50_000, seed=13)
    w = _live_weights(50_000, "scattered", seed=13).to(other)
    a = a.float().requires_grad_(True)
    with torch.cuda.device(0):
        s = ck.weighted_exp_softsum(a, r, w, 2.0)
        torch.log(s).sum().backward()
        m = ck.softsum_moment_kernel(a.detach().to(torch.bfloat16), r, w, 2.0)
    torch.cuda.synchronize(other)
    assert s.device == a.grad.device == m.device == other
    torch.testing.assert_close(s, ck.softsum_plain(a.detach().to(torch.bfloat16), r, w, 2.0),
                               rtol=1e-3, atol=1e-6)
    _close_m(m, ck.softsum_moment_plain(a.detach().to(torch.bfloat16), r, w, 2.0))
    assert torch.isfinite(a.grad).all()


@pytest.mark.gpu
def test_dense_weights_forward_and_backward_match_plain(cuda):
    """``weighted_exp_softsum`` as ``expected_pallas`` calls it: one class's
    dense weights p[class(n)] / count(class(n)) over every member row (a
    step-like density: 80% of the 262,144 rows members, 21 classes, the
    anchor class's own rows weightless), forward and backward against the
    same autograd graph through the plain versions on the CPU."""
    g = torch.Generator(device="cpu").manual_seed(11)
    n, q, d, c = 262_144, 256, 256, 21
    cls = torch.randint(0, c, (n,), generator=g)
    member = torch.rand(n, generator=g) < 0.8
    counts = torch.bincount(cls[member], minlength=c).float()
    p = torch.softmax(torch.randn(c, generator=g), dim=0)
    p[0] = 0.0                                          # the anchors' own class
    w = torch.where(member, p[cls] / counts[cls].clamp_min(1.0), torch.zeros(()))
    a = torch.nn.functional.normalize(torch.randn(q, d, generator=g), dim=1)
    r = torch.nn.functional.normalize(torch.randn(n, d, generator=g), dim=1).to(torch.bfloat16)
    upstream = torch.rand(q, generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        # a leaf of its own per device: a.to("cpu") is a itself, and a leaf
        # made to require grad there would make a.to("cuda") a non-leaf
        x = a.detach().to(dev).requires_grad_(True)
        s = ck.weighted_exp_softsum(x, r.to(dev), w.to(dev), 2.0)
        (s * upstream.to(dev)).sum().backward()
        out[dev] = (s.detach().cpu(), x.grad.cpu())
    assert 0.7 * n < int((w > 0).sum()) < 0.8 * n
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-3, atol=1e-6)
    _close_m(out["cuda"][1], out["cpu"][1])


def _class_case(device, c, n, seed, thinned):
    """Inputs of ``class_live_rows`` as the loss builds them: p_over_cnt
    [C, C+1] (the last column 0; class 0 without pixels, so its column is
    0 too, and without negatives, so its row is 0: no live row), masked_cls
    [N] int32 in [0, C] (C: not a member), the uniforms."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    cls = torch.randint(0, c + 1, (n,), generator=g)
    cls[cls == 0] = c
    counts = torch.bincount(cls, minlength=c + 1)[:c].float()
    p = torch.softmax(torch.randn(c, c, generator=g), dim=1) * (counts > 0)
    p[0] = 0.0
    p_over_cnt = torch.nn.functional.pad(p / counts.clamp_min(1.0), (0, 1))
    u = torch.rand(c, n, generator=g) if thinned else None
    return (p_over_cnt.to(device), cls.to(torch.int32).to(device),
            None if u is None else u.to(device))


def _assert_same_rows(got, want):
    idx, wv, n_live = got
    idx_ref, wv_ref, n_ref = want
    assert torch.equal(n_live, n_ref)
    for k, live in enumerate(n_ref.tolist()):
        assert torch.equal(idx[k, :live], idx_ref[k, :live])
        assert torch.equal(wv[k, :live], wv_ref[k, :live])


@pytest.mark.gpu
@pytest.mark.parametrize("thinned", [True, False])
@pytest.mark.parametrize("c,n", [(21, 262_144), (19, 297_992), (3, 1_000), (5, 2_049),
                                 (2, 2_000_000)])
def test_class_live_rows_match_plain(cuda, c, n, thinned):
    p_over_cnt, cls, u = _class_case(cuda, c, n, seed=c + n, thinned=thinned)
    got = ck.class_live_rows_kernel(p_over_cnt, cls, 512, u)
    torch.cuda.synchronize()
    want = ck.class_live_rows_plain(p_over_cnt, cls, 512, u)
    _assert_same_rows(got, want)
    assert got[0].shape == want[0].shape == (c, -(-n // 64) * 64)
    assert int(want[2][0]) == 0 and int(want[2].sum()) > 0


@pytest.mark.gpu
def test_class_live_rows_reproduce_bit_for_bit(cuda):
    p_over_cnt, cls, u = _class_case(cuda, 21, 262_144, seed=3, thinned=True)
    _assert_same_rows(ck.class_live_rows_kernel(p_over_cnt, cls, 512, u),
                      ck.class_live_rows_kernel(p_over_cnt, cls, 512, u))


@pytest.mark.gpu
def test_class_live_rows_no_host_sync(cuda):
    """The batched compaction and K1/K2 over one class's row, forward and
    backward, without a host synchronisation."""
    p_over_cnt, cls, u = _class_case(cuda, 21, 50_000, seed=5, thinned=True)
    a, r, _ = _case(cuda, 256, 256, 50_000, seed=5)
    a = a.float().requires_grad_(True)
    ck.class_live_rows(p_over_cnt, cls, 512, u)   # build and bind the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx, wv, n_live = ck.class_live_rows(p_over_cnt, cls, 512, u)
        s = ck.weighted_exp_softsum_live(a, r, idx[4], wv[4], n_live[4:5], 2.0)
        torch.log(s).sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(a.grad).all()


@pytest.mark.gpu
def test_class_live_rows_refuses_bad_operands(cuda):
    p_over_cnt, cls, u = _class_case(cuda, 5, 3_000, seed=7, thinned=True)
    with pytest.raises(TypeError):
        ck.class_live_rows_kernel(p_over_cnt, cls.long(), 512, u)
    with pytest.raises(TypeError):
        ck.class_live_rows_kernel(p_over_cnt[:, :5].contiguous(), cls, 512, u)
    with pytest.raises(TypeError):
        ck.class_live_rows_kernel(p_over_cnt, cls, 512, u[:, :100].contiguous())
    with pytest.raises(ValueError):
        ck.class_live_rows_kernel(p_over_cnt, cls, 512, u.t().contiguous().t())
    with pytest.raises(ValueError):
        ck.class_live_rows_kernel(p_over_cnt, cls.cpu(), 512, u)
    with pytest.raises(ValueError):
        ck.class_live_rows_kernel(torch.zeros(128, 129, device=cuda), cls, 512)
    with pytest.raises(ValueError):
        ck.class_live_rows_kernel(p_over_cnt, torch.zeros(ck.CLASS_MAX_ROWS + 1,
                                                          dtype=torch.int32, device=cuda), 512)


@pytest.mark.gpu
def test_class_live_rows_launch_on_their_tensors_device(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: the tensors' device must differ from the current one")
    other = torch.device("cuda:1")
    p_over_cnt, cls, u = _class_case(other, 21, 100_000, seed=9, thinned=True)
    with torch.cuda.device(0):
        got = ck.class_live_rows_kernel(p_over_cnt, cls, 512, u)
    torch.cuda.synchronize(other)
    assert all(t.device == other for t in got)
    _assert_same_rows(got, ck.class_live_rows_plain(p_over_cnt, cls, 512, u))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sampled_pallas", "expected_pallas"])
def test_loss_through_class_live_rows_equals_per_class_path(cuda, mode):
    """The contrastive loss, its prototypes and its gradient on the card:
    through ``class_live_rows`` against K1/K2 fed each class's weights as
    the loss built them before (``weighted_exp_softsum_stochastic`` or
    ``weighted_exp_softsum``), bit for bit: the compactions are equal, so is
    the rest."""
    from css_tpu_torch.losses import contrastive as con

    g = torch.Generator(device="cpu").manual_seed(1)
    b, h, w, c, q, d = 4, 32, 32, 21, 256, 256
    n = b * h * w
    onehot = torch.nn.functional.one_hot(torch.randint(0, c, (b, h, w), generator=g), c)
    inputs = [torch.randn(b, h, w, d, generator=g), onehot.float(),
              (torch.rand(b, h, w, generator=g) < 0.8).float(),
              torch.softmax(3 * torch.randn(b, h, w, c, generator=g), dim=-1),
              torch.randn(c, d, generator=g)]
    draws = dict(tie=torch.randint(0, 1 << 24, (n,), generator=g, dtype=torch.int32),
                 u1=torch.rand(c, q, generator=g))
    if mode == "sampled_pallas":
        draws["u"] = torch.rand(c, n, generator=g)
    inputs = [x.to(cuda) for x in inputs]
    draws = {k: v.to(cuda) for k, v in draws.items()}
    out = []
    for per_class in (False, True):
        real = con.class_live_rows, con.weighted_exp_softsum_live
        seen = []

        def recording(p_over_cnt, masked_cls, g_, u=None):
            seen.append((p_over_cnt, masked_cls.long(), g_, u))
            return real[0](p_over_cnt, masked_cls, g_, u)

        def one_class(a, r, idx, wv, n_live, inv_temp):
            p_over_cnt, masked_cls, g_, u = seen[0]
            k = len(seen) - 1
            seen.append(k)
            w_k = p_over_cnt[k][masked_cls]
            if u is None:
                return ck.weighted_exp_softsum(a, r, w_k, inv_temp)
            return ck.weighted_exp_softsum_stochastic(a, r, g_ * w_k, inv_temp, u[k])
        if per_class:
            con.class_live_rows, con.weighted_exp_softsum_live = recording, one_class
        try:
            ck.reset_launches()
            x = inputs[0].detach().requires_grad_(True)
            loss, protos = con.prototype_contrastive_loss(x, *inputs[1:], **draws,
                                                          negative_mode=mode)
            loss.backward()
            launches = dict(ck.LAUNCHES)
        finally:
            con.class_live_rows, con.weighted_exp_softsum_live = real
        want = ({"class_live_rows": 1, "live_rows_compact": c} if per_class
                else {"class_live_rows": 1, "live_rows_compact": 0})
        assert launches == dict(want, weighted_exp_softsum_fwd=c, weighted_exp_softsum_bwd=c)
        out.append((loss.detach(), protos, x.grad))
    for got, want in zip(*out):
        assert torch.equal(got, want)
