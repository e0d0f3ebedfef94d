"""The CUDA kernels (live-row compaction, K1, K2) against their plain
PyTorch versions, on the card.

Needs no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m gpu

Tolerances: the kernel and the plain version multiply the same bf16 values
with f32 accumulation, in a different order, so ``s`` agrees to rtol 1e-3.
K2 rounds ``exp`` to bf16 before its second product, and an order-of-sum
difference can flip that rounding by one bf16 step (2^-8 relative) on single
entries, so ``M`` is held to rtol 1e-2 with atol 1e-2 * max|M|.  The
compaction is exact: same indices, same order, same count as torch.nonzero.
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
    assert ck.LAUNCHES == {"live_rows_compact": 1, "weighted_exp_softsum_fwd": 1,
                           "weighted_exp_softsum_bwd": 1}

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
        x = a.to(dev).requires_grad_(True)
        s = ck.weighted_exp_softsum(x, r.to(dev), w.to(dev), 2.0)
        (s * upstream.to(dev)).sum().backward()
        out[dev] = (s.detach().cpu(), x.grad.cpu())
    assert 0.7 * n < int((w > 0).sum()) < 0.8 * n
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-3, atol=1e-6)
    _close_m(out["cuda"][1], out["cpu"][1])
