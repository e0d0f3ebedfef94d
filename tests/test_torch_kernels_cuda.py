"""The CUDA kernels K1/K2 against their plain PyTorch versions, on the card.

Needs no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m gpu

Tolerances: the kernel and the plain version multiply the same bf16 values
with f32 accumulation, in a different order, so ``s`` agrees to rtol 1e-3.
K2 rounds ``exp`` to bf16 before its second product, and an order-of-sum
difference can flip that rounding by one bf16 step (2^-8 relative) on single
entries, so ``M`` is held to rtol 1e-2 with atol 1e-2 * max|M|.
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
    assert ck.LAUNCHES == {"weighted_exp_softsum_fwd": 1, "weighted_exp_softsum_bwd": 1}

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
