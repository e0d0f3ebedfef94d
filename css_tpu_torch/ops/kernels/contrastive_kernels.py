"""InfoNCE negative sums: the CUDA kernels K1/K2, their plain versions, and
the autograd glue.

Counterpart of ``css_tpu/ops/pallas/contrastive_kernels.py``:

    s[q] = sum_n w[n] * exp(inv_temp * <a[q], r[n]>)         K1 (forward)
    M[q] = sum_n w[n] * exp(inv_temp * <a[q], r[n]>) * r[n]  K2 (backward)

with ``a`` [Q, D] the anchors (rounded to bf16 for the product), ``r`` [N, D]
the bf16 no-grad table and ``w`` [N] f32 weights.  K2 rounds the weighted
exponentials to bf16 before the second product, as the TPU kernel does.

On CUDA tensors the wrappers launch the kernels of
``css_tpu_torch/csrc/contrastive_kernels.cu`` (or raise); on CPU tensors they
run the plain PyTorch versions, which upcast the bf16 operands and take the
products in f32.  ``LAUNCHES`` counts kernel launches, so a run can show that
it went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from css_tpu_torch.ops.kernels._build import load_library

__all__ = ["weighted_exp_softsum", "weighted_exp_softsum_stochastic",
           "thinned_multiplicities", "WeightedExpSoftsum", "softsum_plain",
           "softsum_moment_plain", "softsum_kernel", "softsum_moment_kernel",
           "LAUNCHES", "reset_launches", "SOURCE"]

SOURCE = "contrastive_kernels.cu"
TILE_N = 64            # table rows per tile (kBN in the source)
BLOCK_Q = 64           # anchor rows per CTA (kBQ)
FWD_CHUNKS = 256       # N is split into at most this many chunks per launch
BWD_CHUNKS = 64        # fewer for K2: its partials are [chunks, Q, D]
MAX_TILES_PER_CHUNK = 1024
_D_PAD = (64, 128, 256)

LAUNCHES = {"weighted_exp_softsum_fwd": 0, "weighted_exp_softsum_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------- plain ----

def softsum_plain(a: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                  inv_temp: float) -> torch.Tensor:
    """K1's plain version: s [Q] f32 from bf16 ``a``/``r`` and f32 ``w``."""
    logits = (a.float() @ r.float().T) * inv_temp
    return torch.sum(torch.exp(logits) * w[None, :], dim=1)


def softsum_moment_plain(a: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                         inv_temp: float) -> torch.Tensor:
    """K2's plain version: M [Q, D] f32, ``e`` rounded to bf16 first."""
    logits = (a.float() @ r.float().T) * inv_temp
    e = (torch.exp(logits) * w[None, :]).to(torch.bfloat16)
    return e.float() @ r.float()


# --------------------------------------------------------------- kernels ---

def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if not getattr(lib, "_css_bound", False):
        for fn in (lib.css_weighted_exp_softsum_fwd, lib.css_weighted_exp_softsum_bwd):
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._css_bound = True
    return lib


def _check_cuda_operands(a, r, w):
    dev = a.device
    if r.device != dev or w.device != dev:
        raise ValueError(f"weighted_exp_softsum: a, r, w must share one device; "
                         f"got {a.device}, {r.device}, {w.device}")
    if a.dtype != torch.bfloat16 or r.dtype != torch.bfloat16 or w.dtype != torch.float32:
        raise TypeError(f"weighted_exp_softsum kernel: need bf16 a/r and f32 w; "
                        f"got {a.dtype}, {r.dtype}, {w.dtype}")
    if not (r.is_contiguous() and w.is_contiguous()):
        raise ValueError("weighted_exp_softsum kernel: r and w must be contiguous")
    if r.data_ptr() % 16:
        raise ValueError("weighted_exp_softsum kernel: r must be 16-byte aligned")
    if a.shape[1] > _D_PAD[-1]:
        raise ValueError(f"weighted_exp_softsum kernel: D={a.shape[1]} exceeds "
                         f"{_D_PAD[-1]}")


def _prepare(a, r, w, max_chunks):
    """Pads a to [q_pad, d_pad] and r to d_pad (exact: zero rows/columns add
    nothing) and splits N into chunks of whole tiles."""
    _check_cuda_operands(a, r, w)
    q, d = a.shape
    n = r.shape[0]
    d_pad = next(p for p in _D_PAD if p >= d)
    q_pad = -(-max(q, 1) // BLOCK_Q) * BLOCK_Q
    if (q_pad, d_pad) == (q, d) and a.is_contiguous():
        a_p = a
    else:
        a_p = torch.zeros((q_pad, d_pad), dtype=torch.bfloat16, device=a.device)
        a_p[:q, :d] = a
    if d_pad != d:
        r = torch.nn.functional.pad(r, (0, d_pad - d))
    n_tiles = max(-(-n // TILE_N), 1)
    tiles_per_chunk = max(-(-n_tiles // max_chunks), 1)
    if tiles_per_chunk > MAX_TILES_PER_CHUNK:
        tiles_per_chunk = MAX_TILES_PER_CHUNK
    chunks = -(-n_tiles // tiles_per_chunk)
    return a_p, r, q_pad, d_pad, n, chunks, tiles_per_chunk


def _launch(fn_name, a_p, r, w, partial, out, q_pad, d_pad, n, chunks,
            tiles_per_chunk, inv_temp):
    lib = _library()
    stream = torch.cuda.current_stream(a_p.device).cuda_stream
    rc = getattr(lib, fn_name)(
        a_p.data_ptr(), r.data_ptr(), w.data_ptr(), partial.data_ptr(),
        out.data_ptr(), q_pad, d_pad, n, chunks, tiles_per_chunk,
        float(inv_temp), stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}")


def softsum_kernel(a: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                   inv_temp: float) -> torch.Tensor:
    """K1 on the card: s [Q] f32."""
    a_p, r_p, q_pad, d_pad, n, chunks, tpc = _prepare(a, r, w, FWD_CHUNKS)
    partial = torch.empty((chunks, q_pad), dtype=torch.float32, device=a.device)
    out = torch.empty((q_pad,), dtype=torch.float32, device=a.device)
    _launch("css_weighted_exp_softsum_fwd", a_p, r_p, w, partial, out, q_pad,
            d_pad, n, chunks, tpc, inv_temp)
    LAUNCHES["weighted_exp_softsum_fwd"] += 1
    return out[:a.shape[0]]


def softsum_moment_kernel(a: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                          inv_temp: float) -> torch.Tensor:
    """K2 on the card: M [Q, D] f32."""
    a_p, r_p, q_pad, d_pad, n, chunks, tpc = _prepare(a, r, w, BWD_CHUNKS)
    partial = torch.empty((chunks, q_pad, d_pad), dtype=torch.float32, device=a.device)
    out = torch.empty((q_pad, d_pad), dtype=torch.float32, device=a.device)
    _launch("css_weighted_exp_softsum_bwd", a_p, r_p, w, partial, out, q_pad,
            d_pad, n, chunks, tpc, inv_temp)
    LAUNCHES["weighted_exp_softsum_bwd"] += 1
    return out[:a.shape[0], :a.shape[1]]


def _softsum(a, r, w, inv_temp):
    if a.is_cuda:
        return softsum_kernel(a, r, w, inv_temp)
    return softsum_plain(a, r, w, inv_temp)


def _softsum_moment(a, r, w, inv_temp):
    if a.is_cuda:
        return softsum_moment_kernel(a, r, w, inv_temp)
    return softsum_moment_plain(a, r, w, inv_temp)


class WeightedExpSoftsum(torch.autograd.Function):
    """s = K1(a, r, w); the gradient for ``a`` is (g * inv_temp)[:, None] * K2.

    Forward saves its operands (the bf16 anchors, the table and the weights)
    so backward runs K2 once and never re-runs K1.  ``r`` and ``w`` get no
    gradient, as in the TPU custom_vjp.
    """

    @staticmethod
    def forward(ctx, a, r, w, inv_temp):
        a_b = a.to(torch.bfloat16)
        ctx.save_for_backward(a_b, r, w)
        ctx.inv_temp = float(inv_temp)
        ctx.a_dtype = a.dtype
        return _softsum(a_b, r, w, ctx.inv_temp)

    @staticmethod
    def backward(ctx, g):
        a_b, r, w = ctx.saved_tensors
        m = _softsum_moment(a_b, r, w, ctx.inv_temp)
        da = (g * ctx.inv_temp)[:, None] * m
        return da.to(ctx.a_dtype), None, None, None


def weighted_exp_softsum(a: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                         inv_temp: float) -> torch.Tensor:
    """s[q] = sum_n w[n] * exp(inv_temp * <a[q], r[n]>), differentiable in ``a``.

    ``a`` [Q, D], ``r`` [N, D] bf16 (no grad), ``w`` [N] f32.  Inconsistent
    shapes raise here, with the reference's messages.
    """
    if a.ndim != 2 or r.ndim != 2 or a.shape[1] != r.shape[1]:
        raise ValueError(
            f"weighted_exp_softsum: need a [Q, D] and r [N, D] with matching "
            f"D; got a {tuple(a.shape)}, r {tuple(r.shape)}")
    if tuple(w.shape) != (r.shape[0],):
        raise ValueError(
            f"weighted_exp_softsum: weights w must be [N]={r.shape[0]}, "
            f"got {tuple(w.shape)}")
    return WeightedExpSoftsum.apply(a, r, w, inv_temp)


def thinned_multiplicities(u: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """m[N] = floor(lam) + Bernoulli(lam - floor(lam)), with the uniforms
    ``u`` [N] given; no gradient."""
    lam = lam.detach()
    base = torch.floor(lam)
    return base + (u < lam - base).to(lam.dtype)


def weighted_exp_softsum_stochastic(a: torch.Tensor, r: torch.Tensor,
                                    lam: torch.Tensor, inv_temp: float,
                                    u: torch.Tensor) -> torch.Tensor:
    """S[q] = sum_n m_n * exp(inv_temp * <a[q], r[n]>), m thinned from ``lam``
    with the uniforms ``u`` [N]; the multiset is shared by the Q anchors."""
    if tuple(lam.shape) != (r.shape[0],):
        raise ValueError(
            f"weighted_exp_softsum_stochastic: lam must be [N]={r.shape[0]}, "
            f"got {tuple(lam.shape)}")
    return weighted_exp_softsum(a, r, thinned_multiplicities(u, lam), inv_temp)
