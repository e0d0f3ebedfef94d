"""InfoNCE negative sums: the CUDA kernels K1/K2, their plain versions, and
the autograd glue.

Counterpart of ``css_tpu/ops/pallas/contrastive_kernels.py``:

    s[q] = sum_n w[n] * exp(inv_temp * <a[q], r[n]>)         K1 (forward)
    M[q] = sum_n w[n] * exp(inv_temp * <a[q], r[n]>) * r[n]  K2 (backward)

with ``a`` [Q, D] the anchors (rounded to bf16 for the product), ``r`` [N, D]
the bf16 no-grad table and ``w`` [N] f32 weights.  K2 rounds the weighted
exponentials to bf16 before the second product, as the TPU kernel does.

Only rows with a nonzero weight contribute, so a compaction first lists them:
``idx`` [N] int32 (the live rows, ascending, in the first L entries), ``wv``
[N] f32 (their weights) and ``n_live`` [1] int32 (L, kept on the device).  K1
and K2 run over that list; the autograd function compacts once in forward
and saves the compaction for backward.

On CUDA tensors the wrappers launch the kernels of
``css_tpu_torch/csrc/contrastive_kernels.cu`` (or raise); on CPU tensors they
run the plain PyTorch versions, which upcast the bf16 operands and take the
products in f32.  ``LAUNCHES`` counts wrapper launches (compaction, K1, K2),
so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from css_tpu_torch.ops.kernels._build import load_library

__all__ = ["weighted_exp_softsum", "weighted_exp_softsum_stochastic",
           "thinned_multiplicities", "WeightedExpSoftsum", "softsum_plain",
           "softsum_moment_plain", "softsum_kernel", "softsum_moment_kernel",
           "compact_live_rows", "compact_live_rows_plain", "compact_live_rows_kernel",
           "softsum_live_plain", "softsum_moment_live_plain", "softsum_live_kernel",
           "softsum_moment_live_kernel", "LAUNCHES", "reset_launches", "SOURCE"]

SOURCE = "contrastive_kernels.cu"
TILE_N = 64            # live rows per tile, anchors per warpgroup (kTile in the source)
BLOCK_Q = 64           # Q pads to this
CTA_ANCHORS = 128      # anchors per CTA (kAnchors)
COMPACT_BLOCK = 2048   # weights per compaction block (kCompactBlock)
_D_PAD = (64, 128, 256)

LAUNCHES = {"live_rows_compact": 0, "weighted_exp_softsum_fwd": 0,
            "weighted_exp_softsum_bwd": 0}


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


def compact_live_rows_plain(w: torch.Tensor):
    """The compaction's plain version: ``(idx [N] int32, wv [N] f32,
    n_live [1] int32)`` with the L nonzero rows of ``w`` in ascending order
    in ``idx[:L]`` and their weights in ``wv[:L]``; the tails are zero."""
    live = torch.nonzero(w).flatten()
    n = live.numel()
    idx = torch.zeros(w.shape, dtype=torch.int32, device=w.device)
    wv = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    idx[:n] = live.to(torch.int32)
    wv[:n] = w[live]
    return idx, wv, torch.tensor([n], dtype=torch.int32, device=w.device)


def _live(r, idx, wv, n_live):
    n = int(n_live[0])
    return r[idx[:n].long()].float(), wv[:n]


def softsum_live_plain(a, r, idx, wv, n_live, inv_temp: float) -> torch.Tensor:
    """K1 over the compacted rows: s [Q] = sum_l wv[l] exp(inv_temp <a, r[idx[l]]>)."""
    rows, wl = _live(r, idx, wv, n_live)
    logits = (a.float() @ rows.T) * inv_temp
    return torch.sum(torch.exp(logits) * wl[None, :], dim=1)


def softsum_moment_live_plain(a, r, idx, wv, n_live, inv_temp: float) -> torch.Tensor:
    """K2 over the compacted rows: M [Q, D], ``e`` rounded to bf16 first."""
    rows, wl = _live(r, idx, wv, n_live)
    logits = (a.float() @ rows.T) * inv_temp
    e = (torch.exp(logits) * wl[None, :]).to(torch.bfloat16)
    return e.float() @ rows


# --------------------------------------------------------------- kernels ---

def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if not getattr(lib, "_css_bound", False):
        lib.css_compact_live_rows.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + \
            [ctypes.c_void_p] * 5
        lib.css_compact_live_rows.restype = ctypes.c_int
        for fn in (lib.css_weighted_exp_softsum_fwd, lib.css_weighted_exp_softsum_bwd):
            fn.argtypes = [ctypes.c_void_p] * 7 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._css_bound = True
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rc(fn_name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def compact_live_rows_kernel(w: torch.Tensor):
    """The compaction on the card: ``(idx, wv, n_live)`` as in
    :func:`compact_live_rows_plain`, with undefined tails; the count stays on
    the device."""
    if not w.is_cuda:
        raise ValueError(f"compact_live_rows kernel: w must lie on a CUDA device, "
                         f"not {w.device}")
    if w.dtype != torch.float32 or w.ndim != 1:
        raise TypeError(f"compact_live_rows kernel: need 1-D f32 weights; "
                        f"got {w.dtype} {tuple(w.shape)}")
    n = w.shape[0]
    if n >= 2**31:
        raise ValueError(f"compact_live_rows kernel: N={n} exceeds int32 indices")
    if not w.is_contiguous() or w.data_ptr() % 16:
        w = w.clone()
    n_pad = -(-max(n, 1) // TILE_N) * TILE_N
    blocks = max(-(-n // COMPACT_BLOCK), 1)
    # one allocation: idx [n_pad] | wv [n_pad] | n_live, 3 spare | counts [blocks]
    buf = torch.empty(2 * n_pad + 4 + blocks, dtype=torch.int32, device=w.device)
    idx, wv = buf[:n_pad], buf[n_pad:2 * n_pad].view(torch.float32)
    n_live, counts = buf[2 * n_pad:2 * n_pad + 1], buf[2 * n_pad + 4:]
    rc = _library().css_compact_live_rows(w.data_ptr(), n, counts.data_ptr(),
                                          idx.data_ptr(), wv.data_ptr(),
                                          n_live.data_ptr(), _stream(w))
    _check_rc("css_compact_live_rows", rc)
    LAUNCHES["live_rows_compact"] += 1
    return idx[:n], wv[:n], n_live


def _check_cuda_operands(a, r, idx, wv, n_live):
    dev = a.device
    if any(t.device != dev for t in (r, idx, wv, n_live)):
        raise ValueError(f"weighted_exp_softsum: a, r, w must share one device; "
                         f"got {a.device}, {r.device}, {wv.device}")
    if a.dtype != torch.bfloat16 or r.dtype != torch.bfloat16:
        raise TypeError(f"weighted_exp_softsum kernel: need bf16 a/r; "
                        f"got {a.dtype}, {r.dtype}")
    if (idx.dtype, wv.dtype, n_live.dtype) != (torch.int32, torch.float32, torch.int32):
        raise TypeError("weighted_exp_softsum kernel: need int32 idx/n_live and f32 wv")
    if not (r.is_contiguous() and idx.is_contiguous() and wv.is_contiguous()):
        raise ValueError("weighted_exp_softsum kernel: r, idx and wv must be contiguous")
    if r.data_ptr() % 16 or wv.data_ptr() % 16:
        raise ValueError("weighted_exp_softsum kernel: r and wv must be 16-byte aligned")
    if a.shape[1] > _D_PAD[-1]:
        raise ValueError(f"weighted_exp_softsum kernel: D={a.shape[1]} exceeds "
                         f"{_D_PAD[-1]}")


def _prepare(a, r, idx, wv, n_live):
    """Pads a to [q_pad, d_pad] and r to d_pad (exact: zero rows/columns add
    nothing) and sizes the grid: about one wave of anchor blocks x chunks."""
    _check_cuda_operands(a, r, idx, wv, n_live)
    q, d = a.shape
    d_pad = next(p for p in _D_PAD if p >= d)
    q_pad = -(-max(q, 1) // BLOCK_Q) * BLOCK_Q
    if (q_pad, d_pad) == (q, d) and a.is_contiguous():
        a_p = a
    else:
        a_p = torch.zeros((q_pad, d_pad), dtype=torch.bfloat16, device=a.device)
        a_p[:q, :d] = a
    if d_pad != d:
        r = torch.nn.functional.pad(r, (0, d_pad - d))
    chunks = max(_sm_count(a.device.index) // -(-q_pad // CTA_ANCHORS), 1)
    return a_p, r, q_pad, d_pad, chunks


def _launch(fn_name, a, r, idx, wv, n_live, inv_temp, moment):
    a_p, r_p, q_pad, d_pad, chunks = _prepare(a, r, idx, wv, n_live)
    width = (d_pad,) if moment else ()
    partial = torch.empty((chunks, q_pad) + width, dtype=torch.float32, device=a.device)
    out = torch.empty((q_pad,) + width, dtype=torch.float32, device=a.device)
    rc = getattr(_library(), fn_name)(
        a_p.data_ptr(), r_p.data_ptr(), idx.data_ptr(), wv.data_ptr(),
        n_live.data_ptr(), partial.data_ptr(), out.data_ptr(), q_pad, d_pad,
        chunks, float(inv_temp), _stream(a))
    _check_rc(fn_name, rc)
    return out


def softsum_live_kernel(a, r, idx, wv, n_live, inv_temp: float) -> torch.Tensor:
    """K1 on the card over a compaction: s [Q] f32."""
    out = _launch("css_weighted_exp_softsum_fwd", a, r, idx, wv, n_live, inv_temp, False)
    LAUNCHES["weighted_exp_softsum_fwd"] += 1
    return out[:a.shape[0]]


def softsum_moment_live_kernel(a, r, idx, wv, n_live, inv_temp: float) -> torch.Tensor:
    """K2 on the card over a compaction: M [Q, D] f32."""
    out = _launch("css_weighted_exp_softsum_bwd", a, r, idx, wv, n_live, inv_temp, True)
    LAUNCHES["weighted_exp_softsum_bwd"] += 1
    return out[:a.shape[0], :a.shape[1]]


def softsum_kernel(a: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                   inv_temp: float) -> torch.Tensor:
    """Compaction and K1 on the card: s [Q] f32."""
    return softsum_live_kernel(a, r, *compact_live_rows_kernel(w), inv_temp)


def softsum_moment_kernel(a: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                          inv_temp: float) -> torch.Tensor:
    """Compaction and K2 on the card: M [Q, D] f32."""
    return softsum_moment_live_kernel(a, r, *compact_live_rows_kernel(w), inv_temp)


def compact_live_rows(w):
    if w.is_cuda:
        return compact_live_rows_kernel(w)
    return compact_live_rows_plain(w)


def _softsum_live(a, r, idx, wv, n_live, inv_temp):
    if a.is_cuda:
        return softsum_live_kernel(a, r, idx, wv, n_live, inv_temp)
    return softsum_live_plain(a, r, idx, wv, n_live, inv_temp)


def _softsum_moment_live(a, r, idx, wv, n_live, inv_temp):
    if a.is_cuda:
        return softsum_moment_live_kernel(a, r, idx, wv, n_live, inv_temp)
    return softsum_moment_live_plain(a, r, idx, wv, n_live, inv_temp)


class WeightedExpSoftsum(torch.autograd.Function):
    """s = K1(a, r, w); the gradient for ``a`` is (g * inv_temp)[:, None] * K2.

    Forward compacts the live rows of ``w`` once and saves the bf16 anchors,
    the table and the compaction, so backward runs K2 on them and neither
    re-runs K1 nor compacts again.  ``r`` and ``w`` get no gradient, as in
    the TPU custom_vjp.
    """

    @staticmethod
    def forward(ctx, a, r, w, inv_temp):
        a_b = a.to(torch.bfloat16)
        idx, wv, n_live = compact_live_rows(w)
        ctx.save_for_backward(a_b, r, idx, wv, n_live)
        ctx.inv_temp = float(inv_temp)
        ctx.a_dtype = a.dtype
        return _softsum_live(a_b, r, idx, wv, n_live, ctx.inv_temp)

    @staticmethod
    def backward(ctx, g):
        a_b, r, idx, wv, n_live = ctx.saved_tensors
        m = _softsum_moment_live(a_b, r, idx, wv, n_live, ctx.inv_temp)
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
