"""Train-mode BatchNorm fused with what follows it: the CUDA kernels of
``css_tpu_torch/csrc/batchnorm_kernels.cu``, their plain versions, and the
autograd glue.

    y  = act((x - mean[g]) * w * rstd[g] + b [+ res])      act: ReLU or none
    dx = w * rstd[g] * (gy - sum(gy) / n - xhat * sum(gy * xhat) / n)
    gy = dy * [y > 0] where a ReLU follows, else dy;  dres = gy

``x`` [N, C, H, W] is a conv's output, read as the [M, C] rows of a
channels-last tensor; the batch splits into ``groups`` equal groups with
statistics of their own (f32 sums of x and x^2, var = E[x^2] - mean^2), and
the running stats move once a group, group 0 first, with the unbiased
variance, unless :class:`Finish` says not to (remat's recompute).
``distributed`` sums the statistics' sums over the ranks
(``parallel.mesh.all_reduce_sum``) between the statistics and the output, and
the gradient's sums between the backward's two passes; the caller's ``n``
then counts every rank's rows.

:func:`batch_norm_train` is what ``GroupedBatchNorm`` calls in train mode on
a CUDA tensor, with a :class:`Finish` it builds: the kernels run, or it
raises.  A forward is two launches (statistics, output), three under
``distributed`` (the statistics finish after the all-reduce); a backward is
two.  The plain functions (``*_plain``) compute the kernels' arithmetic in
PyTorch: f32 throughout, y and dx rounded once to the input's type.  The
autograd function takes them for CPU tensors, which only the tests hand it:
``GroupedBatchNorm`` keeps its own code on the CPU.  ``LAUNCHES`` counts
kernel launches.  Each launch runs with its tensors' device current.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import types
from typing import Optional

import torch

from css_tpu_torch.ops.kernels._build import load_library
from css_tpu_torch.ops.kernels.contrastive_kernels import _check_rc, _sm_count, _stream
from css_tpu_torch.parallel.mesh import all_reduce_sum

__all__ = ["batch_norm_train", "FusedBatchNorm", "stats_plain", "finish_plain", "apply_plain",
           "grad_stats_plain", "grad_apply_plain", "stats_kernel", "finish_kernel",
           "apply_kernel", "grad_stats_kernel", "grad_apply_kernel", "Finish", "grid",
           "row_stride", "LAUNCHES", "reset_launches", "SOURCE"]

SOURCE = "batchnorm_kernels.cu"
THREADS_X = 8            # threads across a channel tile (kTx in the source)
BLOCKS_PER_SM = 4        # blocks the grid aims at, per SM
MAX_CHUNKS = 256         # row chunks a group at most: the partials the last block adds
MIN_CHUNK_ROWS = 128     # rows a chunk at least
MAX_TILES = 4096         # channel tiles (ticket counters) a launch at most
_VEC = {torch.bfloat16: 8, torch.float32: 4}   # channels a 16-byte access holds

LAUNCHES = {"css_bn_stats": 0, "css_bn_finish": 0, "css_bn_apply": 0, "css_bn_grad_stats": 0,
            "css_bn_grad_apply": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class Finish:
    """What turns a group's sums into statistics and moves the running stats:
    ``n`` rows a group (every rank's), ``bessel`` n / (n - 1), ``keep`` 1 -
    ``momentum``, both rounded to f32 where they meet the f32 stats."""
    n: int
    eps: float
    momentum: float
    update: bool
    running_mean: torch.Tensor
    running_var: torch.Tensor

    @property
    def keep(self) -> float:
        return 1 - self.momentum

    @property
    def bessel(self) -> float:
        return self.n / max(self.n - 1.0, 1.0)


# ---------------------------------------------------------------- plain ----

def _rows(t: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [M, C] rows (a view of a channels-last tensor)."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def _like(rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[M, C] rows -> x's shape, channels-last."""
    n, c, h, w = x.shape
    return rows.reshape(n, h, w, c).permute(0, 3, 1, 2)


def _grouped(t: torch.Tensor, groups: int) -> torch.Tensor:
    return _rows(t).float().reshape(groups, -1, t.shape[1])


def _gy(dy: torch.Tensor, y: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 rows of dy, zero where the saved output (a ReLU's) is not positive."""
    g = _rows(dy).float()
    return g if y is None else torch.where(_rows(y) > 0, g, 0.0)


def finish_plain(sums: torch.Tensor, fin: Finish) -> torch.Tensor:
    """[2, G, C] sums of x and x^2 -> [2, G, C] (mean, rstd); moves the
    running stats in place when ``fin.update``."""
    mean = sums[0] / fin.n
    var = sums[1] / fin.n - mean * mean
    if fin.update:
        run_mean, run_var = fin.running_mean, fin.running_var
        for g in range(sums.shape[1]):
            run_mean = fin.momentum * run_mean + fin.keep * mean[g]
            run_var = fin.momentum * run_var + fin.keep * var[g] * fin.bessel
        fin.running_mean.copy_(run_mean)
        fin.running_var.copy_(run_var)
    return torch.stack([mean, torch.rsqrt(var + fin.eps)])


def stats_plain(x: torch.Tensor, groups: int, fin: Optional[Finish] = None):
    """css_bn_stats: ``(sums [2, G, C], stat)`` with the f32 sums of x and
    x^2 a group; ``stat`` as :func:`finish_plain` gives it, or None without
    ``fin``."""
    xf = _grouped(x, groups)
    sums = torch.stack([xf.sum(1), (xf * xf).sum(1)])
    return sums, None if fin is None else finish_plain(sums, fin)


def apply_plain(x, stat, weight, bias, groups: int, residual=None, relu: bool = False):
    """css_bn_apply: y in x's type and shape (channels-last)."""
    y = (_grouped(x, groups) - stat[0][:, None]) * (weight * stat[1])[:, None] + bias
    y = y.reshape(-1, x.shape[1])
    if residual is not None:
        y = y + _rows(residual).float()
    if relu:
        y = torch.relu(y)
    return _like(y.to(x.dtype), x)


def grad_stats_plain(x, dy, y, stat, groups: int):
    """css_bn_grad_stats: ``(sums [2, G, C], dw, db)``: the sums of gy and
    gy * xhat a group, and dw, db added over the groups.  ``y`` is the
    forward's output where a ReLU followed, else None."""
    g = _gy(dy, y).reshape(groups, -1, x.shape[1])
    xc = _grouped(x, groups) - stat[0][:, None]
    sums = torch.stack([g.sum(1), (g * xc).sum(1) * stat[1]])
    return sums, sums[1].sum(0), sums[0].sum(0)


def grad_apply_plain(x, dy, y, stat, weight, sums, n: int, groups: int, want_dres: bool):
    """css_bn_grad_apply: ``(dx, dres or None)`` in x's type and shape."""
    c = x.shape[1]
    g = _gy(dy, y)
    k = stat[1] * (sums[1] / n)
    dx = (weight * stat[1])[:, None] * (g.reshape(groups, -1, c) - (sums[0] / n)[:, None]
                                        - (_grouped(x, groups) - stat[0][:, None]) * k[:, None])
    dx = _like(dx.reshape(-1, c).to(x.dtype), x)
    return dx, _like(g.to(x.dtype), x) if want_dres else None


# --------------------------------------------------------------- kernels ---

class _Args(ctypes.Structure):
    """``BnArgs`` of the source, field for field."""
    _fields_ = [("x", ctypes.c_void_p), ("ldx", ctypes.c_longlong),
                ("res", ctypes.c_void_p), ("ldr", ctypes.c_longlong),
                ("dy", ctypes.c_void_p), ("ldd", ctypes.c_longlong),
                ("y", ctypes.c_void_p), ("out", ctypes.c_void_p), ("dres", ctypes.c_void_p),
                ("weight", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                ("running_mean", ctypes.c_void_p), ("running_var", ctypes.c_void_p),
                ("partial", ctypes.c_void_p), ("sums", ctypes.c_void_p),
                ("stat", ctypes.c_void_p), ("dweight", ctypes.c_void_p),
                ("dbias", ctypes.c_void_p), ("tickets", ctypes.c_void_p),
                ("rows_per_group", ctypes.c_longlong), ("rows_per_chunk", ctypes.c_longlong),
                ("C", ctypes.c_int), ("groups", ctypes.c_int), ("chunks", ctypes.c_int),
                ("relu", ctypes.c_int), ("finish", ctypes.c_int), ("update", ctypes.c_int),
                ("n", ctypes.c_float), ("eps", ctypes.c_float), ("momentum", ctypes.c_float),
                ("keep", ctypes.c_float), ("bessel", ctypes.c_float)]


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if not getattr(lib, "_css_bound", False):
        for name in ("css_bn_stats", "css_bn_apply", "css_bn_grad_stats", "css_bn_grad_apply"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.css_bn_finish.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.css_bn_finish.restype = ctypes.c_int
        lib._css_bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _tickets(device_index: int) -> torch.Tensor:
    """The statistics kernels' ticket counters on one device: zero, and left
    zero by each launch (the last block of a tile resets its own)."""
    return torch.zeros(MAX_TILES, dtype=torch.int32, device=torch.device("cuda", device_index))


def row_stride(t: torch.Tensor) -> Optional[int]:
    """The stride between the rows of ``t`` [N, C, H, W] read as [M, C]
    channels-last rows (C, or more for a channel slice of a wider tensor), or
    None where its layout is not that."""
    n, c, h, w = t.shape
    s_n, s_c, s_h, s_w = t.stride()
    if c > 1 and s_c != 1:
        return None
    ld = s_w if w > 1 else s_h if h > 1 else s_n if n > 1 else c
    if ld < c or (h > 1 and s_h != w * ld) or (n > 1 and s_n != h * w * ld):
        return None
    return ld


def grid(rows_per_group: int, groups: int, tiles: int, sms: int):
    """``(chunks, rows_per_chunk)``: row chunks a group, so that tiles x
    groups x chunks is about ``BLOCKS_PER_SM`` blocks an SM, each chunk at
    least ``MIN_CHUNK_ROWS`` rows (or all of them), at most ``MAX_CHUNKS``,
    none empty."""
    want = -(-BLOCKS_PER_SM * sms // (tiles * groups))
    chunks = max(1, min(want, rows_per_group // MIN_CHUNK_ROWS, MAX_CHUNKS))
    rows = max(1, -(-rows_per_group // chunks))
    return max(1, -(-rows_per_group // rows)), rows


def _prepare(x: torch.Tensor, groups: int, *operands):
    """``(vec, args)``: the launch's shape fields filled in."""
    c, v = x.shape[1], _VEC[x.dtype]
    vec = c % v == 0 and all(ld % v == 0 and t.data_ptr() % 16 == 0 for t, ld in operands)
    tiles = -(-c // (THREADS_X * (v if vec else 1)))
    if tiles > MAX_TILES:
        raise ValueError(f"batch_norm kernels: C={c} needs {tiles} channel tiles, over "
                         f"{MAX_TILES}")
    rows_per_group = x.numel() // c // groups
    chunks, rows_per_chunk = grid(rows_per_group, groups, tiles, _sm_count(x.device.index))
    args = _Args(C=c, groups=groups, chunks=chunks, rows_per_group=rows_per_group,
                 rows_per_chunk=rows_per_chunk, tickets=_tickets(x.device.index).data_ptr())
    return vec, args


def _launch(name: str, args: _Args, x: torch.Tensor, vec: bool) -> None:
    with torch.cuda.device(x.device):
        rc = getattr(_library(), name)(ctypes.byref(args), int(x.dtype == torch.bfloat16),
                                       int(vec), _stream(x))
    _check_rc(name, rc)
    LAUNCHES[name] += 1


def _sums(x: torch.Tensor, args: _Args) -> torch.Tensor:
    """The statistics kernels' sums [2, G, C] and their per-block partials,
    in one allocation, set in ``args``."""
    c, rows = args.C, args.groups * args.chunks
    buf = torch.empty((rows + args.groups) * 2 * c, dtype=torch.float32, device=x.device)
    sums = buf[rows * 2 * c:].view(2, args.groups, c)
    args.partial, args.sums = buf.data_ptr(), sums.data_ptr()
    return sums


def _set_finish(args: _Args, fin: Finish, stat: torch.Tensor) -> None:
    args.stat = stat.data_ptr()
    args.running_mean = fin.running_mean.data_ptr()
    args.running_var = fin.running_var.data_ptr()
    args.update = int(fin.update)
    args.n, args.eps, args.momentum = fin.n, fin.eps, fin.momentum
    args.keep, args.bessel = fin.keep, fin.bessel


def stats_kernel(x: torch.Tensor, groups: int, fin: Optional[Finish] = None):
    """:func:`stats_plain` on the card: one launch of css_bn_stats."""
    ldx = row_stride(x)
    vec, args = _prepare(x, groups, (x, ldx))
    sums = _sums(x, args)
    stat = None
    args.x, args.ldx = x.data_ptr(), ldx
    if fin is not None:
        stat = torch.empty((2, groups, x.shape[1]), dtype=torch.float32, device=x.device)
        args.finish = 1
        _set_finish(args, fin, stat)
    _launch("css_bn_stats", args, x, vec)
    return sums, stat


def finish_kernel(sums: torch.Tensor, fin: Finish) -> torch.Tensor:
    """:func:`finish_plain` on the card: one launch of css_bn_finish."""
    groups, c = sums.shape[1:]
    stat = torch.empty((2, groups, c), dtype=torch.float32, device=sums.device)
    args = _Args(C=c, groups=groups, chunks=1, rows_per_chunk=1, sums=sums.data_ptr())
    _set_finish(args, fin, stat)
    with torch.cuda.device(sums.device):
        rc = _library().css_bn_finish(ctypes.byref(args), _stream(sums))
    _check_rc("css_bn_finish", rc)
    LAUNCHES["css_bn_finish"] += 1
    return stat


def apply_kernel(x, stat, weight, bias, groups: int, residual=None, relu: bool = False):
    """:func:`apply_plain` on the card: one launch of css_bn_apply."""
    y = torch.empty_like(x, memory_format=torch.channels_last)
    ldx = row_stride(x)
    operands = [(x, ldx), (y, x.shape[1])]
    if residual is not None:
        ldr = row_stride(residual)
        operands.append((residual, ldr))
    vec, args = _prepare(x, groups, *operands)
    args.x, args.ldx, args.out = x.data_ptr(), ldx, y.data_ptr()
    if residual is not None:
        args.res, args.ldr = residual.data_ptr(), ldr
    args.stat, args.weight, args.bias = stat.data_ptr(), weight.data_ptr(), bias.data_ptr()
    args.relu = int(relu)
    _launch("css_bn_apply", args, x, vec)
    return y


def _backward_args(x, dy, y, stat, groups: int, *outputs):
    ldx, ldd, c = row_stride(x), row_stride(dy), x.shape[1]
    operands = [(x, ldx), (dy, ldd)] + [(t, c) for t in (y, *outputs) if t is not None]
    vec, args = _prepare(x, groups, *operands)
    args.x, args.ldx, args.dy, args.ldd = x.data_ptr(), ldx, dy.data_ptr(), ldd
    args.stat = stat.data_ptr()
    if y is not None:
        args.y, args.relu = y.data_ptr(), 1
    return vec, args


def grad_stats_kernel(x, dy, y, stat, groups: int):
    """:func:`grad_stats_plain` on the card: one launch of css_bn_grad_stats.
    ``dy`` in rows (:func:`row_stride` not None)."""
    vec, args = _backward_args(x, dy, y, stat, groups)
    sums = _sums(x, args)
    dwb = torch.empty((2, x.shape[1]), dtype=torch.float32, device=x.device)
    args.dweight, args.dbias = dwb[0].data_ptr(), dwb[1].data_ptr()
    _launch("css_bn_grad_stats", args, x, vec)
    return sums, dwb[0], dwb[1]


def grad_apply_kernel(x, dy, y, stat, weight, sums, n: int, groups: int, want_dres: bool):
    """:func:`grad_apply_plain` on the card: one launch of css_bn_grad_apply."""
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dres = torch.empty_like(x, memory_format=torch.channels_last) if want_dres else None
    vec, args = _backward_args(x, dy, y, stat, groups, dx, dres)
    args.out, args.weight, args.sums, args.n = dx.data_ptr(), weight.data_ptr(), sums.data_ptr(), n
    if dres is not None:
        args.dres = dres.data_ptr()
    _launch("css_bn_grad_apply", args, x, vec)
    return dx, dres


_PLAIN = types.SimpleNamespace(stats=stats_plain, finish=finish_plain, apply=apply_plain,
                               grad_stats=grad_stats_plain, grad_apply=grad_apply_plain)
_KERNELS = types.SimpleNamespace(stats=stats_kernel, finish=finish_kernel, apply=apply_kernel,
                                 grad_stats=grad_stats_kernel, grad_apply=grad_apply_kernel)


def _ops(t: torch.Tensor):
    return _KERNELS if t.is_cuda else _PLAIN


class FusedBatchNorm(torch.autograd.Function):
    """y = act(BN(x) [+ residual]) with ``weight`` and ``bias``, statistics
    of its own (``groups`` of them) and the running stats of ``fin``; the
    gradients for x, the residual, the weight and the bias.

    Saves x, the (mean, rstd) of each group and, where a ReLU follows, y:
    the next conv keeps y as its input all the same.  Under ``distributed``
    the forward's sums and the backward's go through one all-reduce each;
    dw and db stay this rank's, as the step averages the gradients itself.
    """

    @staticmethod
    def forward(ctx, x, residual, weight, bias, fin: Finish, groups: int, relu: bool,
                distributed: bool):
        ops = _ops(x)
        if distributed:
            sums, _ = ops.stats(x, groups)
            stat = ops.finish(all_reduce_sum(sums), fin)
        else:
            _, stat = ops.stats(x, groups, fin)
        y = ops.apply(x, stat, weight, bias, groups, residual, relu)
        ctx.save_for_backward(x, y if relu else None, stat, weight)
        ctx.groups, ctx.n, ctx.distributed = groups, fin.n, distributed
        ctx.has_residual = residual is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, stat, weight = ctx.saved_tensors
        ops = _ops(x)
        if dy.is_cuda and row_stride(dy) is None:
            dy = dy.contiguous(memory_format=torch.channels_last)
        sums, dw, db = ops.grad_stats(x, dy, y, stat, ctx.groups)
        if ctx.distributed:
            sums = all_reduce_sum(sums)
        dx, dres = ops.grad_apply(x, dy, y, stat, weight, sums, ctx.n, ctx.groups,
                                  ctx.has_residual)
        return dx, dres, dw, db, None, None, None, None


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, fin: Finish,
                     groups: int = 1, residual: Optional[torch.Tensor] = None,
                     relu: bool = False, distributed: bool = False) -> torch.Tensor:
    """Train-mode BN of ``x`` [N, C, H, W] in ``groups`` groups, then ``+
    residual`` and a ReLU where given: :class:`FusedBatchNorm`.  On a CUDA
    tensor x and the residual must be bf16 or f32 channels-last rows
    (:func:`row_stride`), and the weight, bias and ``fin``'s running stats
    f32 on x's device; what the kernels do not take raises."""
    c = weight.shape[0]
    if x.ndim != 4 or x.shape[1] != c:
        raise ValueError(f"batch_norm_train: need x [N, {c}, H, W]; got {tuple(x.shape)}")
    if x.shape[0] % groups:
        raise ValueError(f"GroupedBatchNorm: batch {x.shape[0]} does not split into {groups} "
                         f"groups")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError(f"batch_norm_train: the residual must match x; got "
                         f"{residual.dtype} {tuple(residual.shape)} on {residual.device}, x "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if x.is_cuda:
        if x.dtype not in _VEC:
            raise TypeError(f"batch_norm kernels: need bf16 or f32 x; got {x.dtype}")
        if row_stride(x) is None or (residual is not None and row_stride(residual) is None):
            raise ValueError("batch_norm kernels: x and the residual must be channels-last; got "
                             f"strides {x.stride()}"
                             + ("" if residual is None else f" and {residual.stride()}"))
        vectors = (weight, bias, fin.running_mean, fin.running_var)
        if any(t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
               for t in vectors):
            raise TypeError("batch_norm kernels: weight, bias and the running stats must be "
                            "contiguous f32 on x's device")
    return FusedBatchNorm.apply(x, residual, weight, bias, fin, groups, relu, distributed)
