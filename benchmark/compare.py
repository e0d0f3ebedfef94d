"""The numbers that decide ``correct``, each against its limit.

The program's first three training steps, which set-up drives through the
window's own call and feed, against the reference's three steps from the
same weights, records and draws.  By leaf, a gap is
| |prog| - |ref| | / max(|ref|, the median leaf's |ref|).

* ``bn_mean_gap``: the median over the teacher's BatchNorms of the relative
  error of the batch means of its one train-mode forward in step 1 (its
  running means then, 0.1 times those means): a function of the forward
  alone, at weights both sides share;
* ``change_median``: the median leaf's gap of the change of the student's
  and the teacher's parameters and of the prototypes after the three steps
  (leaves whose reference gradient is under a thousandth of the median
  leaf's are left out: they move by rounding alone);
* ``contrast_gap``: the relative gap of step 1's contrastive term, the
  loss whose negatives the live-row and K1 kernels sum;
* ``rep_grad_gap``: the worst gap of the representation head's leaves'
  first gradient (the contrastive loss alone trains that head; its anchors'
  gradient runs through K2);
* ``proto_end_median``: the median class's relative gap of the prototypes
  after the three steps, as the state hands them on (their moving average);
* printed beside them: ``loss_gap`` (the largest of the three steps'
  relative loss gaps), ``sup_gap`` (step 1's supervised term),
  ``proto_gap`` (step 1's prototypes, worst class), ``bn_var_gap`` and
  ``bn_var_worst`` (as ``bn_mean_gap``, of the batch variances),
  ``grad_gap`` / ``grad_median`` (the first gradient as the optimizer got
  it, worked out from the momentum after step 1: buf - weight_decay * w0;
  worst and median leaf), ``change_gap`` (worst leaf) and ``stats_gap`` /
  ``stats_median`` (the change of the BatchNorm running statistics),
  ``rep_grad_median`` (the representation head's median leaf),
  ``proto_median`` (step 1's prototypes, median class) and
  ``proto_end_gap`` (the prototypes after the three steps, all classes as
  one matrix).

Which numbers are compared, and their limits, is the cell's limits file
(``limits/<cell>.json``); a limit that is null means the number is printed
and not compared.  ``PERF.md`` gives the readings each limit was set from.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

import torch

__all__ = ["leaf_gaps", "train_leaves", "train_numbers", "judge", "REP_HEAD"]

REP_HEAD = "representation."     # the representation head's leaves, by name


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """| |prog[k]| - |ref[k]| | / max(|ref[k]|, the median leaf's |ref|) of
    each leaf k."""
    names = sorted(ref) if names is None else list(names)
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in names}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    med = statistics.median(rn.values())
    out = {}
    for k in names:
        gap = abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def train_leaves(prog: dict, ref: dict, weight_decay: float) -> Dict[str, Dict[str, float]]:
    """Every leaf's gap of the three leaf measures (see ``train_numbers``)."""
    w0 = ref["w0"]
    g_prog = {k: prog["momentum"][k] - weight_decay * w0[k] for k in w0}
    g_ref = ref["grads"]
    med = statistics.median(float(torch.linalg.vector_norm(g.double())) for g in g_ref.values())
    moved = [k for k, g in g_ref.items()
             if float(torch.linalg.vector_norm(g.double())) >= 1e-3 * med]

    def change(side):
        out = {f"student.{k}": side["student"][k] - w0[k] for k in moved}
        out.update({f"teacher.{k}": side["teacher"][k] - w0[k] for k in moved})
        out["prototypes"] = side["prototypes"]
        return out

    def stats(side):
        return {k: side["buffers"][k] - ref["b0"][k] for k in ref["b0"]}

    return {"grad_gap": leaf_gaps(g_prog, g_ref),
            "change_gap": leaf_gaps(change(prog), change(ref)),
            "stats_gap": leaf_gaps(stats(prog), stats(ref))}


def train_numbers(prog: dict, ref: dict, weight_decay: float) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` [3], ``w0`` and ``b0`` (the initial
    parameters and buffers), ``grads`` (the reference's first gradient) or
    ``momentum`` (the program's buffers after step 1), ``student``,
    ``teacher``, ``buffers`` and ``prototypes`` after step 3; CPU tensors."""
    def rel(a, b):
        gap = abs(a - b) / max(abs(b), 1e-30)
        return gap if math.isfinite(gap) else math.inf

    out = {"loss_gap": max(rel(a, b) for a, b in zip(prog["losses"], ref["losses"])),
           "sup_gap": rel(prog["first"]["sup"], ref["first"]["sup"]),
           "contrast_gap": rel(prog["first"]["contrast"], ref["first"]["contrast"])}
    pp, rp = prog["first"]["prototypes"].double(), ref["first"]["prototypes"].double()
    rows = torch.linalg.vector_norm(rp, dim=1) > 0
    proto = (torch.linalg.vector_norm(pp - rp, dim=1)[rows]
             / torch.linalg.vector_norm(rp, dim=1)[rows])
    out["proto_gap"] = float(proto.max()) if bool(rows.any()) else 0.0
    out["proto_median"] = float(proto.median()) if bool(rows.any()) else 0.0
    pe, re_ = prog["prototypes"].double(), ref["prototypes"].double()
    out["proto_end_gap"] = _finite(float(torch.linalg.vector_norm(pe - re_))
                                   / max(float(torch.linalg.vector_norm(re_)), 1e-30))
    rows = torch.linalg.vector_norm(re_, dim=1) > 0
    end = (torch.linalg.vector_norm(pe - re_, dim=1)[rows]
           / torch.linalg.vector_norm(re_, dim=1)[rows])
    out["proto_end_median"] = _finite(float(end.median())) if bool(rows.any()) else 0.0
    # the teacher's one train-mode forward of step 1 (its initial weights):
    # each BatchNorm's batch variance (running_var - 0.9) and mean
    tb_p, tb_r = prog["first"]["teacher_buffers"], ref["first"]["teacher_buffers"]
    var = [float(torch.linalg.vector_norm((tb_p[k] - tb_r[k]).double())
                 / torch.linalg.vector_norm((tb_r[k] - 0.9).double()))
           for k in tb_r if k.endswith("running_var")]
    mean = [float(torch.linalg.vector_norm((tb_p[k] - tb_r[k]).double())
                  / max(float(torch.linalg.vector_norm(tb_r[k].double())), 1e-30))
            for k in tb_r if k.endswith("running_mean")]
    out["bn_var_gap"], out["bn_var_worst"] = statistics.median(var), max(var)
    out["bn_mean_gap"] = statistics.median(mean)
    leaves = train_leaves(prog, ref, weight_decay)
    for k, v in leaves.items():
        out[k] = max(v.values())
        out[k.replace("_gap", "_median")] = statistics.median(v.values())
    rep = [g for name, g in leaves["grad_gap"].items() if name.startswith(REP_HEAD)]
    out["rep_grad_gap"], out["rep_grad_median"] = max(rep), statistics.median(rep)
    return out


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def judge(numbers: Dict[str, float], limits: Dict[str, Optional[float]]):
    """(correct, failed, checks): each number beside its limit; a number
    whose limit is null is shown and not compared."""
    checks, failed = {}, 0
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is not None and not (value <= limit):
            failed += 1
    return failed == 0, failed, checks
