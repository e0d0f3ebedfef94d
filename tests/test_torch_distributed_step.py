"""The port's data-parallel step on 2 gloo ranks (one process each, on the
CPU) against css_tpu's step on a 2-device slice of the 8-virtual-device
mesh (``sharded_train_step``, ``shard_map`` over ``data``).

Both sides start from the same weights (through ``from_jax_variables``) and
see the same global batch, rank r (device r) taking rows [rB, (r + 1)B); the
port's per-rank draws are replayed from the JAX step's key chain, which
folds the step and then the device index into the key.  Compared: the mean
losses, the new parameters, the student's and the teacher's BN running
stats (whose Bessel n counts both replicas), the prototypes (summed over
ranks), and the two ranks bit for bit against each other.  Cases:

* (a) ``ori``, two passes, CutMix with partner ``reference`` (every rank
  mixes with rank 0's shard): a 2-step trajectory;
* (b) ``mix``, fused forward (grouped x cross-replica BN, the teacher fused
  too), partner ``ring`` (the last image's partner is the next rank's
  first), random prototypes: one step;
* (c) ``ori`` with the deep-stem ``tiny_stem`` trunk, remat (the backward
  recompute issues the BN all-reduces again), OHEM and the fused forward:
  one step.

Tolerances are those of ``tests/test_torch_train_step.py`` and
``tests/test_torch_strategies.py`` (calibrated there on JAX's own spread at
a per-device batch of 2, the same here): losses rtol 2e-3, parameters atol
5e-4 (``mix``: 5% of JAX's largest update), BN stats and prototypes atol
2e-3.  At the trajectory's second step the parameters are held to 2e-2, the
BN stats to 5e-2 and the losses to 2e-2: the unsupervised loss, taken over
the pixels the teacher is confident on, moves by 2.3e-3 there (measured;
JAX's own spread at a trajectory's step 1 reaches 5.3e-3,
``tests/test_torch_strategies.py``).  The sharded eval matrix,
the mixing partners and the grouped cross-replica BN alone are exact or at
f32 rounding (atol 1e-5 on unit-scale values, 1e-4 on the gradients).

A gloo group of one rank must give the non-distributed step's results bit
for bit: every collective is then the identity.
"""

import concurrent.futures
import copy
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import css_tpu.train.train_step as jax_train_step
from css_tpu.models import build_model as jax_build_model
from css_tpu.models.resnet import GroupedBatchNorm as JaxGroupedBatchNorm
from css_tpu.ops import mixing as jmix
from css_tpu.parallel import data_mesh, sharded_eval_step, sharded_train_step
from css_tpu.train.state import create_train_state as jax_create_state
from css_tpu.train.state import make_optimizer
from css_tpu_torch import parallel
from css_tpu_torch.models.convert import from_jax_variables
from css_tpu_torch.models.deeplabv3 import build_model, set_distributed
from css_tpu_torch.parallel import mesh
from css_tpu_torch.train.draws import sample_step_draws
from css_tpu_torch.train.state import create_train_state
from css_tpu_torch.train.train_step import StepConfig, make_eval_step, make_train_step
from tests import _torch_dist_worker as worker
from tests.test_torch_augment import _t, replay_mix
from tests.test_torch_cityscapes_step import CITY
from tests.test_torch_strategies import STEP1_LOSS_RTOL, replay_classmix
from tests.test_torch_train_step import (B, C, CFG, CROP, D, LIVE_UNSUP, LOSS_RTOL, OPT,
                                         PARAM_ATOL, STAT_ATOL, STEP1_PARAM_ATOL, STEP1_STAT_ATOL,
                                         _batch, replay_step_draws)

WORLD = 2
UPDATE_RTOL = 5e-2
EXACT_ATOL, GRAD_ATOL = 1e-5, 1e-4
TIMEOUT_S = 300.0

CASES = {
    "ori_reference": dict(cfg=dict(CFG, **LIVE_UNSUP, mix_partner="reference"),
                          backbone="tiny", remat=False, n_steps=2, protos=False),
    "mix_fused_ring": dict(cfg=dict(CFG, **LIVE_UNSUP, strategy="mix", fused_forward=True,
                                    mix_partner="ring"),
                           backbone="tiny", remat=False, n_steps=1, protos=True),
    "ori_deep_stem_ohem_remat": dict(cfg=dict(CITY), backbone="tiny_stem", remat=True,
                                     n_steps=1, protos=False),
}


@pytest.fixture(scope="module", autouse=True)
def _collective_timeout():
    """Spawned ranks give up on a collective after ``TIMEOUT_S``, so a hang
    fails instead of holding the suite."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(mesh, "DEFAULT_TIMEOUT_S", TIMEOUT_S)
        yield


def _rank_batch(seed, rank):
    return _batch(seed + 100 * rank)


def _global(batches):
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def _prototypes(case):
    if not case["protos"]:
        return np.zeros((C, D), np.float32)
    return np.random.default_rng(7).standard_normal((C, D)).astype(np.float32)


def _jax_state(backbone, remat, seed=0):
    """The JAX model (``axis_name="data"``), optimizer and initial state,
    replicated over the 2-device mesh (so that every step call sees the
    shardings its predecessor returned and compiles once)."""
    mesh = data_mesh(WORLD)
    jmodel = jax_build_model(num_classes=C, output_dim=D, backbone=backbone, remat=remat,
                             axis_name="data")
    tx = make_optimizer(**OPT)
    state = jax.jit(lambda k: jax_create_state(k, jmodel, tx, (1, CROP, CROP, 3), num_classes=C,
                                               output_dim=D))(jax.random.key(seed))
    return jmodel, tx, jax.device_put(state, NamedSharding(mesh, P()))


def _jax_case(case, key, init):
    """The port's inputs for ``case`` and a function that runs JAX's sharded
    step over them: per step the mean metrics, the student and teacher
    (as port state dicts), the prototypes and JAX's largest update."""
    mesh = data_mesh(WORLD)
    jmodel, tx, state = init
    protos = _prototypes(case)
    state = state.replace(prototypes=jax.device_put(protos, NamedSharding(mesh, P())))
    jcfg = jax_train_step.StepConfig(**case["cfg"])
    deep = case["backbone"] == "tiny_stem"
    batches = [[_rank_batch(50 + i, r) for r in range(WORLD)] for i in range(case["n_steps"])]
    port = dict(state_dict=from_jax_variables(state.params, state.batch_stats),
                prototypes=torch.from_numpy(protos.copy()), num_classes=C, output_dim=D,
                backbone=case["backbone"], remat=case["remat"], opt=OPT, cfg=case["cfg"],
                steps=[(batches[i], [replay_step_draws(key, i, jcfg, B, B, deep, rank=r)
                                     for r in range(WORLD)], (1.0, False))
                       for i in range(case["n_steps"])])

    def run(state=state):
        # the step donates its state: work on a copy of the shared initial one
        state = jax.device_put(jax.tree.map(lambda x: jnp.array(x, copy=True), state),
                               NamedSharding(mesh, P()))
        step = sharded_train_step(jax_train_step.make_train_step(jmodel, tx, jcfg, "data"), mesh)
        want = []
        for i in range(case["n_steps"]):
            before = [np.asarray(x) for x in jax.tree.leaves(state.params)]
            state, metrics = step(state, {k: jnp.asarray(v) for k, v in _global(batches[i]).items()},
                                  key, jnp.float32(1.0), jnp.asarray(False))
            update = max(float(np.abs(np.asarray(a) - b).max())
                         for a, b in zip(jax.tree.leaves(state.params), before))
            want.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                             step=int(state.step),
                             model=from_jax_variables(state.params, state.batch_stats),
                             teacher=from_jax_variables(state.ema_params, state.ema_batch_stats),
                             prototypes=np.asarray(state.prototypes), update=update))
        return want
    return port, run


def _eval_case(init):
    """6 images, 3 per rank, the last of each rank's rows padded."""
    model, _, state = init
    rng = np.random.default_rng(11)
    image = rng.standard_normal((6, CROP, CROP, 3)).astype(np.float32)
    label = rng.integers(-1, C, size=(6, CROP, CROP)).astype(np.int32)
    valid = np.array([True, True, False, True, True, False])
    zeros = jnp.zeros((C, C), jnp.int32)
    args = (jnp.asarray(image), jnp.asarray(label), jnp.asarray(valid))
    sharded = sharded_eval_step(jax_train_step.make_eval_step(model, C, "data"), data_mesh(WORLD))(
        state.ema_params, state.ema_batch_stats, zeros, *args)
    single = jax.jit(jax_train_step.make_eval_step(
        jax_build_model(num_classes=C, output_dim=D, backbone="tiny"), C))(
        state.ema_params, state.ema_batch_stats, zeros, *args)
    split = lambda x: [x[3 * r:3 * r + 3] for r in range(WORLD)]   # noqa: E731
    port = dict(state_dict=from_jax_variables(state.ema_params, state.ema_batch_stats),
                num_classes=C, output_dim=D, backbone="tiny", image=split(image),
                label=split(label), valid=split(valid))
    return port, dict(sharded=np.asarray(sharded), single=np.asarray(single),
                      inputs=(image, label, valid), state_dict=port["state_dict"])


def _mix_case():
    """Every partner mode on cutmix and classmix: JAX under shard_map with
    each device's key folded with its index."""
    b, hw, c = 3, (16, 20), 5
    rng = np.random.default_rng(3)
    images = rng.random((WORLD * b, 3, *hw), dtype=np.float32)
    labels = rng.integers(-1, c, size=(WORLD * b, 2, *hw)).astype(np.int32)
    confs = rng.random((WORLD * b, 2, *hw), dtype=np.float32)
    key = jax.random.key(17)
    mesh = data_mesh(WORLD)
    split = lambda x: [x[b * r:b * (r + 1)] for r in range(WORLD)]   # noqa: E731
    port = dict(images=split(images), labels=split(labels), confs=split(confs), modes={})
    want = {}
    for mode in ("cutmix", "classmix"):
        for partner in ("reference", "ring"):
            def mapped(img, lab, conf, mode=mode, partner=partner):
                k = jax.random.fold_in(key, jax.lax.axis_index("data"))
                return jmix.mix_batch(k, img, lab, conf, mode=mode, num_classes=c,
                                      axis_name="data", partner=partner)
            f = jax.jit(jax.shard_map(mapped, mesh=mesh, in_specs=(P("data"),) * 3,
                                      out_specs=(P("data"),) * 3, check_vma=False))
            want[f"{mode}_{partner}"] = [np.asarray(x) for x in f(images, labels, confs)]
            replay = (lambda k: replay_mix(k, b, hw)) if mode == "cutmix" else (
                lambda k: replay_classmix(k, b, c))
            port["modes"][f"{mode}_{partner}"] = (
                mode, partner, [replay(jax.random.fold_in(key, r)) for r in range(WORLD)])
    return port, want


def _bn_case():
    """Grouped (2 groups of 2 per device) cross-replica BN in train mode."""
    nb, h, w, ch, groups = 4, 5, 6, 3, 2
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((WORLD * nb, h, w, ch)) * 2 + 1).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    bn = JaxGroupedBatchNorm(axis_name="data")
    variables = bn.init(jax.random.key(0), jnp.asarray(x[:nb]), train=False)
    init = {"weight": rng.random(ch).astype(np.float32) + 0.5,
            "bias": rng.standard_normal(ch).astype(np.float32),
            "running_mean": rng.standard_normal(ch).astype(np.float32),
            "running_var": rng.random(ch).astype(np.float32) + 0.5}
    params = {"scale": jnp.asarray(init["weight"]), "bias": jnp.asarray(init["bias"])}
    stats = {"mean": jnp.asarray(init["running_mean"]), "var": jnp.asarray(init["running_var"])}
    assert set(variables["params"]) == set(params)

    def mapped(params, xs, cots):
        def loss(p, xx):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, xx, train=True,
                              groups=groups, mutable=["batch_stats"])
            return jnp.sum(y * cots), (y, upd["batch_stats"])
        (_, (y, new_stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                                           has_aux=True)(params, xs)
        return y, gx, jax.lax.pmean(gp, "data"), new_stats

    f = jax.jit(jax.shard_map(mapped, mesh=data_mesh(WORLD),
                              in_specs=(P(), P("data"), P("data")),
                              out_specs=(P("data"), P("data"), P(), P()), check_vma=False))
    y, gx, gp, new_stats = f(params, x, cot)
    split = lambda a: [a[nb * r:nb * (r + 1)] for r in range(WORLD)]   # noqa: E731
    port = dict(x=split(x), cot=split(cot), init=init, groups=groups)
    want = dict(y=np.asarray(y), gx=np.asarray(gx), g_weight=np.asarray(gp["scale"]),
                g_bias=np.asarray(gp["bias"]), running_mean=np.asarray(new_stats["mean"]),
                running_var=np.asarray(new_stats["var"]))
    return port, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Builds every input, runs every case once on 2 gloo ranks while JAX
    computes its side, and returns (port results per rank, JAX's)."""
    tmp = tmp_path_factory.mktemp("dist_step")
    key = jax.random.key(1)
    tiny = _jax_state("tiny", False)
    inputs, runners, want = {"steps": {}}, {}, {}
    for name, case in CASES.items():
        init = tiny if case["backbone"] == "tiny" else _jax_state(case["backbone"], case["remat"])
        inputs["steps"][name], runners[name] = _jax_case(case, key, init)
    inputs["eval"], want["eval"] = _eval_case(tiny)
    for name, make in (("mix", _mix_case), ("bn", _bn_case)):
        inputs[name], want[name] = make()
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(parallel.spawn, worker.step_cases, (path,), WORLD, "gloo",
                            ["cpu"] * WORLD, workdir=str(tmp))
        for name, run in runners.items():
            want[name] = run()
        return ranks.result(), want


def _assert_tree(got, want, param_atol, stat_atol, label):
    assert got.keys() == want.keys(), label
    for k, w in want.items():
        atol = stat_atol if k.endswith(("running_mean", "running_var")) else param_atol
        np.testing.assert_allclose(got[k], w.numpy(), rtol=0, atol=atol, err_msg=f"{label} {k}")


def _assert_step(got, want, param_atol, stat_atol=STAT_ATOL, loss_rtol=LOSS_RTOL):
    for name in ("sup", "unsup", "contrast", "total"):
        assert np.isfinite(got["metrics"][name]), name
        np.testing.assert_allclose(got["metrics"][name], want["metrics"][name], rtol=loss_rtol,
                                   atol=1e-6, err_msg=name)
    assert got["step"] == want["step"]
    _assert_tree(got["model"], want["model"], param_atol, stat_atol, "student")
    _assert_tree(got["teacher"], want["teacher"], param_atol, stat_atol, "teacher")
    np.testing.assert_allclose(got["prototypes"], want["prototypes"], rtol=0, atol=STAT_ATOL)


def test_ori_reference_partner_trajectory_matches_jax(runs):
    got, want = runs
    first, second = got[0]["ori_reference"]
    w0, w1 = want["ori_reference"]
    assert w0["metrics"]["unsup"] > 0 and w0["metrics"]["contrast"] > 0
    _assert_step(first, w0, PARAM_ATOL)
    _assert_step(second, w1, STEP1_PARAM_ATOL, STEP1_STAT_ATOL, loss_rtol=STEP1_LOSS_RTOL)


def test_mix_fused_ring_partner_step_matches_jax(runs):
    got, want = runs
    (w,) = want["mix_fused_ring"]
    assert w["metrics"]["unsup"] > 0 and w["metrics"]["contrast"] > 0
    _assert_step(got[0]["mix_fused_ring"][0], w, UPDATE_RTOL * w["update"])


def test_deep_stem_ohem_remat_step_matches_jax(runs):
    got, want = runs
    (w,) = want["ori_deep_stem_ohem_remat"]
    assert w["metrics"]["contrast"] > 0
    _assert_step(got[0]["ori_deep_stem_ohem_remat"][0], w, PARAM_ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_end_bit_equal(runs, case):
    got, _ = runs
    for a, b in zip(got[0][case], got[1][case]):
        assert a["metrics"] == b["metrics"] and a["step"] == b["step"]
        for part in ("model", "teacher"):
            for k in a[part]:
                np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=f"{part} {k}")
        np.testing.assert_array_equal(a["prototypes"], b["prototypes"])


def test_sharded_eval_matrix_matches_jax_and_one_process(runs):
    got, want = runs
    image, label, valid = want["eval"]["inputs"]
    for rank_mat in (got[0]["eval"], got[1]["eval"]):
        np.testing.assert_array_equal(rank_mat, want["eval"]["sharded"])
    np.testing.assert_array_equal(want["eval"]["sharded"], want["eval"]["single"])
    # the port on one process over the whole batch
    model = build_model(C, D, "tiny")
    model.load_state_dict(want["eval"]["state_dict"], strict=True)
    mat = make_eval_step(model, C)(torch.zeros((C, C), dtype=torch.int64), torch.from_numpy(image),
                                   torch.from_numpy(label), torch.from_numpy(valid))
    np.testing.assert_array_equal(mat.numpy(), want["eval"]["single"])
    counted = ((label >= 0) & valid[:, None, None]).sum()
    assert got[0]["eval"].sum() == counted < ((label >= 0).sum())   # padded rows count nothing


@pytest.mark.parametrize("mode", ["cutmix", "classmix"])
@pytest.mark.parametrize("partner", ["reference", "ring"])
def test_mix_partners_match_jax(runs, mode, partner):
    got, want = runs
    name = f"{mode}_{partner}"
    for part, w in enumerate(want["mix"][name]):
        g = np.concatenate([got[r]["mix"][name][part] for r in range(WORLD)])
        np.testing.assert_array_equal(g, w, err_msg=f"{name} output {part}")


def test_grouped_cross_replica_batchnorm_matches_jax(runs):
    got, want = runs
    bn = want["bn"]
    for key, atol in (("y", EXACT_ATOL), ("gx", GRAD_ATOL)):
        g = np.concatenate([got[r]["bn"][key] for r in range(WORLD)])
        np.testing.assert_allclose(g, bn[key], rtol=0, atol=atol, err_msg=key)
    for key in ("g_weight", "g_bias", "running_mean", "running_var"):
        for r in range(WORLD):
            np.testing.assert_allclose(got[r]["bn"][key], bn[key], rtol=0, atol=GRAD_ATOL,
                                       err_msg=f"rank {r} {key}")


def test_all_reduce_sum_backward_sums_cotangents(tmp_path):
    """y = sum_r x_r on every rank, scaled by (rank + 1) there: the gradient
    reaching each x_r is 1 + 2 = 3 (the cotangents of both ranks), not its
    own rank's factor."""
    got = parallel.spawn(worker.all_reduce_grad, ([[1.0, 2.0], [3.0, 4.0]],), WORLD, "gloo",
                         ["cpu"] * WORLD, workdir=str(tmp_path))
    for g in got:
        np.testing.assert_array_equal(g, [3.0, 3.0])


# ------------------------------------------------- one rank: bit-identical ----

@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "rendezvous"),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", list(CASES))
def test_one_rank_group_is_bit_identical_to_no_group(one_rank_group, case):
    spec = CASES[case]
    base = create_train_state(build_model(C, D, spec["backbone"], remat=spec["remat"], seed=4),
                              C, D, **OPT, device="cpu")
    base.prototypes = torch.from_numpy(_prototypes(spec))
    h, w = base.model.output_hw((CROP, CROP))
    draws = sample_step_draws(torch.Generator().manual_seed(6), StepConfig(**spec["cfg"]), B, B,
                              2 * B * h * w)
    batch = {k: torch.from_numpy(v) for k, v in _batch(9).items()}
    out = {}
    for distributed in (False, True):
        state = copy.deepcopy(base)
        set_distributed(state.model, distributed)
        set_distributed(state.teacher, distributed)
        step = make_train_step(StepConfig(**spec["cfg"], distributed=distributed))
        out[distributed] = step(state, batch, draws, 1.0)
    (plain, m_plain), (dp, m_dp) = out[False], out[True]
    assert float(m_plain["total"]) > 0
    for k in m_plain:
        assert torch.equal(m_plain[k], m_dp[k]), k
    for a, b in ((plain.model, dp.model), (plain.teacher, dp.teacher)):
        sa, sb = a.state_dict(), b.state_dict()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(plain.prototypes, dp.prototypes)
    for p, q in zip(plain.model.parameters(), dp.model.parameters()):
        assert torch.equal(plain.optimizer.state[p]["momentum_buffer"],
                           dp.optimizer.state[q]["momentum_buffer"])


def test_spawn_refuses_a_device_list_of_another_length(tmp_path):
    with pytest.raises(ValueError, match="3 devices for 2 ranks"):
        parallel.spawn(worker.all_reduce_grad, ([],), 2, "gloo", ["cpu"] * 3,
                       workdir=str(tmp_path))
    assert not os.listdir(tmp_path)
