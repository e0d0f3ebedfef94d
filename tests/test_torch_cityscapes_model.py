"""The Cityscapes recipe's network parts of the port against css_tpu, on the
CPU: the grouped BatchNorm of the fused forward, the deep-stem trunk
(``tiny_stem`` here, ``resnet101_stem``'s names and shapes), the deep-stem
checkpoint mapping, and per-stage remat.  Weights cross over through
``from_jax_variables``; inputs come from a numpy seed.

Tolerances.  ``GroupedBatchNorm`` alone differs from JAX's only in the order
of f32 sums: outputs to rtol 1e-5 / atol 1e-5, running stats to rtol 1e-5 /
atol 1e-6.  The deep-stem model, as ``tests/test_torch_model.py`` states for
the plain one: eval mode to rtol 1e-4 / atol 1e-5; train mode is
ill-conditioned at 2 images per BN group (the ASPP pool BN normalizes n = 2
values), so outputs are held to atol 1e-2, the trunk's BN stats to rtol 1e-4
/ atol 1e-5 and the head's to atol 1e-3.  Name and shape maps, the
checkpoint mapping and remat are exact: remat recomputes the same f32
operations on the CPU, so the loss, every gradient and every running stat
are bit-identical with and without it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from css_tpu.models import build_model as jax_build_model
from css_tpu.models.convert import convert_resnet_backbone
from css_tpu.models.resnet import GroupedBatchNorm as JaxGroupedBatchNorm
from css_tpu_torch.models.convert import from_jax_variables, load_torchvision_backbone
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.models.resnet import GroupedBatchNorm, resnet_tiny

BN_RTOL, BN_ATOL, STAT_ATOL = 1e-5, 1e-5, 1e-6
RTOL, ATOL = 1e-4, 1e-5
TRAIN_OUT_ATOL, HEAD_STAT_ATOL = 1e-2, 1e-3


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _group_input(seed, shape):
    """[B, H, W, C] with a different mean and scale in each half, so the
    groups' statistics, and their order, matter."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    half = shape[0] // 2
    x[:half] = x[:half] * 0.5 + 1.0
    x[half:] = x[half:] * 2.0 - 3.0
    return x


def _jax_bn(x, groups, train, stats=None):
    """(output NHWC, updated {mean, var}) of css_tpu's GroupedBatchNorm with
    scale/bias from a seed."""
    c = x.shape[-1]
    rng = np.random.default_rng(11)
    params = {"scale": jnp.asarray(rng.random(c, dtype=np.float32) + 0.5),
              "bias": jnp.asarray(rng.standard_normal(c).astype(np.float32))}
    if stats is None:
        stats = {"mean": jnp.asarray(rng.standard_normal(c).astype(np.float32)),
                 "var": jnp.asarray(rng.random(c, dtype=np.float32) + 0.5)}
    y, upd = JaxGroupedBatchNorm().apply({"params": params, "batch_stats": stats},
                                         jnp.asarray(x), train, groups, mutable=["batch_stats"])
    return np.asarray(y), upd["batch_stats"], params, stats


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("shape", [(4, 6, 5, 8), (4, 1, 1, 8)], ids=["spatial", "pooled"])
def test_grouped_batchnorm_matches_jax(train, groups, shape):
    x = _group_input(0, shape)
    want, want_stats, params, stats = _jax_bn(x, groups, train)
    bn = GroupedBatchNorm(shape[-1])
    bn.load_state_dict(from_jax_variables(params, stats))
    bn.train(train)
    got = bn(_nchw(x), groups).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=BN_RTOL, atol=BN_ATOL)
    for name, key in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(bn, key).numpy(), np.asarray(want_stats[name]),
                                   rtol=BN_RTOL, atol=STAT_ATOL, err_msg=name)
    if train and groups == 2:
        # the order of the running-stat updates shows: the halves swapped
        # give other stats, outside the tolerance
        swapped = np.concatenate([x[2:], x[:2]])
        _, other, _, _ = _jax_bn(swapped, groups, train, stats)
        assert not np.allclose(bn.running_mean.numpy(), np.asarray(other["mean"]),
                               rtol=BN_RTOL, atol=STAT_ATOL)
        # and n = (B/G) H W: Bessel's factor per group, not over the batch
        assert not np.allclose(np.asarray(want_stats["var"]),
                               np.asarray(_jax_bn(x, 1, train, stats)[1]["var"]),
                               rtol=BN_RTOL, atol=STAT_ATOL)


def test_grouped_batchnorm_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="groups"):
        GroupedBatchNorm(4)(torch.zeros(3, 4, 2, 2), 2)


# ------------------------------------------------------------ deep stem ----

def _stem_pair(hw, backbone="tiny_stem", num_classes=5, output_dim=16):
    jmodel = jax_build_model(num_classes=num_classes, output_dim=output_dim, backbone=backbone)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, *hw, 3)), train=False))(
        jax.random.key(0))
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.default_rng(3)      # non-trivial running stats for eval mode
    stats = jax.tree.map(lambda s: jnp.asarray(np.asarray(s) + rng.random(s.shape)
                                               .astype(np.float32) * 0.5), stats)
    tmodel = build_model(num_classes, output_dim, backbone)
    tmodel.load_state_dict(from_jax_variables(params, stats), strict=True)
    return jmodel, params, stats, tmodel


@pytest.mark.parametrize("crop", [32, 33])
@pytest.mark.parametrize("bn_groups", [1, 2])
def test_tiny_stem_model_train_mode_matches_jax(crop, bn_groups):
    jmodel, params, stats, tmodel = _stem_pair((crop, crop))
    x = _group_input(4, (2 * bn_groups, crop, crop, 3))
    (pred_j, rep_j), upd = jmodel.apply({"params": params, "batch_stats": stats},
                                        jnp.asarray(x), train=True, bn_groups=bn_groups,
                                        mutable=["batch_stats"])
    tmodel.train()
    pred_t, rep_t = tmodel(torch.from_numpy(x), bn_groups=bn_groups)
    assert pred_t.shape == pred_j.shape and tuple(pred_t.shape[1:3]) == tmodel.output_hw(
        (crop, crop))
    np.testing.assert_allclose(pred_t.detach().numpy(), np.asarray(pred_j), atol=TRAIN_OUT_ATOL)
    np.testing.assert_allclose(rep_t.detach().numpy(), np.asarray(rep_j), atol=TRAIN_OUT_ATOL)
    got_sd = tmodel.state_dict()
    for key, want in from_jax_variables(params, upd["batch_stats"]).items():
        if key.endswith(("running_mean", "running_var")):
            atol = ATOL if key.startswith("backbone.") else HEAD_STAT_ATOL
            np.testing.assert_allclose(got_sd[key].numpy(), want.numpy(), rtol=RTOL, atol=atol,
                                       err_msg=key)


@pytest.mark.parametrize("crop", [32, 33])
def test_tiny_stem_model_eval_mode_matches_jax(crop):
    jmodel, params, stats, tmodel = _stem_pair((crop, crop))
    x = np.random.default_rng(5).standard_normal((2, crop, crop, 3)).astype(np.float32)
    pred_j, rep_j = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                 train=False)
    tmodel.eval()
    with torch.no_grad():
        pred_t, rep_t = tmodel(torch.from_numpy(x), bn_groups=2)   # no effect in eval
    if crop == 32:   # the ceil-mode pool: 9 x 9, not the plain stem's 8 x 8
        assert pred_j.shape == pred_t.shape == (2, 9, 9, 5)
        assert build_model(5, 16, "tiny").output_hw((32, 32)) == (8, 8)
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rep_t.numpy(), np.asarray(rep_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backbone", ["tiny", "tiny_stem"])
def test_output_hw_is_the_models_output_size(backbone):
    """``output_hw`` against the port's forward and JAX's shapes, square and
    not, at sizes where the ceil-mode pool adds a row and where it does not."""
    jmodel = jax_build_model(num_classes=3, output_dim=4, backbone=backbone)
    tmodel = build_model(3, 4, backbone).eval()
    for hw in ((32, 33), (17, 40), (64, 65), (129, 31), (7, 9)):
        with torch.no_grad():
            got = tuple(tmodel(torch.zeros(1, *hw, 3))[0].shape[1:3])
        want = jax.eval_shape(lambda x: jmodel.init_with_output(
            jax.random.key(0), x, train=False)[0][0], jax.ShapeDtypeStruct((1, *hw, 3),
                                                                           jnp.float32)).shape
        assert tmodel.output_hw(hw) == got == tuple(want[1:3]), hw


def test_resnet101_stem_names_and_shapes_match_jax():
    """The port's ``resnet101_stem`` model has exactly the tensors of the Flax
    tree (names through ``from_jax_variables``, shapes transposed), with
    ``layer4_0``/``layer5_0``/``layer6_0`` for the multi-grid blocks and the
    residual BN scales at zero."""
    jmodel = jax_build_model(num_classes=19, output_dim=256, backbone="resnet101_stem")
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros((1, 65, 65, 3)), train=False),
                            jax.random.key(0))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = from_jax_variables(zeros["params"], zeros["batch_stats"])
    tmodel = build_model(19, 256, "resnet101_stem")
    got = tmodel.state_dict()
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].shape == value.shape, key
    trunk = tmodel.backbone
    assert [n for names in trunk.block_names for n in names][-3:] == [
        "layer4_0", "layer5_0", "layer6_0"]
    assert [getattr(trunk, n).conv2.dilation for n in ("layer4_0", "layer5_0", "layer6_0")] == [
        4, 8, 16]
    assert tuple(got["backbone.layer1_0.conv1.conv.weight"].shape) == (64, 128, 1, 1)
    for name in (n for names in trunk.block_names for n in names):
        assert not getattr(trunk, name).conv3.bn.weight.any(), name
    assert got["backbone.stem3.bn.weight"].eq(1).all()
    tmodel.load_state_dict(want, strict=True)


def _deep_stem_checkpoint(seed=0):
    """A random numpy state dict in the reference's deep-stem layout
    (``conv1.{0,1,3,4,6}``, ``bn1``, ``layer1..4``)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = rng.standard_normal((o, i, k, k)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = (rng.random(c) + 0.5).astype(np.float32)
        sd[f"{name}.bias"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{name}.running_var"] = (rng.random(c) + 0.5).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.int64(3)

    conv("conv1.0", 64, 3, 3)
    bn("conv1.1", 64)
    conv("conv1.3", 64, 64, 3)
    bn("conv1.4", 64)
    conv("conv1.6", 128, 64, 3)
    bn("bn1", 128)
    inplanes = 128
    for layer, (planes, blocks) in enumerate(zip((64, 128, 256, 512), (3, 4, 23, 3)), 1):
        for b in range(blocks):
            p = f"layer{layer}.{b}"
            conv(f"{p}.conv1", planes, inplanes, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
            if b == 0:
                conv(f"{p}.downsample.0", planes * 4, inplanes, 1)
                bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    sd["fc.weight"] = rng.standard_normal((10, 2048)).astype(np.float32)
    return sd


def test_deep_stem_checkpoint_loads_as_css_tpu_converts_it():
    sd = _deep_stem_checkpoint()
    jbackbone = jax_build_model(num_classes=19, backbone="resnet101_stem").backbone
    params, stats = convert_resnet_backbone(sd, jbackbone)
    want = from_jax_variables(params, stats)
    model = build_model(19, 256, "resnet101_stem")
    got = load_torchvision_backbone({k: torch.as_tensor(v) for k, v in sd.items()}, model)
    assert got.keys() == want.keys() == model.backbone.state_dict().keys()
    loaded = model.backbone.state_dict()
    for key, value in want.items():
        assert torch.equal(got[key], value), key
        assert torch.equal(loaded[key], value), key
    assert torch.equal(loaded["layer6_0.conv2.conv.weight"],
                       torch.from_numpy(sd["layer4.2.conv2.weight"]))
    assert torch.equal(loaded["stem2.bn.running_var"],
                       torch.from_numpy(sd["conv1.4.running_var"]))
    del sd["conv1.4.running_var"]
    with pytest.raises(KeyError, match=r"conv1\.4\.running_var"):
        load_torchvision_backbone(sd, model)


# ---------------------------------------------------------------- remat ----

@pytest.mark.parametrize("deep_stem", [False, True], ids=["plain", "deep_stem"])
@pytest.mark.parametrize("groups", [1, 2])
def test_remat_changes_no_loss_gradient_or_running_stat(deep_stem, groups):
    """One train-mode step of the tiny trunk under each remat setting: the
    loss, every gradient and every running stat equal the run without remat
    bit for bit, though the remat'd blocks ran their BNs twice (the
    recompute in backward leaves the running stats alone)."""
    x = torch.from_numpy(_group_input(6, (2 * groups, 33, 33, 3))).permute(0, 3, 1, 2)
    runs = {}
    for remat, policy in ((False, "nothing"), ((2,), "nothing"), (True, "nothing"),
                          (True, "save_mid")):
        torch.manual_seed(0)
        net = resnet_tiny(remat=remat, remat_policy=policy, deep_stem=deep_stem).train()
        calls = []
        net.layer3_0.conv1.bn.register_forward_hook(lambda *_: calls.append(1))
        low, final = net(x, groups)
        loss = final.square().sum() + low.sum()
        loss.backward()
        runs[remat, policy] = (loss.detach(), {k: p.grad for k, p in net.named_parameters()},
                               {k: b for k, b in net.named_buffers()}, len(calls))
    base_loss, base_grads, base_stats, base_calls = runs.pop((False, "nothing"))
    assert base_calls == 1
    assert all(g is not None and g.any() for g in base_grads.values())
    for key, (loss, grads, stats, calls) in runs.items():
        assert calls == 2, key                 # the block was recomputed in backward
        assert torch.equal(loss, base_loss), key
        for name, g in grads.items():
            assert torch.equal(g, base_grads[name]), (key, name)
        for name, s in stats.items():
            assert torch.equal(s, base_stats[name]), (key, name)


def test_remat_is_skipped_without_grad_and_refuses_unknown_policies():
    net = resnet_tiny(remat=True).train()
    calls = []
    net.layer1_0.conv1.bn.register_forward_hook(lambda *_: calls.append(1))
    with torch.no_grad():
        net(torch.zeros(2, 3, 16, 16))
    assert len(calls) == 1
    with pytest.raises(ValueError, match="remat_policy"):
        resnet_tiny(remat=True, remat_policy="everything")
