"""CPU tests of the reference networks' files (``reference/networks/``): the
lookup by ``Network.name``, the contract that every such file keeps
(``benchmark/README.md``), the weight maker's kinds, and that the weights,
the FLOP counts and the test sizes of the configurations are those the
harness had before the networks were files of their own.
"""

import copy
import hashlib
import json
import re

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from conftest import ROOT, tiny

from benchmark import compare, flops, weights
from benchmark.reference import model as ref_model

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in BENCH["configs"]}

# Read before the networks had files of their own: sha256 over every tensor
# that ``fill_`` writes (sorted name, shape, float32 bytes) on the CPU from
# seed 2**31 + 7, with the count of tensors; the configuration at test size
# (sha256 of its sorted JSON); forward FLOPs of one image at the crop and at
# the test size (32x32).
SEED = 2 ** 31 + 7
_TINY = (134, "52d655d34df42419dee40a5ab3f0985fbe88c483f1c51b8185e7e685b09b2389")
DIGESTS = {
    ("voc_r101_os8", "full"):
        (569, "be0532b31340ad9269c18c6c8f8256c5433ece3b5acb9bd2575d83581be9d9e6"),
    ("city_r101_os8", "full"):
        (569, "44d0473fdb404d140eb396ca63b5abe5b093878721079e98ec2f4e9933d841ae"),
    ("voc_r101_os8", "tiny"): _TINY,
    ("city_r101_os8", "tiny"): _TINY,
}
TINY_CONFIGS = {
    "voc_r101_os8": "b786a89abf30069073b66a6bdd530110484ca3c92c4b0e3e2d45663d551d238d",
    "city_r101_os8": "fe31f93c94a42597ad2b448031a537ca0c4bc5f001e57a1760467af86d02206b",
}
FLOPS = {"voc_r101_os8": (526_067_433_472, 258_818_048),
         "city_r101_os8": (1_207_017_574_272, 258_818_048)}


def _digest(model):
    h = hashlib.sha256()
    for name, t in sorted(list(model.named_parameters()) + list(model.named_buffers()),
                          key=lambda kv: kv[0]):
        h.update(f"{name}:{tuple(t.shape)}:".encode())
        h.update(t.detach().contiguous().numpy().tobytes())
    return len(model.state_dict()), h.hexdigest()


@pytest.mark.parametrize("config,size", sorted(DIGESTS))
def test_weights_are_bit_equal_to_the_harness_before(config, size):
    cfg = CONFIGS[config] if size == "full" else tiny(CONFIGS[config])
    model = ref_model.build_reference(cfg)
    weights.fill_(model, SEED, cfg["Network"])
    assert _digest(model) == DIGESTS[(config, size)]


@pytest.mark.parametrize("config", sorted(TINY_CONFIGS))
def test_flops_and_test_size_are_the_harness_before(config):
    cfg = CONFIGS[config]
    small = tiny(cfg)
    assert small["Network"] == dict(cfg["Network"], num_class=6, backbone="tiny", output_dim=16,
                                    dtype="float32")
    assert hashlib.sha256(json.dumps(small, sort_keys=True).encode()).hexdigest() == \
        TINY_CONFIGS[config]
    crop = tuple(cfg["Dataset"]["crop_size"])
    assert (flops.forward_flops(cfg, crop), flops.forward_flops(small, (32, 32))) == FLOPS[config]


def test_an_unknown_network_raises_naming_its_path():
    with pytest.raises(FileNotFoundError) as err:
        ref_model.build_reference({"Network": {"name": "NoSuchNetwork", "num_class": 2}})
    assert str(ref_model.NETWORKS / "NoSuchNetwork.py") in str(err.value)


# ------------------------------------------------------------ the contract --

# The convolutions and matrix products as ATen runs them (``F.linear``,
# ``einsum`` and ``@`` come here as ``mm``, ``addmm`` or ``bmm``), with the
# places of the operands that have to come out of ``quantize``; a fused
# attention's query, key and value.
_PRODUCTS = {"convolution": (0, 1), "_convolution": (0, 1), "convolution_overrideable": (0, 1),
             "mm": (0, 1), "bmm": (0, 1), "mv": (0, 1), "dot": (0, 1), "vdot": (0, 1),
             "_int_mm": (0, 1), "_scaled_mm": (0, 1), "addmm": (1, 2),
             "_addmm_activation": (1, 2), "baddbmm": (1, 2), "addbmm": (1, 2), "addmv": (1, 2)}
_ATTENTION = "_scaled_dot_product"
# an operation named like a product that neither list holds fails the contract
# (interpolation, ``upsample_bilinear2d``, is none)
_LIKE_A_PRODUCT = re.compile(r"conv|mm|matmul|dot|(^|_)linear|einsum|attention|trilinear")
# operations whose output holds their inputs' values, besides views
_MOVES = {"clone", "_to_copy", "_unsafe_view", "constant_pad_nd", "im2col", "cat", "stack"}


class _Operands(TorchDispatchMode):
    """Every convolution and matrix product that ATen runs, and whether each
    of its operands came out of the network's ``quantize``, or of a view,
    copy or concatenation of such tensors."""

    def __init__(self):
        super().__init__()
        self.marked, self.calls = {}, []

    def _mark(self, t):
        self.marked[id(t)] = t

    def _quantized(self, t):
        return id(t) in self.marked

    def quantize(self, x):
        y = x * 1.0
        self._mark(y)
        return y

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name.startswith(_ATTENTION):
            self.calls.append((name, *(self._quantized(args[i]) for i in (0, 1, 2))))
        elif name in _PRODUCTS:
            self.calls.append((name, *(self._quantized(args[i]) for i in _PRODUCTS[name])))
        elif _LIKE_A_PRODUCT.search(name):
            self.calls.append((name, "not a product the contract knows", False))
        elif func.is_view or name in _MOVES:
            inputs = [t for t in tree_flatten((args, kwargs))[0]
                      if isinstance(t, torch.Tensor) and t.is_floating_point()]
            if inputs and all(map(self._quantized, inputs)):
                for t in tree_flatten(out)[0]:
                    if isinstance(t, torch.Tensor):
                        self._mark(t)
        return out


def check_contract(cfg: dict, out_hw) -> None:
    """What ``benchmark/README.md`` asks of a network file, at 32x32."""
    net = cfg["Network"]
    module = ref_model.network_file(net)
    assert isinstance(module.TINY, dict)
    with torch.device("meta"):
        meta = module.build(net)
    assert all(t.is_meta for t in meta.state_dict().values())
    model = ref_model.build_reference(cfg)
    weights._kinds(weights._named(model), net)        # every tensor has a rule
    weights.fill_(model, 1, net)
    for name, t in model.state_dict().items():
        assert t.dtype == torch.float32 or not t.is_floating_point(), name
        assert torch.isfinite(t.float()).all(), name
    assert any(k.startswith(compare.REP_HEAD) for k, _ in model.named_parameters())
    buffers = dict(model.named_buffers())
    bns = [k[:-len("running_mean")] for k in buffers if k.endswith("running_mean")]
    assert bns and all(f"{k}running_var" in buffers for k in bns)

    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    before = buffers[bns[0] + "running_mean"].clone()
    for groups in (1, 2):
        model.train()
        ops = _Operands()
        model.quantize = ops.quantize
        with ops, torch.no_grad():
            pred, rep = model(x, bn_groups=groups)
        unquantized = [call for call in ops.calls if not all(call[1:])]
        assert ops.calls and not unquantized, unquantized
        assert tuple(pred.shape) == (4, *out_hw, net["num_class"])
        assert tuple(rep.shape) == (4, *out_hw, net.get("output_dim", 256))
    assert not torch.equal(before, buffers[bns[0] + "running_mean"]), "train-mode BatchNorm"


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_every_network_file_keeps_the_contract(config):
    from css_tpu_torch.models.deeplabv3 import build_model

    cfg = tiny(CONFIGS[config])
    net = cfg["Network"]
    prog = build_model(net["num_class"], net["output_dim"], net["backbone"], dtype=torch.float32)
    check_contract(cfg, prog.output_hw((32, 32)))


# ------------------------------------------------- a network added as a file --

MINIMAL = '''"""A network of the tests: a stride-4 patch embedding, LayerNorm, attention
of two heads (fused, and its projection by an einsum), a Mix-FFN (Linear,
depthwise 3x3 conv, GELU, Linear), a 1x1 fuse with BatchNorm and ReLU, the
classifier and the representation head."""

import torch
import torch.nn as nn
import torch.nn.functional as F

TINY = {"width": 8}


class Net(nn.Module):
    def __init__(self, num_class, output_dim, width):
        super().__init__()
        w = width
        self.embed = nn.Conv2d(3, w, 7, stride=4, padding=3)
        self.norm = nn.LayerNorm(w, eps=1e-6)
        self.qkv = nn.Linear(w, 3 * w)
        self.proj = nn.Linear(w, w)
        self.fc1 = nn.Linear(w, 4 * w)
        self.dw = nn.Conv2d(4 * w, 4 * w, 3, padding=1, groups=4 * w)
        self.fc2 = nn.Linear(4 * w, w)
        self.fuse = nn.Conv2d(w, w, 1, bias=False)
        self.bn = nn.BatchNorm2d(w)
        self.classifier = nn.Conv2d(w, num_class, 1)
        self.representation = nn.Conv2d(w, output_dim, 1)
        self.quantize = lambda x: x

    def forward(self, x, bn_groups=1):
        q = self.quantize
        x = F.conv2d(q(x.permute(0, 3, 1, 2)), q(self.embed.weight), self.embed.bias, 4, 3)
        b, c, h, w = x.shape
        t = self.norm(x.flatten(2).transpose(1, 2))
        qkv = F.linear(q(t), q(self.qkv.weight), self.qkv.bias)
        qh, kh, vh = qkv.view(b, h * w, 3, 2, c // 2).permute(2, 0, 3, 1, 4)
        att = F.scaled_dot_product_attention(q(qh), q(kh), q(vh))
        att = att.transpose(1, 2).reshape(b, h * w, c)
        t = t + torch.einsum("bnc,dc->bnd", q(att), q(self.proj.weight)) + self.proj.bias
        u = F.linear(q(t), q(self.fc1.weight), self.fc1.bias)
        u = u.transpose(1, 2).reshape(b, 4 * c, h, w)
        u = F.conv2d(q(u), q(self.dw.weight), self.dw.bias, 1, 1, 1, 4 * c)
        u = F.linear(q(F.gelu(u).flatten(2).transpose(1, 2)), q(self.fc2.weight), self.fc2.bias)
        x = (t + u).transpose(1, 2).reshape(b, c, h, w)
        x = F.conv2d(q(x), q(self.fuse.weight))
        x = torch.cat([F.batch_norm(part, self.bn.running_mean, self.bn.running_var,
                                    self.bn.weight, self.bn.bias, self.training, 0.1, 1e-5)
                       for part in x.chunk(bn_groups)])
        x = F.relu(x)
        pred = F.conv2d(q(x), q(self.classifier.weight), self.classifier.bias)
        rep = F.conv2d(q(x), q(self.representation.weight), self.representation.bias)
        return pred.permute(0, 2, 3, 1), rep.permute(0, 2, 3, 1)


def build(network):
    return Net(network["num_class"], network.get("output_dim", 256), network.get("width", 64))


def weight_kind(name, t):
    if name.startswith(("norm.", "bn.")):
        return "one" if name.endswith(("weight", "running_var")) else "zero"
    if name.startswith(("classifier.", "representation.")):
        return "uniform"
    if name.endswith("bias"):
        return "zero"
    if t.dim() == 2:
        return ("trunc_normal", 0.02)
    if name == "dw.weight":
        return ("he_fan_out", t.shape[0])
    return "he_fan_out"
'''


@pytest.fixture
def minimal(tmp_path, monkeypatch):
    """A configuration of the network ``Minimal``, whose file lies in a
    networks directory of its own, where the lookup then looks."""
    (tmp_path / "Minimal.py").write_text(MINIMAL)
    monkeypatch.setattr(ref_model, "NETWORKS", tmp_path)
    cfg = copy.deepcopy(CONFIGS["voc_r101_os8"])
    cfg["Network"] = {"name": "Minimal", "num_class": 21, "output_dim": 256, "width": 64,
                      "dtype": "float32"}
    return cfg


def test_a_network_added_as_a_file_alone(minimal):
    small = tiny(minimal)
    assert small["Network"] == {"name": "Minimal", "num_class": 6, "output_dim": 16,
                                "width": 8, "dtype": "float32"}
    check_contract(small, (8, 8))
    model = ref_model.build_reference(small, device="meta")
    assert weights._kinds([("dw.weight", model.dw.weight), ("fc1.weight", model.fc1.weight)],
                          small["Network"]) == [("he_fan_out", 32), ("trunc_normal", 0.02)]
    # every layer runs at the 8x8 positions of a 32x32 image: 2 FLOPs a weight a position;
    # attention 2 FLOPs a query, key and channel for the scores and as many for the values
    matrices = sum(p.numel() for p in model.parameters() if p.dim() >= 2)
    assert flops.forward_flops(small, (32, 32)) == 2 * 64 * matrices + 4 * 64 * 64 * 8


@pytest.mark.parametrize("quantized,plain", [("q(kh)", "kh"), ("q(att)", "att"),
                                             ("q(self.dw.weight)", "self.dw.weight")])
def test_the_contract_finds_an_operand_left_unquantized(minimal, quantized, plain):
    """The key of the fused attention, an operand of the einsum, the depthwise
    convolution's weight: each left out of ``quantize`` fails the contract."""
    assert MINIMAL.count(quantized) == 1
    (ref_model.NETWORKS / "Minimal.py").write_text(MINIMAL.replace(quantized, plain))
    with pytest.raises(AssertionError, match="False"):
        check_contract(tiny(minimal), (8, 8))


@torch.no_grad()
def test_the_new_kinds_statistics(minimal):
    net = minimal["Network"]
    model = ref_model.build_reference(minimal)
    weights.fill_(model, 5, net)
    fc1, dw = model.fc1.weight, model.dw.weight
    # timm's default truncation (+-2, absolute) leaves a std of 0.02 whole
    assert float(fc1.std()) == pytest.approx(0.02, rel=0.03)
    assert abs(float(fc1.mean())) < 0.001 and float(fc1.abs().max()) <= 2.0
    # He fan-out over groups: a depthwise 3x3 has fan-out 9, not 9 * C_out
    assert float(dw.std()) == pytest.approx((2.0 / 9) ** 0.5, rel=0.05)
    assert float(model.embed.weight.std()) == pytest.approx((2.0 / (49 * 64)) ** 0.5, rel=0.05)
    for t in (model.fc1.bias, model.qkv.bias, model.proj.bias, model.dw.bias, model.embed.bias, model.norm.bias, model.bn.bias):
        assert torch.count_nonzero(t) == 0
    assert torch.equal(model.norm.weight, torch.ones(64))
    bound = 1.0 / 64 ** 0.5           # the bias takes its module's weight's fan in
    assert float(model.classifier.bias.abs().max()) <= bound
    assert bound >= float(model.classifier.weight.abs().max()) > 0.9 * bound
    again = ref_model.build_reference(minimal)
    weights.fill_(again, 5, net)
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
