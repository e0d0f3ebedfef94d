"""CPU tests of the harness: every cell resolves to its files by name, the
declaration keeps to the contract's shapes, a tiny run prints a result line
of the contract's shape and loads no JAX, the FLOP counter and the byte
bound on known shapes, and the refusals without a card."""

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from conftest import ROOT, tiny_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_whys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    from benchmark.spec import load_cell

    c = load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert (ROOT / "benchmark" / "configs" / f"{entry['config']}.json").exists()
    assert (ROOT / "benchmark" / "traffic" / f"{entry['traffic']}.json").exists()
    assert c.traffic["kind"] in ("train", "eval")
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    assert c.limits, "every cell has the limits of its correct"


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_state_their_cut(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["source"] == config["source"] and data["reduced"] == config["reduced"]
    assert data["assumed"]
    for key in config["reduced"]:
        assert not re.search(r"(_dim|_rank|hidden|width|size)$", key), key


def test_every_file_under_paths_has_a_plain_name():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_prints_a_contract_line(cell, capsys):
    from benchmark.run import emit, run_cell

    c = tiny_cell(cell)
    for trace in (False, True):
        result = run_cell(c, 2 ** 31 + 11, 0.5, trace, torch.device("cpu"), 0.0)
        assert emit(result) == 0
        out = capsys.readouterr()
        line = json.loads(out.out.strip().splitlines()[-1])
        assert list(line)[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
        assert isinstance(line["correct"], bool) and line["attempted"] >= 1
        assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
        assert set(line["metrics"]) <= want
        if not trace:
            assert set(line["metrics"]) == want
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
        last = out.err.strip().splitlines()[-len(line["checks"]):]
        assert all(s.startswith("check ") and " limit " in s for s in last)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "css_tpu_torch_fake.sub", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "css_tpu.fake", object())
    assert run.forbidden_modules() == ["css_tpu"]


def test_a_tiny_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import torch\nfrom conftest import tiny_cell\nfrom benchmark import run\n"
            "r = run.run_cell(tiny_cell('voc_ori_train'), 5, 0.2, False,\n"
            "                 torch.device('cpu'), 0.0)\n"
            "print(run.forbidden_modules(), sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'css_tpu')))\n"
            % (str(ROOT), str(ROOT / "benchmark" / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def test_harness_sources_import_neither_jax_nor_css_tpu():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "css_tpu"), (path, name)
                if "reference" in path.parts:
                    assert top != "css_tpu_torch", (path, name)


def _run_script(args, cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], capture_output=True,
                          text=True, timeout=300, cwd=cwd)


def test_refuses_without_a_card():
    out = _run_script(["--workload", "voc_ori_train", "--seed", "1", "--seconds", "1"], ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_script(["--workload", "voc_ori_train", "--seed", "1", "--seconds", "1"],
                      tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_flop_counter_on_known_shapes():
    """The counter's total is the sum over the network's convolutions of
    2 * C_in * C_out * k^2 * H_out * W_out, read from the shapes."""
    from benchmark import flops
    from benchmark.reference.model import build_reference

    cfg = tiny_cell("voc_ori_train").config
    model = build_reference(cfg, device="meta").eval()
    total = []
    real = F.conv2d

    def conv(x, w, *a, **k):
        y = real(x, w, *a, **k)
        total.append(2 * w.shape[1] * w.shape[0] * w.shape[2] * w.shape[3]
                     * y.shape[0] * y.shape[2] * y.shape[3])
        return y

    F.conv2d = conv
    try:
        model(torch.empty((1, 32, 32, 3), device="meta"))
    finally:
        F.conv2d = real
    assert flops.forward_flops(cfg, (32, 32)) == sum(total)
    voc = json.loads((ROOT / "benchmark/configs/voc_r101_os8.json").read_text())
    f = flops.forward_flops(voc, (512, 512))
    assert 0.50e12 < f < 0.55e12
    assert flops.train_step_flops(voc, (512, 512), 8, 8) == 56 * f


def test_byte_bound_on_known_shapes():
    from benchmark import flops

    assert flops.class_live_rows_bytes(21, 262_144) == 21 * 262_144 * 4 + 262_144 * 4 + 21 * 22 * 4
    assert flops.class_live_rows_bytes(21, 262_144) / flops.HBM_BYTES_PER_S * 1e3 == \
        pytest.approx(0.00691, abs=5e-5)


def test_layer_readers_on_a_known_record():
    from benchmark.spec import load_cell

    readers = {}
    for cell in CELLS:
        readers.update(load_cell(cell).readers)
    trace = {"units": 2, "kernels": 40, "launches": 36, "busy_s": 0.6, "span_s": 0.8,
             "ms_by_category": {"conv": 100.0, "matmul": 10.0, "elementwise": 50.0,
                                "reduction": 5.0},
             "ms_by_name": {"class_live_rows_kernel": 0.08}, "count_by_name":
                 {"class_live_rows_kernel": 2}}
    rec = {"kind": "train", "trace": trace, "flops_per_step": 1e12, "peak_flop_per_s": 1e15,
           "window": {"steps": 10, "seconds": 5.0, "images": 160, "loader_wait_s": [0.002] * 4,
                      "step_ms": [350.0, 450.0] * 5},
           "class_live_rows_bytes": 3.35e6, "hbm_bytes_per_s": 3.35e12}
    assert readers["kernels_per_step.train"](rec) == 18
    assert readers["device_ms.conv.train"](rec) == 110.0
    assert readers["device_ms.norm_eltwise.train"](rec) == 55.0
    assert readers["device_idle_share.train"](rec) == pytest.approx(0.25)
    assert readers["mfu.train"](rec) == pytest.approx(0.2)
    assert readers["loader_wait_ms.train"](rec) == pytest.approx(2.0)
    assert readers["class_live_rows_roofline"](rec) == pytest.approx(1e-3 / 0.08 * 100)
    assert readers["class_live_rows_roofline"](dict(rec, trace=None)) is None
    # the trace's names: copies are no launches, a layout transpose no convolution
    from benchmark import devtrace

    assert not devtrace.is_launch("Memcpy HtoD (Pinned -> Device)")
    assert devtrace.is_launch("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>()")
    assert devtrace.category("void nchwToNhwcKernel<__nv_bfloat16>()") == "other"
    assert devtrace.category("sm90_xmma_fprop_implicit_gemm_bf16_nhwc") == "conv"
