"""The port stands alone: no file of css_tpu_torch/, chip_smoke.py or
kernel_ab.py imports JAX, css_tpu, PyYAML or orbax, PIL and tensorboardX are
imported only inside the functions that need them, and the entry points run
on the card unless asked for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "css_tpu", "yaml", "orbax")
OPTIONAL = ("PIL", "tensorboardX")      # imported inside functions only


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _top_level_modules(path: Path):
    """Modules imported at module level (outside any function)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        else:
            stack.extend(ast.iter_child_nodes(node))


def _port_files():
    return sorted((ROOT / "css_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                             ROOT / "kernel_ab.py"]


def test_port_imports_neither_jax_nor_css_tpu():
    files = _port_files()
    assert len(files) > 10
    assert {"evaluate_main.py", "predict_main.py", "draws.py"} <= {p.name for p in files}
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:   # "css_tpu_torch" is its own top-level name
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_optional_packages_are_imported_inside_functions_only():
    bad = [f"{path.relative_to(ROOT)}: {mod}" for path in _port_files()
           for mod in _top_level_modules(path) if mod.split(".")[0] in OPTIONAL]
    assert not bad, bad
    datasets = ROOT / "css_tpu_torch" / "data" / "datasets.py"
    assert "PIL" in {m.split(".")[0] for m in _imported_modules(datasets)}


def test_forbidden_scan_tells_css_tpu_from_the_port(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import css_tpu_torch.ops\nfrom css_tpu.ops import augment\n")
    tops = [m.split(".")[0] for m in _imported_modules(probe)]
    assert [t in FORBIDDEN for t in tops] == [False, True]


def test_entry_points_default_to_cuda():
    from css_tpu_torch import resolve_device
    from css_tpu_torch.models.deeplabv3 import build_model
    from css_tpu_torch.train.state import create_train_state

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(build_model(4, 8, "tiny"), 4, 8, base_lr=1e-2,
                           weight_decay=0.0, total_steps=10)
    assert resolve_device("cpu").type == "cpu"
