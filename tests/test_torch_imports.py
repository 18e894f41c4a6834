"""Import guard of the port: ``src/repro_torch/**.py`` and ``chip_smoke.py``
import neither ``jax`` nor anything of the JAX package ``repro`` (not even
its jax-free modules), and no ``except`` around a kernel build or launch
falls back to a plain (``ref``) version. An AST walk, no imports needed.
"""
import ast
import os
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") \
                and node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node.lineno, node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imports(tree) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _names(node):
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id
        elif isinstance(n, ast.Attribute):
            yield n.attr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_fallback_to_plain_versions_in_exception_handlers(path):
    """A handler that reaches for ``ref`` / a ``*_ref`` function would hide a
    failed build or launch behind the plain version."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            for handler in node.handlers:
                hits = [n for n in _names(ast.Module(body=handler.body, type_ignores=[]))
                        if n == "ref" or n.endswith("_ref")]
                assert not hits, (f"{path.relative_to(REPO)}:{handler.lineno} falls back "
                                  f"to {hits} in an exception handler")


def test_guard_sees_the_whole_port():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/kernels/ops.py", "src/repro_torch/core/allreduce.py",
            "src/repro_torch/core/bucketer.py", "src/repro_torch/runtime/elastic.py",
            "src/repro_torch/trace/tracer.py", "src/repro_torch/trace/export.py",
            "src/repro_torch/trace/cli.py", "src/repro_torch/autotune/costmodel.py",
            "src/repro_torch/autotune/search.py", "src/repro_torch/autotune/profile.py",
            "src/repro_torch/serve/engine.py", "src/repro_torch/serve/scheduler.py",
            "src/repro_torch/serve/kvcache.py", "src/repro_torch/serve/loadgen.py",
            "src/repro_torch/launch/serve.py", "src/repro_torch/models/attention.py",
            "src/repro_torch/models/transformer.py", "src/repro_torch/core/switch.py",
            "src/repro_torch/switchsim/dataplane.py", "src/repro_torch/switchsim/tenancy.py",
            "src/repro_torch/switchsim/query.py", "src/repro_torch/db/query.py",
            "src/repro_torch/launch/query.py", "src/repro_torch/models/moe.py",
            "src/repro_torch/models/mamba2.py", "src/repro_torch/models/layers.py",
            "src/repro_torch/models/registry.py", "src/repro_torch/interop.py",
            "src/repro_torch/train/step.py", "src/repro_torch/launch/train.py",
            "src/repro_torch/configs/__init__.py", "src/repro_torch/configs/arctic_480b.py",
            "src/repro_torch/configs/kimi_k2.py", "src/repro_torch/configs/zamba2_7b.py",
            "src/repro_torch/configs/llava_next_34b.py", "src/repro_torch/configs/mamba2_780m.py",
            "src/repro_torch/configs/internlm2_20b.py", "src/repro_torch/configs/deepseek_67b.py",
            "src/repro_torch/configs/stablelm_3b.py", "src/repro_torch/examples/quickstart.py",
            "src/repro_torch/examples/train_lm.py", "src/repro_torch/examples/serve_lm.py",
            "chip_smoke.py"} <= names
