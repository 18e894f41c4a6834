"""The harness's own checks on the CPU: BENCHMARK.json against the
benchmark's contract, every part of a cell found by its name (and a new
cell added as files alone), the yardstick's counts against hand counts,
and no import of JAX, the JAX package or the old benchmarks.

Run from the repository root:
    PYTHONPATH=src python -m pytest -q fpisa_bench/tests/check_*.py
"""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from fpisa_bench import counts, run, spec

HERE = spec.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert bench["paths"] == ["fpisa_bench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"fpisa_bench/configs/{c['name']}.json"
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert json.loads((spec.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["config"] in names and w["chips"] in (1, 4) and _line(w["why"])
        cells.add(w["name"])
    assert len(cells) == len(bench["workloads"])
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(cells) // 4)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    metric_names = list(e2e) + [m["name"] for m in bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        c = spec.Cell(cell, bench)
        assert "setup_s" in [m["name"] for m in c.end_to_end] and len(c.end_to_end) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in [e["name"] for e in c.end_to_end]


def test_every_part_of_a_cell_is_found_by_name():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.Cell(w["name"], bench)
        kind = spec.kind(cell.traffic["kind"])
        assert callable(kind.run)
        assert callable(spec.reference(cell.config_name).param_spec)
        assert set(cell.limits())
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = spec.metric_reader(m["name"])
        assert reader.SOURCE == m["source"], m["name"]
        assert reader.MOVES == m.get("moves"), m["name"]
        assert callable(reader.read)


NEW_FILES = {
    "configs/tiny_dense.json": None,  # the qwen file with other numbers
    "configs/tiny_dense.py": None,    # the qwen reference
    "traffic/train_tiny.json": None,  # the 4 x 4,096 mix, smaller
    "metrics/steps_done.py": '"""Steps in the window."""\nSOURCE = "program_counter"\n'
                             'MOVES = "train_tok_s"\n\n\ndef read(r):\n    return r.window.count\n',
    "limits/tiny_train.json": None,
}


def test_a_new_cell_is_files_and_entries_alone(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a metric and a cell
    as new files and new entries, and find each by name in a fresh
    process: no file that was there changes."""
    shutil.copytree(HERE, tmp_path / "fpisa_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "fpisa_bench").rglob("*") if p.is_file()}
    b = tmp_path / "fpisa_bench"
    cfg = json.loads((b / "configs/qwen15_0_5b.json").read_text())
    cfg.update(name="tiny_dense", num_hidden_layers=2, vocab_size=512)
    (b / "configs/tiny_dense.json").write_text(json.dumps(cfg))
    shutil.copy(b / "configs/qwen15_0_5b.py", b / "configs/tiny_dense.py")
    mix = json.loads((b / "traffic/train_4x4096.json").read_text())
    mix.update(batch=2, seq=64)
    (b / "traffic/train_tiny.json").write_text(json.dumps(mix))
    (b / "metrics/steps_done.py").write_text(NEW_FILES["metrics/steps_done.py"])
    shutil.copy(b / "limits/qwen_train_4k.json", b / "limits/tiny_train.json")
    bench = spec.benchmark()
    bench["configs"].append({"name": "tiny_dense", "source": "test", "reduced": [],
                             "file": "fpisa_bench/configs/tiny_dense.json", "why": "test"})
    bench["workloads"].append({"name": "tiny_train", "config": "tiny_dense",
                               "traffic": "train_tiny", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step",
                               "moves": "train_tok_s", "workloads": ["tiny_train"]})
    bench["end_to_end"][0]["workloads"].append("tiny_train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = ("from fpisa_bench import spec\n"
             "c = spec.Cell('tiny_train')\n"
             "print(c.config['num_hidden_layers'], c.traffic['seq'], spec.kind(c.traffic['kind'])"
             ".__name__, [m['name'] for m in c.per_layer], "
             "spec.metric_reader('steps_done').MOVES, sorted(c.limits()))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, check=True).stdout
    assert out.split()[:2] == ["2", "64"] and "steps_done" in out and "train_tok_s" in out
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_counts_against_hand_counts():
    # A1 at PERF.md's shape, 4 x 4,096, 16 heads of 64, causal: 0.1390 and 0.3475 ms
    ff, fb, bf, bb = counts.a1_work(4, 4096, 4096, 16, 64, True, 2)
    pairs = 4 * 16 * 4096 * 4097 // 2
    assert (ff, bf) == (4 * 64 * pairs, 10 * 64 * pairs)
    assert round(ff / counts.PEAK_FLOPS_BF16 * 1e3, 4) == 0.1390
    assert round(bf / counts.PEAK_FLOPS_BF16 * 1e3, 4) == 0.3475
    assert counts.a1_bound_s(4, 4096, 16, 64, 2, 2, 1) == pytest.approx(
        (2 * ff + bf) / counts.PEAK_FLOPS_BF16)
    # K1's modes and K2 on bf16 leaves: 14 bytes an element, 26 at k = 4 (chip_smoke.py)
    assert counts.fpisa_bytes_per_elem(1, 2) == 14 and counts.fpisa_bytes_per_elem(4, 2) == 26
    # one qwen tree at k = 4: 463,987,712 elements x 26 B at 3.35 TB/s, 3.60 ms
    assert round(463_987_712 * 26 / counts.HBM_BYTES_PER_S * 1e3, 2) == 3.60
    # K6's leaf mode at bf16: 2 W + 2
    assert [counts.k6_leaf_bytes_per_elem(w, 2) for w in (1, 4)] == [4, 10]
    # qwen1.5-0.5b: 24 x (4 x 1024^2 + 3 x 1024 x 2816) + 1024 x 151936 product parameters
    assert counts.dense_matmul_params(1024, 16, 16, 64, 2816, 24, 151936) == 463_863_808
    per_token = counts.dense_train_flops_per_token(1024, 16, 16, 64, 2816, 24, 151936, 4096)
    assert per_token == 6 * 463_863_808 + 12 * 64 * 16 * 24 * 4097 / 2
    assert round(per_token / 1e9, 3) == 3.387


FORBIDDEN_IMPORTS = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
REFERENCE_FILES = ("counts.py", "data.py", "fpisa_ref.py", "reference_train.py", "configs")


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_the_jax_package_or_benchmarks():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not _imports(f) & FORBIDDEN_IMPORTS, f


def test_the_reference_imports_nothing_of_the_program():
    for name in REFERENCE_FILES:
        for f in ([HERE / name] if name.endswith(".py") else sorted((HERE / name).glob("*.py"))):
            assert "repro_torch" not in _imports(f), f


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "reproduce", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert run.forbidden_modules() == ["jaxlib", "repro"]
