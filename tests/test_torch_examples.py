"""The port's counterparts of the reference's ``examples/`` drivers, run as
``python -m repro_torch.examples.<name> --device cpu``, print what the
reference's print:

* ``quickstart``: every line equal to ``examples/quickstart.py``'s (the
  FPISA numerics are bit-exact, so even the error quantiles and the
  overwrite count match), the backend's name aside (``torch`` for ``jnp``).
* ``serve_lm --smoke``, both engines: the same lines, and the same request,
  token, step and latency counters as ``examples/serve_lm.py`` (the greedy
  tokens differ: each side draws its weights from its own generator).
* ``train_lm --smoke``: the reference's ``[train]`` and ``final loss``
  lines, with finite losses.
"""
import ast
import math
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference(name, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join("examples", f"{name}.py"), *args],
                         capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.splitlines()


def _port(capsys, name, *args):
    module = __import__(f"repro_torch.examples.{name}", fromlist=["main"])
    module.main(["--device", "cpu", *args])
    return capsys.readouterr().out.splitlines()


def test_quickstart_prints_the_reference_lines(capsys):
    mine = _port(capsys, "quickstart")
    ref = _reference("quickstart")
    assert [ln.replace("[torch]", "[jnp]") for ln in mine] == ref
    assert "bit-identical to per-leaf: True" in mine[-1]


def _telemetry(lines):
    line = next(ln for ln in lines if ln.startswith("telemetry (aggregated via"))
    return ast.literal_eval(line.split("): ", 1)[1])


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_serve_lm_prints_the_reference_lines(capsys, engine):
    mine = _port(capsys, "serve_lm", "--smoke", "--engine", engine)
    ref = _reference("serve_lm", "--smoke", "--engine", engine)
    assert len(mine) == len(ref)
    assert mine[0] == ref[0] == (f"serving internlm2-20b-smoke: 0.1M params, engine={engine}, "
                                 f"telemetry agg=fpisa")
    strip = re.compile(r"in [\d.]+s \([\d.]+ tok/s")
    assert strip.sub("", mine[1]) == strip.sub("", ref[1])
    assert _telemetry(mine) == _telemetry(ref)
    if engine == "continuous":
        assert mine[2:4] == ref[2:4]  # latency in scheduler steps, paged KV peak
    rid = re.compile(r"  rid=(\d+) -> \[")
    assert [rid.match(ln).group(1) for ln in mine[-3:]] == \
        [rid.match(ln).group(1) for ln in ref[-3:]]


def test_train_lm_prints_the_reference_lines(capsys, tmp_path):
    lines = _port(capsys, "train_lm", "--smoke", "--steps", "3", "--ckpt-dir", str(tmp_path))
    steps = [re.match(r"\[train\] step +(\d+) loss ([\d.]+) gnorm ([\d.]+) [\d,]+ tok/s", ln)
             for ln in lines if ln.startswith("[train] step")]
    assert [int(m.group(1)) for m in steps] == [0, 2]
    final = re.match(r"final loss ([\d.]+) \(from ([\d.]+)\); resume supported via "
                     r"--ckpt-dir \(re-run to continue\)$", lines[-1])
    assert final and final.group(2) == steps[0].group(2)
    assert all(math.isfinite(float(v)) for v in final.groups())
