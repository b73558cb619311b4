"""repro_torch stands alone: importing it loads no JAX and nothing of the
JAX package, its entry points (the partition CLI among them) refuse to
run without a CUDA device unless ``device="cpu"`` is passed, and
``chip_smoke.py`` fails (printing no result) where there is no GPU or no
port beside it.

Each check runs in a fresh interpreter with CUDA hidden, so the test
process's own imports of JAX cannot mask a leak.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


def _run(code: str, cwd=ROOT, timeout=300):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _modules():
    pkg = SRC / "repro_torch"
    mods = []
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'repro.'))\n"
        "             or m == 'repro')\n"
        "print(json.dumps(bad))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_never_name_the_reference_package():
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s, f"{path}: {s}"
                ours = s.startswith(("from repro_torch", "import repro_torch"))
                assert ours or not s.startswith(
                    ("from repro ", "from repro.", "import repro")), \
                    f"{path}: {s}"


def test_entry_points_raise_without_cuda_unless_cpu_is_asked_for():
    code = (
        "import numpy as np\n"
        "from repro_torch import api\n"
        "from repro_torch.core import coarsening, deep_mgp\n"
        "from repro_torch.graphs import generators\n"
        "from repro_torch.kernels.bsr_spmm import ops as bsr_ops\n"
        "from repro_torch.kernels.embedding_bag import ops as eb_ops\n"
        "from repro_torch.kernels.lp_gain import ops as gain_ops\n"
        "g = generators.make('rgg2d', 300, 8.0, seed=1)\n"
        "lab = np.arange(g.n) % 4\n"
        "cw = np.bincount(lab, minlength=4)\n"
        "x = np.ones((g.n, 3), np.float32)\n"
        "idx = np.zeros((5, 2), np.int32)\n"
        "tab = np.ones((3, 4), np.float32)\n"
        "cfg = deep_mgp.PartitionerConfig(contraction_limit=50,\n"
        "                                 num_chunks=2, ip_repetitions=1)\n"
        "calls = {\n"
        "  'Partitioner': lambda: api.Partitioner(backend='single'),\n"
        "  'partition': lambda: deep_mgp.partition(g, 4, cfg),\n"
        "  'cluster': lambda: coarsening.cluster(g, 10),\n"
        "  'api.partition': lambda: api.partition(g, 4, config=cfg),\n"
        "  'lp_gain': lambda: gain_ops.lp_gain(g, lab, cw, 100.0),\n"
        "  'spmm': lambda: bsr_ops.spmm(g, x),\n"
        "  'embedding_bag': lambda: eb_ops.embedding_bag(idx, tab),\n"
        "}\n"
        "for name, fn in calls.items():\n"
        "    try:\n"
        "        fn()\n"
        "    except RuntimeError as exc:\n"
        "        assert \"device='cpu'\" in str(exc), exc\n"
        "    else:\n"
        "        raise SystemExit(name + ' ran without a CUDA device')\n"
        "res = api.partition(g, 4, device='cpu', config=cfg)\n"
        "assert res.feasible and res.assignment.shape == (g.n,)\n"
        "part = deep_mgp.partition(g, 4, cfg, device='cpu')\n"
        "assert np.array_equal(part, res.assignment)\n"
        "gain, tgt, own = gain_ops.lp_gain(g, lab, cw, 100.0, device='cpu')\n"
        "assert gain.shape == tgt.shape == own.shape == (g.n,)\n"
        "assert bsr_ops.spmm(g, x, device='cpu').shape == (g.n, 3)\n"
        "assert (eb_ops.embedding_bag(idx, tab, device='cpu') == 2).all()\n"
        "print('ok')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip().endswith("ok")


def test_modules_walked_include_the_unconstrained_tier_and_facade():
    mods = _modules()
    for m in ("repro_torch.core.unconstrained", "repro_torch.core.baselines",
              "repro_torch.api.session", "repro_torch.launch.partition"):
        assert m in mods


def test_modules_walked_include_the_serving_tier():
    mods = _modules()
    for m in ("repro_torch.serve", "repro_torch.serve.batching",
              "repro_torch.serve.server", "repro_torch.serve.queue",
              "repro_torch.serve.scheduler", "repro_torch.serve.metrics",
              "repro_torch.launch.serve"):
        assert m in mods


def test_partition_cli_without_cuda_exits_nonzero_unless_cpu_is_asked_for():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.partition",
           "--family", "rgg2d", "--n", "300", "--k", "2"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and out.stdout == ""
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[0])["feasible"]


def _assert_no_result(out):
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        assert '"ok"' not in line and '"kernels"' not in line


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    _assert_no_result(out)
    assert "CUDA" in out.stderr


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    _assert_no_result(out)
    assert "sources are not under" in out.stderr
