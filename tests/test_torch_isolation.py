"""repro_torch stands alone: importing it loads no JAX and nothing of the
JAX package, its entry points (the partition CLI among them) refuse to
run without a CUDA device unless ``device="cpu"`` is passed, and
``chip_smoke.py`` fails (printing no result) where there is no GPU or no
port beside it.

Each check runs in a fresh interpreter with CUDA hidden, so the test
process's own imports of JAX cannot mask a leak.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from torch_threads import child_env, one_thread  # noqa: F401

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


def _run(code: str, cwd=ROOT, timeout=300):
    env = child_env(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
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
        "  'dist': lambda: api.partition(g, 4, config=cfg, backend='dist'),\n"
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
        "dres = api.partition(g, 4, device='cpu', config=cfg,\n"
        "                     backend='dist')\n"
        "assert dres.feasible and dres.backend == 'dist'\n"
        "assert any(r['phase'] == 'dist-coarsen' for r in dres.trace)\n"
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
    env = child_env(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
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
    env = child_env(CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    _assert_no_result(out)
    assert "CUDA" in out.stderr


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = child_env(drop=("PYTHONPATH",), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    _assert_no_result(out)
    assert "sources are not under" in out.stderr


def test_modules_walked_include_the_distributed_engine():
    mods = _modules()
    for m in ("repro_torch.dist", "repro_torch.dist.collectives",
              "repro_torch.dist.dist_lp", "repro_torch.dist.dist_contraction",
              "repro_torch.dist.dist_balance",
              "repro_torch.dist.dist_partitioner",
              "repro_torch.graphs.distribute"):
        assert m in mods


def test_partition_cli_with_devices_refuses_without_cuda():
    """``--devices 2`` spawns a rank a card: without cards it exits 2 and
    prints nothing, unless ``--device cpu`` asks for CPU ranks."""
    env = child_env(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.partition",
           "--family", "rgg2d", "--n", "300", "--k", "2", "--devices", "2"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr


def test_modules_walked_include_the_fabric():
    mods = _modules()
    for m in ("repro_torch.fabric", "repro_torch.fabric.protocol",
              "repro_torch.fabric.registry", "repro_torch.fabric.autoscaler",
              "repro_torch.fabric.worker", "repro_torch.fabric.client",
              "repro_torch.fabric.frontdoor", "repro_torch.api.runtime",
              "repro_torch.launch.fabric"):
        assert m in mods


def test_fabric_worker_cli_refuses_without_cuda_and_dist():
    """The worker CLI runs on the card by default: without one it exits
    2 and prints no ready line, with meshes of one or two cards alike,
    and so does a worker that joins a group of several processes (before
    it joins)."""
    env = child_env(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.fabric", "worker"]
    for extra, text in (([], "no CUDA device"),
                        (["--devices-per-mesh", "2"], "no CUDA device"),
                        (["--coordinator", "h:1", "--num-processes", "2",
                          "--process-id", "0", "--devices-per-mesh", "2"],
                         "no CUDA device")):
        out = subprocess.run(cmd + extra, cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 2 and out.stdout == ""
        assert text in out.stderr


def test_modules_walked_include_the_fabric_group():
    mods = _modules()
    for m in ("repro_torch.api.group", "repro_torch.launch.fabric",
              "repro_torch.fabric.worker"):
        assert m in mods


def test_modules_walked_include_the_mesh_tier():
    mods = _modules()
    for m in ("repro_torch.launch.selftest", "repro_torch.api.runtime",
              "repro_torch.serve.server", "repro_torch.dist.dist_lp"):
        assert m in mods


def test_a_mesh_rank_loads_no_jax_and_no_reference():
    """The rank entry point (``api.runtime._mesh_rank``, spawned) and
    the engine it runs import nothing of JAX or the JAX package; a card
    mesh without a card raises before spawning anything."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import torch_dist_jobs\n"
        "from repro_torch.api import runtime\n"
        "from repro_torch.dist.dist_lp import make_mesh_1d\n"
        "from repro_torch.launch import selftest\n"
        "def main():\n"
        "    try:\n"
        "        make_mesh_1d(2)\n"
        "    except RuntimeError as exc:\n"
        "        assert \"device='cpu'\" in str(exc), exc\n"
        "    else:\n"
        "        raise SystemExit('a card mesh without cards')\n"
        "    with make_mesh_1d(2, 'cpu') as mesh:\n"
        "        rep = mesh.call(torch_dist_jobs.loaded_reference_modules)\n"
        "        out = mesh.call(selftest._rank_collectives,\n"
        "                        selftest.np.zeros((2, 2, 3), 'int32'))\n"
        "    assert rep.value == [], rep.value\n"
        "    assert out.value['direct'].shape == (2, 2, 3)\n"
        "    assert 'jax' not in sys.modules\n"
        "    print('ok')\n"
        "if __name__ == '__main__':\n"
        "    main()\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip().endswith("ok")


def test_modules_walked_include_the_models_and_placement():
    mods = _modules()
    for m in ("repro_torch.models", "repro_torch.models.common",
              "repro_torch.models.dlrm", "repro_torch.models.gnn",
              "repro_torch.models.gnn.common", "repro_torch.models.gnn.gat",
              "repro_torch.models.gnn.schnet",
              "repro_torch.models.gnn.nequip",
              "repro_torch.models.gnn.dimenet", "repro_torch.configs",
              "repro_torch.configs.gat_cora", "repro_torch.configs.schnet",
              "repro_torch.configs.nequip", "repro_torch.configs.dimenet",
              "repro_torch.configs.dlrm_rm2", "repro_torch.placement",
              "repro_torch.placement.gnn_placement",
              "repro_torch.placement.dlrm_placement",
              "repro_torch.placement.moe_placement",
              "repro_torch.dist.sharding", "repro_torch.launch.gnn_data"):
        assert m in mods


def test_model_and_placement_entry_points_raise_without_cuda():
    """The models' parameters and batches, the placements and the GNN
    batch builder run on the card unless ``device="cpu"`` is passed."""
    code = (
        "import numpy as np, torch\n"
        "from repro_torch import configs, carry\n"
        "from repro_torch.launch.gnn_data import build_gnn_batch\n"
        "from repro_torch.models import common\n"
        "from repro_torch.models.gnn import gat\n"
        "from repro_torch.placement import dlrm_placement, gnn_placement\n"
        "from repro_torch.placement import moe_placement\n"
        "from repro_torch.graphs import generators\n"
        "cfg = configs.get('gat-cora').smoke_config\n"
        "g = generators.make('rgg2d', 300, 8.0, seed=1)\n"
        "sparse = np.zeros((8, 4, 1), np.int64)\n"
        "top2 = np.random.default_rng(0).integers(0, 8, (200, 2))\n"
        "specs = gat.build_specs(cfg)\n"
        "gen = torch.Generator()\n"
        "calls = {\n"
        "  'init_params': lambda: common.init_params(specs, gen),\n"
        "  'gnn_batch': lambda: build_gnn_batch('gat-cora', cfg, n=50),\n"
        "  'gnn_plan': lambda: gnn_placement.plan(g, 4),\n"
        "  'dlrm_plan': lambda: dlrm_placement.plan(sparse,\n"
        "                                 np.ones(4, int) * 10, 2),\n"
        "  'moe_plan': lambda: moe_placement.plan(top2, 8, 2),\n"
        "  'carry': lambda: carry.dlrm_batch_from({'dense': np.ones(2)}),\n"
        "}\n"
        "for name, fn in calls.items():\n"
        "    try:\n"
        "        fn()\n"
        "    except RuntimeError as exc:\n"
        "        assert \"device='cpu'\" in str(exc), exc\n"
        "    else:\n"
        "        raise SystemExit(name + ' ran without a CUDA device')\n"
        "p = common.init_params(specs, gen, device='cpu')\n"
        "b = build_gnn_batch('gat-cora', cfg, n=50, device='cpu')\n"
        "assert gat.forward(p, b, cfg).shape == (b.n_node, cfg.n_classes)\n"
        "assert gnn_placement.plan(g, 4, device='cpu').offsets[-1] == g.n\n"
        "print('ok')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip().endswith("ok")


def test_modules_walked_include_the_transformer_and_lm_serving():
    mods = _modules()
    for m in ("repro_torch.models.transformer", "repro_torch.launch.serve_lm",
              "repro_torch.configs.qwen2_7b", "repro_torch.configs.gemma_2b",
              "repro_torch.configs.stablelm_12b",
              "repro_torch.configs.granite_moe_1b",
              "repro_torch.configs.arctic_480b"):
        assert m in mods


def test_serve_lm_cli_refuses_without_cuda_unless_cpu_is_asked_for():
    """The LM serving CLI runs on the card by default: without one it
    exits 2 and prints nothing; ``--device cpu`` serves on the CPU."""
    env = child_env(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch",
           "gemma-2b", "--config", "smoke", "--batch", "2", "--prompt-len",
           "3", "--gen-len", "4", "--max-len", "8"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1])["ok"]


def test_modules_walked_include_training():
    mods = _modules()
    for m in ("repro_torch.train", "repro_torch.train.optimizer",
              "repro_torch.train.trainer", "repro_torch.train.checkpoint",
              "repro_torch.train.data", "repro_torch.train.tree",
              "repro_torch.launch.train",
              "repro_torch.launch.gnn_partitioned_training"):
        assert m in mods


@pytest.mark.parametrize("cli", ["train", "gnn_partitioned_training"])
def test_training_clis_refuse_without_cuda(cli):
    """Both training CLIs run on the card by default: without one they
    exit 2 and print nothing (``--device cpu`` runs them: the test files
    of training drive both on the CPU)."""
    env = child_env(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", f"repro_torch.launch.{cli}"]
    if cli == "train":
        cmd += ["--arch", "gat-cora", "--steps", "2"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr


def test_modules_walked_include_the_launch_steps():
    mods = _modules()
    for m in ("repro_torch.launch.mesh", "repro_torch.launch.steps",
              "repro_torch.launch.dryrun", "repro_torch.dist.sharding"):
        assert m in mods


def test_dryrun_cli_refuses_without_cuda_unless_cpu_is_asked_for():
    """The dry-run makes fake CUDA tensors by default: without a card it
    exits 2 and prints nothing; ``--device cpu`` runs the cell."""
    env = child_env(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell",
           "dlrm-rm2/serve_p99", "--config", "smoke"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.splitlines()[-1])
    assert rec["arch"] == "dlrm-rm2" and rec["n_devices"] == 256
