"""The port's CPU tests run one intra-op thread, in every process.

Six ``pytest -n 6`` workers on eight cores, each running torch's OpenMP
team at full width, spend their time waiting on each other
(``tests/torch_threads.py``). These tests hold the pin in place: every
``tests/test_torch_*.py`` imports the shared ``one_thread`` fixture,
every ``subprocess`` call of the port's tests and helpers takes its
``env=`` from ``child_env``, and the package itself sets no thread count
beyond the split of a host's threads among its CPU ranks. Also held here:
``held_port``, which keeps a coordinator's port from going to another
socket before the coordinator binds it.
"""
import ast
import datetime
import os
import socket
from pathlib import Path

import pytest
from torch_threads import child_env, one_thread  # noqa: F401

torch = pytest.importorskip("torch")

import torch_dist_jobs  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
PORT_TESTS = sorted(TESTS.glob("test_torch_*.py"))
PORT_HELPERS = sorted(TESTS.glob("torch_*.py"))
SPAWNERS = {"run", "Popen", "call", "check_call", "check_output"}


def _name(path: Path) -> str:
    return path.name


@pytest.mark.parametrize("path", PORT_TESTS, ids=_name)
def test_every_port_test_file_imports_the_thread_fixture(path):
    tree = ast.parse(path.read_text())
    imported = {a.asname or a.name for node in tree.body
                if isinstance(node, ast.ImportFrom)
                and node.module == "torch_threads" for a in node.names}
    assert "one_thread" in imported, (
        f"{path.name} does not import torch_threads.one_thread: its torch "
        "ops would run on every core beside the suite's other workers")
    assert not any(isinstance(node, ast.FunctionDef)
                   and node.name == "one_thread"
                   for node in ast.walk(tree)), (
        f"{path.name} shadows the shared one_thread fixture")


def _is_child_env(node) -> bool:
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Name) and node.func.id == "child_env"


def _bad_spawns(tree: ast.AST) -> list:
    """``(line, why)`` of each ``subprocess`` call in ``tree`` whose
    ``env=`` is missing or is not built by ``child_env`` (directly, or a
    name of the enclosing function bound only to ``child_env(...)``)."""
    bad = []
    scope_of = {}
    for scope in ast.walk(tree):
        if isinstance(scope, (ast.FunctionDef, ast.Module)):
            for n in ast.walk(scope):     # inner scopes come later: they win
                scope_of[n] = scope
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == "subprocess"
                and n.func.attr in SPAWNERS):
            continue
        env = [k.value for k in n.keywords if k.arg == "env"]
        if not env:
            bad.append((n.lineno, "no env="))
            continue
        if isinstance(env[0], ast.Name):
            bound = [a.value for a in ast.walk(scope_of[n])
                     if isinstance(a, ast.Assign)
                     and any(isinstance(t, ast.Name) and t.id == env[0].id
                             for t in a.targets)]
        else:
            bound = [env[0]]
        if not bound or not all(_is_child_env(v) for v in bound):
            bad.append((n.lineno, "env= not from child_env"))
    return bad


@pytest.mark.parametrize("path", PORT_TESTS + PORT_HELPERS, ids=_name)
def test_every_child_environment_comes_from_child_env(path):
    assert _bad_spawns(ast.parse(path.read_text())) == [], path.name


@pytest.mark.parametrize("code, bad", [
    ("import subprocess\nsubprocess.run(['x'])\n", [(2, "no env=")]),
    ("import os, subprocess\n"
     "def f():\n"
     "    env = dict(os.environ)\n"
     "    subprocess.Popen(['x'], env=env)\n",
     [(4, "env= not from child_env")]),
    ("import subprocess\n"
     "def f():\n"
     "    env = child_env(A='1')\n"
     "    env['B'] = '2'\n"
     "    subprocess.run(['x'], env=env)\n"
     "    subprocess.run(['x'], env=child_env())\n", []),
])
def test_the_spawn_check_finds_what_it_should(code, bad):
    assert _bad_spawns(ast.parse(code)) == bad


def test_the_fixture_pins_this_module_to_one_thread():
    assert torch.get_num_threads() == 1
    assert os.environ["OMP_NUM_THREADS"] == "1"


def test_child_env_sets_one_thread_and_keeps_the_rest(monkeypatch):
    monkeypatch.setenv("REPRO_TEST_KEEP", "kept")
    monkeypatch.setenv("OMP_NUM_THREADS", "8")
    env = child_env(drop=("REPRO_TEST_KEEP",), PYTHONPATH="src")
    assert env["OMP_NUM_THREADS"] == "1" and env["PYTHONPATH"] == "src"
    assert "REPRO_TEST_KEEP" not in env
    assert child_env()["REPRO_TEST_KEEP"] == "kept"
    assert os.environ["OMP_NUM_THREADS"] == "8"


def _thread_settings(path: Path) -> list:
    """``(function, call)`` of each thread-count setting in ``path``."""
    found = []
    for fn in ast.walk(ast.parse(path.read_text())):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for n in ast.walk(fn):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("set_num_threads",
                                        "set_num_interop_threads"):
                found.append((fn.name, n.func.attr))
            if isinstance(n, ast.Constant) and n.value == "OMP_NUM_THREADS":
                found.append((fn.name, "OMP_NUM_THREADS"))
    return found


def test_the_package_sets_no_thread_count_but_its_rank_split():
    """The pin lives in the tests: a user's process keeps torch's default.
    The package's only settings split a host's threads among its CPU
    ranks (a mesh's rank, a rank of the partition CLI)."""
    pkg = ROOT / "src" / "repro_torch"
    found = {str(p.relative_to(pkg)): _thread_settings(p)
             for p in sorted(pkg.rglob("*.py"))}
    found = {k: v for k, v in found.items() if v}
    assert found == {"api/runtime.py": [("_mesh_rank", "set_num_threads")],
                     "launch/partition.py": [("_rank", "set_num_threads")]}


def test_a_held_port_goes_to_the_coordinator_and_to_nothing_else():
    """While held, the port is handed to no ``bind`` to port 0 and to no
    outgoing connection; a coordinator's store binds and serves it."""
    with torch_dist_jobs.held_port() as port:
        with socket.socket() as lst:
            lst.bind(("127.0.0.1", 0))
            lst.listen(64)
            socks = []
            try:
                for _ in range(200):
                    for reuse in (0, 1):
                        s = socket.socket()
                        socks.append(s)
                        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR,
                                     reuse)
                        s.bind(("127.0.0.1", 0))
                        assert s.getsockname()[1] != port
                    c = socket.socket()
                    socks.append(c)
                    c.connect(lst.getsockname())
                    assert c.getsockname()[1] != port
                    socks.append(lst.accept()[0])
            finally:
                for s in socks:
                    s.close()
        timeout = datetime.timedelta(seconds=30)
        server = torch.distributed.TCPStore(
            "127.0.0.1", port, 2, True, timeout=timeout,
            wait_for_workers=False)
        client = torch.distributed.TCPStore("127.0.0.1", port, 2, False,
                                            timeout=timeout)
        client.set("k", "v")
        assert server.get("k") == b"v"
        del client, server
