"""The port's ranks: ``parallel/launch.py`` (local spawn, fail-fast, the
CLI, cluster mode), ``parallel/distributed.py`` on gloo, the Schur
solver split over 2 ranks against 1 rank (tests/torch_schur_worker.py),
its all-reduces per inner iteration against the JAX package's collective
census (benchmarks/results/r05/collective_census.json: 12 lowered for
``weakscale_like_d16_linear_cc``, 15 for ``general_coupled_adaptive``,
16 for ``general_coupled_lbfgs``),
the batch-axis fleet at 2 ranks against 1 (cold and warm-started), the
three new examples, and
that no module of the port imports JAX.  Every multi-rank run goes
through the launcher's fail-fast with a timeout, so a hung collective
fails a test instead of stalling the suite."""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyipm_tpu_torch.parallel import distributed as dist  # noqa: E402
from pyipm_tpu_torch.parallel import launch as L  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WORKER = str(REPO / "tests" / "torch_schur_worker.py")
FLEET = str(REPO / "pyipm_tpu_torch" / "examples" / "distributed_fleet.py")


@pytest.fixture
def _clean_env():
    keys = (L.ENV_COORD, L.ENV_NPROC, L.ENV_PROC_ID)
    saved = {k: os.environ.get(k) for k in keys}
    cwd = os.getcwd()
    os.chdir(REPO)                  # the launcher puts its cwd on the path
    yield
    os.chdir(cwd)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _spawn(n, argv, timeout=240):
    return L.spawn_local(n, argv, timeout=timeout)


@pytest.fixture(scope="module")
def ranks_runs(tmp_path_factory):
    """The worker at world size 1 (in this process) and 2 (two ranks
    through the launcher)."""
    import torch_schur_worker
    tmp = tmp_path_factory.mktemp("ranks")
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        out = {}
        for n in (1, 2):
            path = str(tmp / f"ws{n}.npz")
            if n == 1:
                torch_schur_worker.main([path])
            else:
                assert _spawn(n, [WORKER, path]) == 0
            with np.load(path) as f:
                out[n] = dict(f)
        return out
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("case", ["separable", "general", "lbfgs"])
def test_two_ranks_match_one(ranks_runs, case):
    one, two = ranks_runs[1], ranks_runs[2]
    assert int(two[case + "_sig"]) == int(one[case + "_sig"]) == 1
    assert int(two[case + "_it"]) == int(one[case + "_it"])
    x1, x2 = one[case + "_x"], two[case + "_x"]
    assert np.max(np.abs(x2 - x1)) <= 1e-10 * max(1.0, np.abs(x1).max())


@pytest.mark.parametrize("case,census_name", [
    ("linear_cc", "weakscale_like_d16_linear_cc"),
    ("coupled", "general_coupled_adaptive"),
    ("lbfgs", "general_coupled_lbfgs")])
def test_all_reduces_per_iteration_within_the_census(ranks_runs, case,
                                                     census_name):
    rows = json.loads((REPO / "benchmarks" / "results" / "r05"
                       / "collective_census.json").read_text())["rows"]
    bound = {r["config"]: r["lowered"]["all_reduce"] for r in rows}
    assert bound[census_name] == {"linear_cc": 12, "coupled": 15,
                                  "lbfgs": 16}[case]
    for n in (1, 2):
        calls = int(ranks_runs[n][case + "_calls"])
        assert 0 < calls <= bound[census_name], (n, calls)
    assert int(ranks_runs[1][case + "_calls"]) == \
        int(ranks_runs[2][case + "_calls"])


def _fleet_held(ranks_runs, case):
    one, two = ranks_runs[1], ranks_runs[2]
    assert np.all(np.isin(one[case + "_sig"], (1, 2)))
    for k in ("_sig", "_it", "_x"):
        np.testing.assert_array_equal(two[case + k], one[case + k])


def test_batch_axis_fleet_two_ranks_match_one(ranks_runs):
    """The batch-axis fleet of examples/distributed_fleet.py split over 2
    ranks equals 1 rank (test_distributed.py:58)."""
    _fleet_held(ranks_runs, "fleet")


def test_batch_axis_warm_starts_two_ranks_match_one(ranks_runs):
    """The same with per-instance (B,) mu0 and nu0, split with the
    batch."""
    _fleet_held(ranks_runs, "warm")


# ----------------------------------------------------------------------
# the launcher (test_launch.py:31-66)
def test_spawn_local_two_workers(ranks_runs):
    # the fixture's two-rank launch: both ranks joined, all-reduced and
    # exited 0
    assert int(ranks_runs[2]["world_size"]) == 2
    assert int(ranks_runs[1]["world_size"]) == 1


def test_spawn_local_fail_fast(_clean_env):
    # rank 1 exits 3 before joining: the job fails with that code instead
    # of leaving rank 0 waiting in the rendezvous
    assert _spawn(2, [WORKER, "-", "--fail-rank", "1"], timeout=120) == 3


def test_cli_validation():
    with pytest.raises(SystemExit):
        L.main(["--spawn", "2", "--coordinator", "x:1", "w.py"])
    with pytest.raises(SystemExit):
        L.main(["--coordinator", "x:1", "w.py"])    # missing rank / size


def test_cluster_mode_sets_env_and_execs(tmp_path, _clean_env):
    script = tmp_path / "probe.py"
    out = tmp_path / "probe.txt"
    script.write_text(
        "import os, sys\n"
        "from pyipm_tpu_torch.parallel.launch import ENV_COORD, ENV_NPROC,"
        " ENV_PROC_ID\n"
        f"open({str(out)!r}, 'w').write(' '.join([os.environ[ENV_COORD], "
        "os.environ[ENV_NPROC], os.environ[ENV_PROC_ID]] + sys.argv[1:]))\n")
    assert L.main(["--coordinator", "h0:1234", "--num-processes", "3",
                   "--process-id", "2", str(script), "a", "b"]) == 0
    assert out.read_text() == "h0:1234 3 2 a b"


def test_initialize_resolution(monkeypatch):
    """Explicit arguments, then the launcher's block (incomplete: an
    error), then one process; the backend follows the device."""
    for k in (L.ENV_COORD, L.ENV_NPROC, L.ENV_PROC_ID):
        monkeypatch.delenv(k, raising=False)
    assert dist.initialize(device="cpu") is False       # one process
    assert dist.world_size() == 1 and dist.host_local_slice(6) == slice(0, 6)
    monkeypatch.setenv(L.ENV_COORD, "localhost:1")
    with pytest.raises(RuntimeError, match="incomplete"):
        dist.initialize(device="cpu")
    with pytest.raises(ValueError):
        dist.initialize(num_processes=2, device="cpu")


# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["sharded_schur", "checkpoint_resume",
                                  "distributed_fleet"])
def test_examples_run_on_the_cpu(name, _clean_env):
    if name == "distributed_fleet":         # as its docstring runs it
        assert _spawn(2, [FLEET, "--device", "cpu"]) == 0
        return
    importlib.import_module(f"pyipm_tpu_torch.examples.{name}").main(
        device="cpu")


def test_no_module_of_the_port_imports_jax():
    code = ("import pkgutil, importlib, sys, pyipm_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "pyipm_tpu_torch.__path__, 'pyipm_tpu_torch.')]\n"
            "assert 'pyipm_tpu_torch.parallel.schur' in mods\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'pyipm_tpu'"
            " or m.startswith(('jax.', 'jaxlib', 'pyipm_tpu.'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
