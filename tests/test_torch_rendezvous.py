"""``css_tpu_torch.parallel.distributed_init``, the counterpart of
``css_tpu/parallel/mesh.py::distributed_init``, on the CPU: SLURM's hostlist
syntax, the order of the group's sources (an explicit coordinator, then
``COORDINATOR_ADDRESS``, then an ``srun`` job step), the no-op outside them
(as ``tests/test_multihost.py`` checks ``css_tpu``'s), the ``debug_nans``
switch, and two gloo processes that join through ``COORDINATOR_ADDRESS`` and
through simulated ``SLURM_*`` variables and all-reduce a tensor."""

import socket

import pytest
import torch

from css_tpu_torch import parallel
from css_tpu_torch.parallel import mesh
from tests import _torch_dist_worker as worker

SLURM_PORT0 = 65535 - 2**12 + 1          # JAX's SLURM detector: job id mod 4096 + this


@pytest.mark.parametrize("hostlist,hosts", [
    ("node7", ["node7"]),
    ("a,b", ["a", "b"]),
    ("node[0-3]", ["node0", "node1", "node2", "node3"]),
    ("node[01-03,7]", ["node01", "node02", "node03", "node7"]),
    ("gpu[098-101],login1", ["gpu098", "gpu099", "gpu100", "gpu101", "login1"]),
    ("r[1-2]-n[08-09]", ["r1-n08", "r1-n09", "r2-n08", "r2-n09"]),
    ("h1.example.org,h[9-10]", ["h1.example.org", "h9", "h10"]),
])
def test_expand_hostlist(hostlist, hosts):
    assert parallel.expand_hostlist(hostlist) == hosts


def test_expand_hostlist_refuses_a_bad_range():
    with pytest.raises(ValueError, match="bad range"):
        parallel.expand_hostlist("node[3-1]")


def _clear(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID",
                "SLURM_STEP_NODELIST", "SLURM_JOB_ID"):
        monkeypatch.delenv(var, raising=False)


def test_sources_in_order_and_no_op_outside_a_job_step(monkeypatch):
    calls = []
    monkeypatch.setattr(mesh, "_join", lambda *a: calls.append(a))
    _clear(monkeypatch)

    assert parallel.distributed_init(device_type="cpu") == torch.device("cpu")
    # a multi-task allocation without srun: no peers will come, no-op
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_JOB_ID", "4100")
    assert parallel.distributed_init(device_type="cpu") == torch.device("cpu")
    assert calls == []

    # an srun step: the first host of the step's nodes, the port from the job id
    monkeypatch.setenv("SLURM_STEP_NODELIST", "node[07-09],login")
    parallel.distributed_init(device_type="cpu")
    assert calls[-1] == ("gloo", torch.device("cpu"), 3, 8, f"tcp://node07:{SLURM_PORT0 + 4}",
                         mesh.DEFAULT_TIMEOUT_S)

    # COORDINATOR_ADDRESS before the step; rank and size still from SLURM
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    parallel.distributed_init(device_type="cpu")
    assert calls[-1][2:5] == (3, 8, "tcp://10.0.0.1:1234")

    # an explicit coordinator and ranks before both
    parallel.distributed_init("localhost:99", num_processes=2, process_id=1, device_type="cpu")
    assert calls[-1][2:5] == (1, 2, "tcp://localhost:99")
    assert len(calls) == 3

    _clear(monkeypatch)
    with pytest.raises(ValueError, match="num_processes and process_id"):
        parallel.distributed_init("localhost:99", device_type="cpu")


@pytest.mark.filterwarnings("ignore:Error detected in")    # anomaly mode's forward traceback
def test_debug_nans_turns_on_anomaly_detection_with_nan_checks():
    try:
        parallel.distributed_init(debug_nans=True, device_type="cpu")
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).backward()
    finally:
        torch.autograd.set_detect_anomaly(False)


def _free_port(lo=1024, hi=65535) -> int:
    for port in range(lo, hi + 1):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError(f"no free port in [{lo}, {hi}]")


def _two_processes(tmp_path, env):
    torch.multiprocessing.spawn(worker.rendezvous, args=(env, str(tmp_path)), nprocs=2,
                                join=True)
    return sorted((tmp_path / f"rank{r}.txt").read_text() for r in range(2))


def test_two_processes_join_through_coordinator_address(tmp_path):
    address = f"127.0.0.1:{_free_port(20000, 30000)}"
    env = [{"COORDINATOR_ADDRESS": address, "SLURM_NTASKS": "2", "SLURM_PROCID": str(r)}
           for r in range(2)]
    assert _two_processes(tmp_path, env) == ["0 2 3", "1 2 3"]


def test_two_processes_join_through_an_srun_step(tmp_path):
    job = _free_port(SLURM_PORT0) - SLURM_PORT0
    env = [{"SLURM_NTASKS": "2", "SLURM_PROCID": str(r), "SLURM_LOCALID": str(r),
            "SLURM_JOB_ID": str(job), "SLURM_STEP_NODELIST": "localhost,node[01-02]"}
           for r in range(2)]
    assert _two_processes(tmp_path, env) == ["0 2 3", "1 2 3"]
