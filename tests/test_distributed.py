"""2-process distributed integration test (VERDICT r1 item #7).

Spawns two real OS processes, each with 4 virtual CPU devices, connected
through a localhost jax.distributed coordinator (gloo CPU collectives).
Exercises for real — not via the single-process degradation path —
process-spanning mesh construction (make_multihost_mesh), per-host ingest
assembly (assemble_global_rows / jax.make_array_from_process_local_data),
and one sharded search whose top-k merge collective crosses the process
boundary. The multichip dryrun stays as the device-count check; this is
the process-count check.
"""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_sharded_search():
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    # CPU-only workers with the repo importable; pin the platform to cpu
    pp = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([_REPO] + pp)
    env["JAX_PLATFORMS"] = "cpu"
    # the workers pin their own device count; scrub the pytest harness's
    # forced count so each worker gets exactly 4
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, coordinator, "2", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"OK-{pid}" in out, f"worker {pid} no OK marker:\n{out}"
