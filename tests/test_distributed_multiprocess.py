"""Real multi-process jax.distributed execution (VERDICT r2 #4).

Spawns TWO actual Python processes that join one coordination service
(coordinator on localhost), build a global 8-device mesh (4 virtual CPU
devices per process), run ``sharded_remap_step`` on a globally-sharded
batch, and verify their addressable output shards against a
single-process reference. This executes the same code path a 2-host run
takes (docs/DISTRIBUTED.md), with the mesh spanning processes.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

WORKER = Path(__file__).with_name("distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_remap():
    port = _free_port()
    coordinator = f"localhost:{port}"

    env = dict(os.environ)
    # Fresh processes: drop the parent's 8-device flag so the worker's
    # own 4-device setting applies; keep the caller's PYTHONPATH.
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)

    procs = [
        subprocess.Popen(
            [
                sys.executable,
                str(WORKER),
                "--coordinator",
                coordinator,
                "--process-id",
                str(pid),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert "DISTRIBUTED_OK" in out, f"process {pid} output:\n{out}"
    # both processes addressed disjoint, non-empty shard sets
    assert "8 global" in outs[0] and "8 global" in outs[1]
