"""REAL multi-controller (multi-process) verification of the engines.

Everything else in the suite runs a single process over 8 virtual devices;
SURVEY §5.8's actual claim is about *hosts*. These tests launch a genuine
2-process ``jax.distributed`` group over localhost (gloo collectives over
TCP — the same multi-controller runtime and cross-process collective code
path a multi-host job drives), 4 virtual CPU devices per process, and run
300 Lanczos iterations through each production multi-host engine:

- ``fullspace``: FullSpaceSharded — GSPMD rolls lower to collective-permutes
  that here actually cross process boundaries;
- ``halo``: EllShardedHalo — the shard_map static-halo all_to_all crosses
  processes.

Asserted: the group really formed (process_count == 2), both processes
agree on the replicated Lanczos scalars, and the tridiagonal ground energy
reproduces the L=16 Heisenberg-chain golden E0 = -7.142296361
(src/main_test.cc:88) to 5e-9 — through cross-process collectives.

The reference is single-node OpenMP only (SURVEY §2.2: no MPI); this is
capability it does not have, verified for real rather than on a virtual
mesh.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest

_E0_GOLDEN = -7.142296361
_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "mp_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_group(engine: str, L: int = 16, nproc: int = 2, timeout=420):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), str(nproc), str(port),
             engine, str(L)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for p, out in zip(procs, outs):
        lines = [l for l in out.splitlines() if l.startswith("MPRESULT ")]
        if p.returncode != 0 or not lines:
            pytest.fail(
                f"worker rc={p.returncode}, tail:\n" + "\n".join(
                    out.splitlines()[-15:]))
        results.append(json.loads(lines[-1][len("MPRESULT "):]))
    return results


_GOLDEN = {
    # chain engines: L=16 Heisenberg golden (src/main_test.cc:88)
    "fullspace": _E0_GOLDEN,
    "halo": _E0_GOLDEN,
    # flagship kron engine: Hubbard 4x2 golden
    # (examples/trans_absent/latt_square/square_Fermi_Hubbard.cc:113)
    "kron": -14.07605866,
}


@pytest.mark.parametrize("engine", ["fullspace", "halo", "kron"])
def test_two_process_group_golden_E0(engine):
    results = _run_group(engine)
    assert len(results) == 2
    for r in results:
        assert r["multi"] is True
        assert r["process_count"] == 2
        assert r["ndev"] == 8
        assert abs(r["E0"] - _GOLDEN[engine]) < 5e-9, r
    # replicated scalars must agree bit-for-bit across the two controllers
    assert results[0]["a0"] == results[1]["a0"]
    assert results[0]["b0"] == results[1]["b0"]
    assert results[0]["E0"] == results[1]["E0"]
