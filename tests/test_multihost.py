"""True multi-process validation: 2 jax.distributed processes x 4 virtual
CPU devices each solve one row-sharded system over 8 global devices with
Gloo collectives (the CPU stand-in for NCCL; SURVEY.md §4 multi-host
strategy).  Subprocess-based because jax.distributed is per-process."""

import pathlib
import socket
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


import pytest


@pytest.mark.parametrize("nproc", [2, 4])
def test_multi_process_rowsharded_solve(nproc):
    worker = REPO / "scripts" / "multihost_worker.py"
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), str(nproc), port],
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed: {err[-2000:]}"
        assert f"OK ({nproc} processes, {4 * nproc} devices)" in out
