"""Two-process `jax.distributed` bootstrap smoke.

The virtual 8-device mesh exercises psort's collectives but not the
process-group bootstrap; this test launches two real OS processes that
`jax.distributed.initialize` against each other over the CPU backend (the
same code path `multihost.initialize` runs across GPU hosts: reference has
no distributed analogue, SURVEY.md §2), sort a globally-sharded array across
a 4-device mesh (2 procs x 2 devices), and verify shards bit-exactly.
"""

import os
import socket
import subprocess
import sys

_N = 1 << 14


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_psort():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "_multihost_worker.py")
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(pid), str(_N)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid}: ok" in out, out
