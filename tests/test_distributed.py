"""Multi-host integration: two real processes, one global CPU mesh.

Verifies SURVEY.md §5's distributed-backend equivalent end-to-end: each
process contributes 2 CPU devices, ``render_distributed`` shards lanes over
the global 4-device mesh, the collective merge runs over gloo, and the
replicated result matches a single-process render statistically (the
reference's merge-of-independent-renders argument, src/lib.rs:1037-1048).
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
from pathlib import Path

import pytest

_WORKER = r'''
import json, sys
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
pid = int(sys.argv[1])
port = sys.argv[2]

from strange_attractor_tpu.parallel import distributed as dist

dist.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
assert dist.process_count() == 2
assert jax.device_count() == 4

import numpy as np
from strange_attractor_tpu import presets, render

cfg = presets.poisson_saturne(
    width=64, height=36, iterations=60_000, lanes=128, chunk_steps=32, seed=9,
)
state = dist.render_distributed(cfg)
count = np.asarray(state.count)

if dist.is_primary():
    single = np.asarray(render(cfg).count)
    lit_d, lit_1 = count > 0, single > 0
    print("RESULT " + json.dumps({
        "total": int(count.sum()),
        "single_total": int(single.sum()),
        "iou": float((lit_d & lit_1).sum() / max(1, (lit_d | lit_1).sum())),
    }))
else:
    # every process holds a replicated copy of the merged canvas
    print("RESULT " + json.dumps({"total": int(count.sum())}))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(worker_src: str, extra_args, timeout: int = 600):
    """Launch two coordinator+worker processes; retry the whole bring-up on
    a port collision (the free-port probe closes the socket before the
    coordinator rebinds it — a TOCTOU race under parallel test runs)."""
    for _ in range(3):
        port = _free_port()
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", worker_src, str(i), str(port), *extra_args(i)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                cwd=str(Path(__file__).resolve().parent.parent),
            )
            for i in range(2)
        ]
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("distributed worker timed out")
            outs.append(out)
        if any(p.returncode != 0 and "Address already in use" in out
               for p, out in zip(procs, outs)):
            continue  # lost the port race; bring the pair up on a fresh port
        return procs, outs
    pytest.fail("coordinator port collided on 3 consecutive bring-ups")


def test_two_process_render():
    procs, outs = _run_workers(_WORKER, lambda i: [])

    results = {}
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        line = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert line, f"worker {i} produced no result:\n{out[-3000:]}"
        results[i] = json.loads(line[-1][len("RESULT "):])

    # both processes hold the same merged (replicated) canvas
    assert results[0]["total"] == results[1]["total"] > 0
    # statistically equivalent to a single-process render of the same budget
    assert abs(results[0]["total"] - results[0]["single_total"]) <= 0.05 * results[0]["single_total"]
    assert results[0]["iou"] > 0.6


_CLI_WORKER = r'''
import sys
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
pid, port, outdir = sys.argv[1], sys.argv[2], sys.argv[3]

from strange_attractor_tpu.cli import main

rc = main([
    "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
    "--process-id", pid,
    "-i", "40000", "-w", "48", "-h", "27", "--lanes", "64",
    "--chunk-steps", "32", "--seed", "5", "-8", "-q",
    "-o", f"{outdir}/dist",
])
print("RC", rc)
'''


def test_cli_distributed_two_processes(tmp_path):
    """`--coordinator` bring-up end-to-end: both processes render the
    collective program; only the primary writes the file."""
    outs = [tmp_path / "p0", tmp_path / "p1"]
    for d in outs:
        d.mkdir()
    procs, worker_outs = _run_workers(_CLI_WORKER, lambda i: [str(outs[i])])
    for i, (p, out) in enumerate(zip(procs, worker_outs)):
        assert p.returncode == 0 and "RC 0" in out, f"worker {i}:\n{out[-3000:]}"

    assert (outs[0] / "dist.png").exists(), "primary must write the image"
    assert not (outs[1] / "dist.png").exists(), "secondary must not write"


_CLI_SHARED_DIR_WORKER = r'''
import sys
import jax

jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
port = sys.argv[2]
outdir = sys.argv[3]

from strange_attractor_tpu.cli import main

rc = main([
    "-i", "30000", "-w", "48", "-h", "27", "--lanes", "64",
    "--chunk-steps", "16", "--seed", "3",
    "--distributed", "--coordinator", f"127.0.0.1:{port}",
    "--num-processes", "2", "--process-id", str(pid),
    "-o", outdir + "/frame",
])
print("RESULT " + str(rc))
'''


def test_two_process_cli_primary_only_writes(tmp_path):
    """The CLI under --distributed: both processes render the same global
    mesh, but only the primary writes the file (and prints 'Wrote image
    to') — two processes writing one path on shared storage corrupt it."""
    procs, outs = _run_workers(_CLI_SHARED_DIR_WORKER, lambda i: [str(tmp_path)])

    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert "RESULT 0" in out, f"worker {i} CLI rc != 0:\n{out[-3000:]}"

    assert (tmp_path / "frame.png").exists()
    wrote = ["Wrote image to" in out for out in outs]
    assert wrote == [True, False], f"primary-only write violated: {wrote}"
