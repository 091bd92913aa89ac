"""Contract smoke tests: bench.py must print one valid JSON line with the
required keys and the device it ran on, and the graft entry module must
expose the expected callables."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_bench_json_contract():
    env = dict(os.environ)
    env["BENCH_ITERS"] = "60000"
    env["JAX_PLATFORMS"] = "cpu"  # the explicit CPU rehearsal
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench.py")],
        capture_output=True, text=True, timeout=900, env=env, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    data = json.loads(line)
    for key in ("metric", "value", "unit", "device", "wall_s", "solar_sail"):
        assert key in data, data
    assert data["metric"] == "map iterations/sec"
    assert data["value"] > 0 and data["solar_sail"]["value"] > 0
    assert data["device"]["platform"] == "cpu" and data["device"]["count"] >= 1


def test_graft_entry_exposes_contract():
    import importlib.util

    spec = importlib.util.spec_from_file_location("ge", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.entry)
    assert callable(mod.dryrun_multichip)
