"""The float64 escape hatch, proven end-to-end (round-2 verdict item 7).

``Config.dtype="float64"`` needs ``jax_enable_x64``, which must be set
before JAX initializes and would contaminate the rest of the suite — so the
render runs in a subprocess. Inside, a short-horizon f64 render is compared
against the f64 numpy oracle: at this horizon a 1-ulp f64 arithmetic
difference cannot move a point across a pixel boundary, so visited-pixel
counts must agree essentially exactly (the f32 doctor check passes at ~98%;
f64 must do strictly better).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_WORKER = r'''
import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

import json
import numpy as np

from strange_attractor_tpu import presets
from strange_attractor_tpu.config import BinStrategy
from strange_attractor_tpu.oracle import oracle_render
from strange_attractor_tpu.render import plan_schedule, render, seed_key

cfg = presets.poisson_saturne(
    width=64, height=36, lanes=8, chunk_steps=24, iterations=8 * 24 * 2,
    warmup=100, seed=3, bin_strategy=BinStrategy.EXACT, dtype="float64",
)
key = seed_key(cfg)
lanes, chunk, nchunks = plan_schedule(cfg)
seeds = np.asarray(jax.random.uniform(key, (lanes, 3), dtype="float64") * 0.1)

st = render(cfg, key=key)
assert np.asarray(st.steps).dtype == np.float32  # planes stay f32 like the reference
oc, osteps, ozb = oracle_render(cfg, seeds, steps_per_lane=chunk * nchunks, dtype=np.float64)

count = np.asarray(st.count)
visited = (count > 0) | (oc > 0)
agree = float((count == oc)[visited].mean()) if visited.any() else 1.0
zb = np.asarray(st.zbuf)

# the sort-bin pipeline must also work under x64: identical trajectories
# => identical counts
st_k = render(cfg.replace(bin_strategy=BinStrategy.KERNEL), key=key)
kernel_counts_equal = bool((np.asarray(st_k.count) == count).all())

print("RESULT " + json.dumps({
    "agree": agree,
    "visited": int(visited.sum()),
    "zbuf_close": bool(np.allclose(zb, ozb, atol=1e-5)),
    "kernel_counts_equal": kernel_counts_equal,
}))
'''


def test_f64_render_matches_f64_oracle():
    proc = subprocess.run(
        [sys.executable, "-c", _WORKER],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")]
    assert line, proc.stdout[-2000:]
    res = json.loads(line[-1][len("RESULT "):])
    assert res["visited"] > 50, res
    assert res["agree"] >= 0.999, res
    assert res["zbuf_close"], res
    assert res["kernel_counts_equal"], res


def test_f64_requires_x64_flag():
    """Without jax_enable_x64 the dtype="float64" path must fail with the
    documented actionable error, not silently downcast."""
    import pytest

    from strange_attractor_tpu import presets
    from strange_attractor_tpu.render import render

    cfg = presets.poisson_saturne(
        width=16, height=9, lanes=8, chunk_steps=8, iterations=64, dtype="float64",
    )
    with pytest.raises(ValueError, match="jax_enable_x64"):
        render(cfg)
