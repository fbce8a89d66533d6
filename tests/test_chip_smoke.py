"""chip_smoke.py off the card: the device gate, the plain-reference
comparison (float32 against float64 on the CPU), and the compile-cache
location it shares with bench.py. The ``gpu`` test runs the reference
phase on a card when one is present."""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import pytest

import chip_smoke as cs
from contactimplicitmpc_tpu.utils.runtime import (CHECKOUT_CACHE_DIR,
                                                  compile_cache_dir)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_gate_refuses_cpu():
    """No GPU: non-zero exit, no ok line, and no phase (so no compile)
    started."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == "", proc.stdout
    assert "no GPU" in proc.stderr, proc.stderr


def test_reference_knots_f32_vs_f64():
    """The comparison chip_smoke makes on the card, here as CPU float32
    against CPU float64 on 3 gait knots: every error within its stated
    tolerance, every knot converged on both sides."""
    inputs = cs.reference_inputs(3)
    want = cs.knot_outputs(inputs, jnp.float64)
    got = cs.knot_outputs(inputs, jnp.float32)
    assert got["knot_z"].dtype == "float32"
    assert want["knot_z"].dtype == "float64"
    rows = cs.compare(got, want)
    assert [r[0] for r in rows] == ["knot_z", "knot_q2"]
    assert all(ok for *_, ok in rows), rows
    assert got["knot_converged"].all() and want["knot_converged"].all()


@pytest.mark.parametrize("environ, expect", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, None),
    ({}, str(CHECKOUT_CACHE_DIR)),
], ids=["env-set", "env-unset"])
def test_compile_cache_dir(environ, expect):
    """JAX_COMPILATION_CACHE_DIR wins (JAX reads it; nothing else is set);
    without it the cache is a fixed, git-ignored path in the checkout."""
    assert compile_cache_dir(environ) == expect
    if expect is not None:
        assert os.path.dirname(expect) == REPO
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


@pytest.mark.gpu
def test_reference_phase_on_gpu():
    """chip_smoke's reference phase on the card (f32 card vs f64 CPU)."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    probe = None
    if shutil.which("nvidia-smi"):
        probe = subprocess.run(
            [sys.executable, "-c",
             "import jax; print(jax.devices()[0].platform)"],
            env=env, capture_output=True, text=True, timeout=300)
    if probe is None or probe.stdout.strip() != "gpu":
        pytest.skip("no GPU present")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke as cs; "
         "sys.exit(1 if cs.phase_reference(cs.device_gate()) else 0)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stdout + proc.stderr
