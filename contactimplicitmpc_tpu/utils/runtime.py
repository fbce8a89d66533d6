"""Process set-up shared by the command-line programs (``bench.py``,
``chip_smoke.py``, ``tools/``): where the persistent XLA compile cache
lives, and which card the program runs on.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Mapping, Optional

import jax

# fixed path inside the checkout (listed in .gitignore): the cache key
# includes nothing of the path, but a directory that moves never hits
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(environ: Mapping[str, str] = os.environ
                      ) -> Optional[str]:
    """The compile-cache directory the program has to set itself, or
    None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads that
    variable on its own and the program sets no other)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(CHECKOUT_CACHE_DIR)


def enable_compile_cache(min_compile_time_secs: float = 5.0) -> str:
    """Turn on the persistent compile cache; returns the directory in
    effect."""
    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return jax.config.jax_compilation_cache_dir


def nvidia_smi_name_and_power_limit() -> str:
    """``name, power.limit`` of every visible card, one line each, as
    nvidia-smi prints them. Runs nvidia-smi as a child process (it never
    imports JAX, so it holds no device memory); raises if it fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
