"""The one place that asks which backend JAX runs on.

Engine choice: the per-ray while-while kernel (trace/ww_kernel.py) compiles
for CUDA GPUs only; everywhere else `auto` resolves to the XLA lockstep
engine `stack2`. The kernel runs off the GPU only in the Pallas interpreter,
and only when a caller asks for it with interpret=True.

Compile cache: JAX reads JAX_COMPILATION_CACHE_DIR itself when it is set.
Otherwise entry points call enable_compile_cache(), which keeps compiled
programs in `<checkout>/.jax_cache`, a fixed path so later runs hit it.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

KERNEL_ENGINE = "ww"
XLA_ENGINE = "stack2"

CHECKOUT = Path(__file__).resolve().parent.parent


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def default_engine() -> str:
    """What engine="auto" means on this backend."""
    return KERNEL_ENGINE if on_gpu() else XLA_ENGINE


def check_kernel_backend(interpret: bool) -> None:
    """Refuse to run the GPU kernel where it cannot compile."""
    if not interpret and not on_gpu():
        raise RuntimeError(
            f"engine {KERNEL_ENGINE!r} is a CUDA kernel and the JAX backend "
            f"is {jax.default_backend()!r}; run on a GPU, or pass "
            f"interpret=True to run it in the Pallas interpreter")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the cards of this host:
    a card below its top power limit runs slower under load, so every
    number taken on it is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
