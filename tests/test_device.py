"""ntrace_tpu/device.py: engine choice, compile cache, and a source scan
that keeps backend decisions in that one module."""

import re
from pathlib import Path

import jax
import pytest

from ntrace_tpu import device

ROOT = Path(__file__).resolve().parent.parent


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is used and no
    other is configured in code."""
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert device.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    """Unset: a fixed directory inside the checkout."""
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    path = device.enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


@pytest.mark.parametrize("backend,engine", [("gpu", "ww"),
                                            ("cpu", "stack2")])
def test_default_engine_by_backend(monkeypatch, backend, engine):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert device.default_engine() == engine
    if backend == "gpu":
        device.check_kernel_backend(False)
    else:
        with pytest.raises(RuntimeError):
            device.check_kernel_backend(False)
    device.check_kernel_backend(True)   # the interpreter runs anywhere


def _sources():
    files = [ROOT / "bench.py", ROOT / "chip_smoke.py",
             ROOT / "__graft_entry__.py"]
    files += sorted((ROOT / "ntrace_tpu").rglob("*.py"))
    files += sorted((ROOT / "tests").rglob("*.py"))
    return [f for f in files if f.exists() and f.name != "test_device.py"]


def test_no_foreign_kernels_or_backend_branches():
    """No Pallas import for another accelerator, no platform tuple, no on-chip memory budget,
    no file of device measurements, no interpret flag derived from the
    backend; only device.py asks which backend JAX runs on."""
    t_pu = "t" + "pu"   # spelled apart so this file does not match itself
    banned = [
        "pallas." + t_pu, "pl" + t_pu, "default_backend() " + "in (",
        "VMEM" + "_BUDGET", "tuned" + ".json",
    ]
    derived = re.compile(r"interpret\s*=\s*(jax\.)?default_backend")
    asked = "default_" + "backend()"
    for f in _sources():
        text = f.read_text()
        for b in banned:
            assert b not in text, f"{f.relative_to(ROOT)}: {b}"
        assert not derived.search(text), f"{f.relative_to(ROOT)}"
        if f.parent.name == "ntrace_tpu" and f.name == "device.py":
            continue
        if f.parts[-2] != "tests":
            assert asked not in text, f"{f.relative_to(ROOT)} asks the backend"
