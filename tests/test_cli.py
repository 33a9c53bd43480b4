"""CLI benchmark/render/info smoke tests (subprocess, CPU backend)."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(*argv, cwd):
    env = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(cwd)}
    return subprocess.run(
        [sys.executable, "-m", "ntrace_tpu.cli", *argv],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=900,
    )


def test_info(tmp_path):
    r = _run("info", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "fermi_speculative_while_while" in r.stdout
    assert "conference" in r.stdout


def test_benchmark_writes_json(tmp_path):
    r = _run(
        "benchmark", "--cpu", "--mesh=conference@2000", "--mode=primary",
        "--width=48", "--height=32", "--builder=lbvh",
        "--warmup-repeats=0", "--measure-repeats=1",
        f"--results-dir={tmp_path}/results", cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    files = list((tmp_path / "results").glob("bench_*.json"))
    assert len(files) == 1
    data = json.loads(files[0].read_text())
    assert data[0]["mode"] == "primary"
    assert data[0]["tris"] > 1000
    assert "mrays_primary" in data[0]
    assert data[0]["mrays_primary"] > 0


def test_render_writes_png(tmp_path):
    out = tmp_path / "f.png"
    r = _run(
        "render", "--cpu", "--mesh=two_quads", "--mode=primary",
        "--width=32", "--height=24", f"--out={out}", cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    assert out.exists() and out.stat().st_size > 50  # tiny flat PNG ~100B


def test_unknown_kernel_errors(tmp_path):
    r = _run(
        "benchmark", "--cpu", "--mesh=two_quads", "--kernel=nope",
        cwd=tmp_path,
    )
    assert r.returncode != 0
    assert "unknown kernel" in (r.stderr + r.stdout)


def test_auto_engine_unified(monkeypatch):
    """'auto' resolves through ONE path (device.default_engine): the ww
    kernel on a GPU backend, stack2 elsewhere; kd accels trace as their
    cell-box FlatBVH unless the kd engine is named (the CLI and bench.py
    must select the same engine)."""
    import jax

    from ntrace_tpu.core import BuildConfig, RenderConfig
    from ntrace_tpu.render.renderer import Renderer
    from ntrace_tpu.scenes import make_random_soup
    from ntrace_tpu.trace.registry import resolve_kernel

    # The registry leaves auto to the renderer.
    assert resolve_kernel("auto").engine == "auto"

    scene = make_random_soup(n_tris=300, seed=3)
    r = Renderer(scene, BuildConfig(builder="binned_sah"),
                 RenderConfig(width=8, height=8, engine="auto"))
    assert r.engine == "stack2"

    # GPU backend: auto picks the kernel (constructing the tracer does
    # not compile it).
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    r = Renderer(scene, BuildConfig(builder="binned_sah"),
                 RenderConfig(width=8, height=8, engine="auto"))
    assert r.engine == "ww"
    # kd accel under auto on a GPU: the kernel over the kd CELL-box
    # FlatBVH view (kd_to_flatbvh), never the raw-kd-layout misread.
    from ntrace_tpu.bvh.flatten import FlatBVH

    r = Renderer(scene, BuildConfig(builder="kdtree"),
                 RenderConfig(width=8, height=8, engine="auto"))
    assert r.engine == "ww" and isinstance(r.flat, FlatBVH)
    assert hasattr(r, "flat_kd")
    # Explicit engine="kdtree" keeps the interval-stack reference engine.
    r = Renderer(scene, BuildConfig(builder="kdtree"),
                 RenderConfig(width=8, height=8, engine="kdtree"))
    assert r.engine == "kdtree"
