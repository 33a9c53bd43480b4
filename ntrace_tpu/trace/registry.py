"""Kernel registry: reference kernel names -> engines.

The reference selects a traversal kernel by compilation-unit name
(~ rt/cuda/CudaTracer.cpp loading rt/kernels/<name>.cu and reading its
KernelConfig). The rebuild keeps those names so reference benchmark scripts
translate directly. Each maps onto an engine of this repository:

  ww     (trace/ww_kernel.py)   per-ray while-while GPU kernel: the
                                reference's node loop + leaf loop, one
                                lane per ray, private 64-entry stack
  stack2 (trace/stack2_jax.py,  XLA lockstep step machine over chunks of
          trace/persistent.py)  rays in one dispatch; runs on any backend

The Fermi/Kepler variants' extra mechanisms -- speculative leaf
postponing, persistent warps with a global ray counter, dynamic refill of
dead lanes -- are not built yet; their names run the plain while-while
kernel.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class KernelSpec:
    engine: str
    note: str = ""


_WW = "per-ray while-while kernel (trace/ww_kernel.py)"

_REGISTRY = {
    # Reference kernel names:
    "tesla_persistent_while_while": KernelSpec("ww", _WW),
    "tesla_persistent_speculative_while_while": KernelSpec(
        "ww", _WW + "; leaf postponing not built"),
    "tesla_persistent_packet": KernelSpec("ww", _WW),
    "fermi_speculative_while_while": KernelSpec(
        "ww", _WW + "; leaf postponing not built"),
    "kepler_dynamic_fetch": KernelSpec(
        "ww", _WW + "; dead-lane refill not built, secondary rays are "
        "Morton-sorted with dead rays last instead (renderer "
        "sort_secondary)"),
    "fermi_kdtree_while_while": KernelSpec(
        "auto", "pair with --builder=kdtree: kd cells re-expressed as a "
        "cell-box BVH (bvh/kdtree.py kd_to_flatbvh); 'kdtree' names the "
        "interval-stack reference engine"),
    # Native names:
    "ww": KernelSpec("ww", _WW),
    "stack": KernelSpec("stack", "v1 two-table lockstep engine"),
    "stack2": KernelSpec("stack2", "unified-table lockstep engine"),
    "bvh8": KernelSpec("bvh8", "8-wide one-dispatch engine"),
    "kdtree": KernelSpec("kdtree", "interval-stack kd engine"),
    "cpu_golden": KernelSpec("cpu_golden", "host reference tracer"),
    # Resolved inside Renderer (device.default_engine): ww on a GPU,
    # stack2 elsewhere.
    "auto": KernelSpec("auto"),
}


def resolve_kernel(name: str) -> KernelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def kernel_names() -> list[str]:
    return sorted(_REGISTRY)
