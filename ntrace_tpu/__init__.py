"""ntrace-tpu: a ray tracing framework in JAX.

A from-scratch rebuild of the capabilities of marekvinkler/NTrace (the
Aila-Laine GPU ray traversal research framework plus Vinkler's kd-tree and
GPU-builder extensions) in JAX/XLA/Pallas, for NVIDIA GPUs.

Reference provenance: the reference mount (/root/reference) was empty during
the survey and build sessions; the blueprint is SURVEY.md and the binding
requirements list is BASELINE.json. Reference citations in docstrings use
"expected" upstream paths per SURVEY.md SS0 and cannot name line numbers.

Layer map (mirrors SURVEY.md SS2):
  core      -- Scene / Camera / configs      (ref: src/framework/3d, rt/Scene)
  ops       -- Morton, AABB, Woop, MT        (ref: base/Math.hpp, kernels/*.hpp)
  io        -- OBJ+MTL parser, npz cache,    (ref: src/framework/io)
               PNG out
  scenes    -- procedural stand-in scenes    (no OBJ assets exist offline)
  bvh       -- golden/median builders, SBVH, (ref: src/rt/bvh, rt/cuda/CudaBVH)
               device LBVH/HLBVH, flattener
  ray       -- RayBatch, raygen, pixel table (ref: src/rt/ray)
  trace     -- traversal engines, GPU kernel (ref: src/rt/kernels/*.cu)
  device    -- backend -> engine choice, compile cache
  render    -- frame orchestration, shading  (ref: src/rt/cuda/Renderer)
  parallel  -- multi-device ray sharding     (no reference equivalent)
  utils     -- timing, logging, caching      (ref: base/Timer)
"""

__version__ = "0.1.0"

from ntrace_tpu.core import Scene, Camera, BuildConfig, RenderConfig

__all__ = ["Scene", "Camera", "BuildConfig", "RenderConfig", "__version__"]
