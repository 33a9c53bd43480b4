"""Core host-side data types: Scene, Camera (+signature codec), configs.

Reference parity (SURVEY.md SS3.1; upstream paths expected, mount was empty):
  - Scene   ~ rt/Scene.{cpp,hpp} + framework/3d/Mesh.* : flat triangle/vertex
    arrays with per-triangle material ids that builders and tracers consume.
  - Camera  ~ framework/3d/CameraControls.* : position/orientation/fov plus
    encodeSignature()/decodeSignature() compact-string round-trip. The
    reference's exact signature bit format could not be recovered (empty
    mount), so this codec is a documented format of our own that round-trips
    losslessly; benchmark configs ship signatures produced by this codec.
  - BuildConfig ~ rt/bvh/Platform.hpp + BVH::BuildParams : SAH cost constants
    and leaf-size limits, kept numerically identical to the Aila-Laine
    defaults so tree quality is comparable.
"""

from __future__ import annotations

import base64
import dataclasses
import struct
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------


@dataclass
class Material:
    """Flat material record (~ framework/3d/Mesh.hpp MaterialHash entries)."""

    diffuse: tuple = (0.75, 0.75, 0.75)
    specular: tuple = (0.0, 0.0, 0.0)
    emissive: tuple = (0.0, 0.0, 0.0)
    glossiness: float = 0.0
    texture: str = ""  # map_Kd path (resolved relative to the OBJ)
    name: str = ""


@dataclass
class Scene:
    """Host-side triangle scene as flat numpy arrays.

    positions : (V, 3) float32 vertex positions
    indices   : (M, 3) int32 triangle vertex indices
    normals   : (V, 3) float32 per-vertex normals (optional; zeros if absent)
    mat_ids   : (M,) int32 material index per triangle
    materials : list[Material]
    name      : scene identifier used in caches and benchmark logs
    """

    positions: np.ndarray
    indices: np.ndarray
    normals: np.ndarray | None = None
    mat_ids: np.ndarray | None = None
    materials: list = field(default_factory=lambda: [Material()])
    name: str = "scene"
    uvs: np.ndarray | None = None  # (M, 3, 2) float32 per-corner texcoords

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions, dtype=np.float32)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.int32)
        if self.mat_ids is None:
            self.mat_ids = np.zeros((self.num_tris,), dtype=np.int32)
        else:
            self.mat_ids = np.ascontiguousarray(self.mat_ids, dtype=np.int32)
        if self.normals is not None:
            self.normals = np.ascontiguousarray(self.normals, dtype=np.float32)
        if self.uvs is not None:
            self.uvs = np.ascontiguousarray(self.uvs, dtype=np.float32)

    @property
    def num_tris(self) -> int:
        return int(self.indices.shape[0])

    @property
    def num_verts(self) -> int:
        return int(self.positions.shape[0])

    def tri_verts(self) -> np.ndarray:
        """(M, 3, 3) float32: the three vertices of every triangle."""
        return self.positions[self.indices]

    def bbox(self) -> tuple[np.ndarray, np.ndarray]:
        """Scene AABB (lo, hi), each (3,) float32."""
        v = self.positions
        return v.min(axis=0), v.max(axis=0)

    def centroids(self) -> np.ndarray:
        """(M, 3) float32 triangle centroids."""
        t = self.tri_verts()
        return t.mean(axis=1).astype(np.float32)

    def geometric_normals(self) -> np.ndarray:
        """(M, 3) float32 unnormalized geometric normals (cross(e1, e2))."""
        t = self.tri_verts()
        e1 = t[:, 1] - t[:, 0]
        e2 = t[:, 2] - t[:, 0]
        return np.cross(e1, e2).astype(np.float32)

    def validate(self) -> None:
        assert self.indices.min() >= 0 and self.indices.max() < self.num_verts
        assert self.mat_ids.shape == (self.num_tris,)
        assert np.isfinite(self.positions).all()


# ---------------------------------------------------------------------------
# Camera + signature codec
# ---------------------------------------------------------------------------

_SIG_MAGIC = b"NTC1"  # ntrace-tpu camera signature, version 1
_SIG_FMT = "<4s3f3f3f3f"  # magic, pos, forward, up, (fov, znear, zfar)


@dataclass
class Camera:
    """Pinhole camera (~ framework/3d/CameraControls.*).

    position : (3,) world position
    forward  : (3,) unit view direction
    up       : (3,) unit up vector (orthogonalized at raygen)
    fov_deg  : vertical field of view in degrees
    znear/zfar : clip range; primary rays get tmin=znear-ish, tmax=zfar
    """

    position: np.ndarray
    forward: np.ndarray
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    fov_deg: float = 60.0
    znear: float = 1e-3
    zfar: float = 1e8

    def __post_init__(self):
        self.position = np.asarray(self.position, dtype=np.float32)
        f = np.asarray(self.forward, dtype=np.float64)
        self.forward = (f / np.linalg.norm(f)).astype(np.float32)
        u = np.asarray(self.up, dtype=np.float64)
        self.up = (u / np.linalg.norm(u)).astype(np.float32)

    def basis(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Orthonormal (right, true_up, forward), float32."""
        f = self.forward.astype(np.float64)
        r = np.cross(f, self.up.astype(np.float64))
        rn = np.linalg.norm(r)
        if rn < 1e-12:  # forward ~ parallel to up: pick arbitrary right
            r = np.cross(f, np.array([1.0, 0.0, 0.0]))
            rn = np.linalg.norm(r)
        r = r / rn
        u = np.cross(r, f)
        return r.astype(np.float32), u.astype(np.float32), f.astype(np.float32)

    def encode_signature(self) -> str:
        """Compact, lossless camera string (~ CameraControls::encodeSignature).

        Format (ours; see module docstring on why it is not bit-identical to
        the reference): base64(struct '<4s3f3f3f3f') with urlsafe alphabet and
        padding stripped.
        """
        raw = struct.pack(
            _SIG_FMT,
            _SIG_MAGIC,
            *[float(x) for x in self.position],
            *[float(x) for x in self.forward],
            *[float(x) for x in self.up],
            float(self.fov_deg),
            float(self.znear),
            float(self.zfar),
        )
        return base64.urlsafe_b64encode(raw).decode("ascii").rstrip("=")

    @staticmethod
    def decode_signature(sig: str) -> "Camera":
        pad = "=" * (-len(sig) % 4)
        raw = base64.urlsafe_b64decode(sig + pad)
        vals = struct.unpack(_SIG_FMT, raw)
        if vals[0] != _SIG_MAGIC:
            raise ValueError(f"bad camera signature magic: {vals[0]!r}")
        v = vals[1:]
        return Camera(
            position=np.array(v[0:3], dtype=np.float32),
            forward=np.array(v[3:6], dtype=np.float32),
            up=np.array(v[6:9], dtype=np.float32),
            fov_deg=v[9],
            znear=v[10],
            zfar=v[11],
        )


# ---------------------------------------------------------------------------
# Build / render configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BuildConfig:
    """Acceleration-structure build parameters.

    SAH constants mirror the Aila-Laine Platform defaults (rt/bvh/Platform.hpp,
    expected): sah_node_cost=1.0, sah_tri_cost=1.0, leaf sizes [1, 0x7FFFFFF],
    and the SBVH spatial-split gate alpha=1e-5 (SplitBVHBuilder, Stich 2009).
    """

    builder: str = "median"  # median | binned_sah | sbvh | lbvh | hlbvh
    sah_node_cost: float = 1.0
    sah_tri_cost: float = 1.0
    min_leaf_size: int = 1
    max_leaf_size: int = 8
    max_depth: int = 64
    sbvh_alpha: float = 1.0e-5
    sbvh_unsplit: bool = True  # Stich 2009 reference unsplitting
    num_spatial_bins: int = 128
    num_object_bins: int = 32
    object_sweep: bool = False  # full-sweep SAH object splits (reference
    #                             SplitBVHBuilder exactness; binned is the
    #                             measured-equal fast default)
    morton_bits: int = 30  # 10 per axis, as in the reference HLBVH path
    hlbvh_top_bits: int = 9  # treelet split: top 3 bits per axis


@dataclass(frozen=True)
class RenderConfig:
    """Per-run render/benchmark parameters (~ rt/App.cpp benchmark flags)."""

    width: int = 1024
    height: int = 768
    mode: str = "primary"  # primary | shadow | ao | diffuse | path
    engine: str = "auto"  # auto | stack2 | ww | stack | bvh8 | kdtree |
    #                      cpu_golden; auto = ww on a GPU, stack2 elsewhere
    kernel: str = "auto"  # reference kernel-name compat; see trace/registry
    samples: int = 4  # AO/diffuse rays per hit (numSamples)
    ao_radius: float = 1.0
    sort_secondary: bool = True  # Morton re-sort of secondary rays
    max_batch_rays: int = 1 << 20  # in-flight ray cap per launch (~1-4M ref)
    seed: int = 0
    light: tuple = (0.0, 0.0, 0.0)  # point light for shadow mode
    bounces: int = 2  # for mode="path"
    tex_filter: str = "trilinear"  # nearest | bilinear | trilinear (mipmapped)
    interpret: bool = False  # run the ww kernel in the Pallas interpreter
    #                          (tests without a GPU); never chosen for you
    seed_primary: str = "off"  # "on": depth-prepass tmax seeding for
    #                            primary rays (exact; render/renderer.py
    #                            seeded_closest_trace)
    compact_rays: str = "auto"  # between-pass live-ray compaction: after
    #                            the secondary-ray Morton sort puts dead
    #                            rays last, trace only the live prefix
    #                            (render/renderer.py _compact_trace --
    #                            the reference's kepler_dynamic_fetch
    #                            capability at shape level).
    #                            "on" | "off" | "auto" (live < 3/4)
    seed_secondary: str = "off"  # "on": sparse-SUBSET geometry tmax
    #                            seeding for long closest-hit bounce rays
    #                            (diffuse/path): a 1/seed_subset triangle
    #                            subset's hits are true upper bounds on
    #                            each ray's closest t (exact;
    #                            render/renderer.py subset_seeded_trace)
    seed_subset: int = 16  # subset stride for seed_secondary
    stage_secondary: str = "off"  # "on": EXACT multi-interval
    #                            decomposition of long closest-hit bounces
    #                            (diffuse/path): near passes of length
    #                            stage_radii x scene_scale, then one pass
    #                            over the full interval for the rest
    #                            (render/renderer.py staged_closest_trace)
    stage_radii: tuple = (0.05,)  # near-interval lengths, as fractions of
    #                            scene scale, ascending; the full
    #                            interval is appended implicitly


def config_replace(cfg, **kw):
    """Dataclass replace that works for frozen configs."""
    return dataclasses.replace(cfg, **kw)
