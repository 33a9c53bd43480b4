"""Texture atlas: per-material images stacked into one device array.

Capability parity (~ framework/3d/Texture.* + TextureAtlas.*): the
reference packs textures into a mipmapped atlas for GPU shading. The
equivalent here is a (n_materials, S, S, 3) float32 stack (every image
resized to one resolution -- uniform shapes suit XLA), sampled with wrap addressing at three quality tiers:

  nearest   : 1 gather per ray (the round-1/2 sampler)
  bilinear  : 4 taps + lerp
  trilinear : mip pyramid flattened into one (M, P, 3) buffer (levels at
              static offsets -- one array, per-ray level
              arithmetic instead of ragged shapes), 8 taps across the two
              straddling levels. LOD comes from a ray-cone footprint:
              per-triangle texel density (uv area / world area) x hit
              distance x pixel cone angle (Igehy-class approximation).

Materials without a map_Kd get a 1x1 tile of their flat diffuse color, so
every sampler stays branch-free.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp


def build_atlas(materials, size: int = 256) -> np.ndarray:
    """(n_materials, size, size, 3) float32 linear-ish albedo atlas."""
    tiles = np.zeros((len(materials), size, size, 3), np.float32)
    for i, m in enumerate(materials):
        tex = getattr(m, "texture", "")
        loaded = False
        if tex:
            try:
                from PIL import Image

                img = Image.open(tex).convert("RGB").resize((size, size))
                tiles[i] = np.asarray(img, np.float32) / 255.0
                loaded = True
            except Exception:
                loaded = False
        if not loaded:
            tiles[i] = np.asarray(m.diffuse, np.float32)[None, None, :]
    return tiles


def sample_atlas(atlas, mat_ids, uv):
    """Nearest-neighbor wrap sampling.

    atlas  : (M, S, S, 3) device array
    mat_ids: (R,) int32; uv: (R, 2) float32 (v up, OBJ convention)
    Returns (R, 3) float32.
    """
    s = atlas.shape[1]
    u = uv[:, 0] - jnp.floor(uv[:, 0])
    v = uv[:, 1] - jnp.floor(uv[:, 1])
    x = jnp.clip((u * s).astype(jnp.int32), 0, s - 1)
    y = jnp.clip(((1.0 - v) * s).astype(jnp.int32), 0, s - 1)
    return atlas[mat_ids, y, x]


def interpolate_uv(scene_uvs, hit_tri, hit_u, hit_v):
    """Barycentric UV at a hit: (1-u-v)*uv0 + u*uv1 + v*uv2.

    scene_uvs: (M, 3, 2) device array; returns (R, 2).
    """
    tri = jnp.maximum(hit_tri, 0)
    c = scene_uvs[tri]  # (R, 3, 2)
    w0 = (1.0 - hit_u - hit_v)[:, None]
    return w0 * c[:, 0] + hit_u[:, None] * c[:, 1] + hit_v[:, None] * c[:, 2]


def build_mip_atlas(materials, size: int = 256):
    """Flattened mip pyramid: (M, P, 3) float32 + static level metadata.

    Level k has side size>>k (down to 1x1) built by 2x2 box filtering;
    level k's texels live at flat offset offs[k] + y*(size>>k) + x.
    Returns (flat (M, P, 3), offs tuple, sides tuple).
    """
    base = build_atlas(materials, size)
    levels = [base]
    while levels[-1].shape[1] > 1:
        a = levels[-1]
        levels.append(a.reshape(a.shape[0], a.shape[1] // 2, 2,
                                a.shape[2] // 2, 2, 3).mean(axis=(2, 4)))
    offs, sides = [], []
    p = 0
    for a in levels:
        offs.append(p)
        sides.append(a.shape[1])
        p += a.shape[1] * a.shape[2]
    flat = np.concatenate([a.reshape(a.shape[0], -1, 3) for a in levels],
                          axis=1)
    return flat, tuple(offs), tuple(sides)


def _bilinear_flat(flat, mat_ids, uv, side, off):
    """4-tap wrap bilinear at one mip level of the flattened pyramid."""
    s = side
    u = uv[:, 0] - jnp.floor(uv[:, 0])
    v = uv[:, 1] - jnp.floor(uv[:, 1])
    # Texel-center convention: sample point in texel space.
    x = u * s - 0.5
    y = (1.0 - v) * s - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    xi0 = jnp.mod(x0.astype(jnp.int32), s)
    yi0 = jnp.mod(y0.astype(jnp.int32), s)
    xi1 = jnp.mod(xi0 + 1, s)
    yi1 = jnp.mod(yi0 + 1, s)
    t00 = flat[mat_ids, off + yi0 * s + xi0]
    t10 = flat[mat_ids, off + yi0 * s + xi1]
    t01 = flat[mat_ids, off + yi1 * s + xi0]
    t11 = flat[mat_ids, off + yi1 * s + xi1]
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def sample_atlas_bilinear(flat, offs, sides, mat_ids, uv):
    """Wrap bilinear at the base mip level of a build_mip_atlas pyramid."""
    return _bilinear_flat(flat, mat_ids, uv, sides[0], offs[0])


def sample_atlas_trilinear(flat, offs, sides, mat_ids, uv, lod):
    """Mipmapped trilinear: bilinear at floor/ceil levels, lerped by the
    lod fraction. lod: (R,) float32, clamped to the pyramid."""
    L = len(sides)
    lod = jnp.clip(lod, 0.0, L - 1.0)
    k0 = jnp.floor(lod).astype(jnp.int32)
    frac = (lod - k0.astype(jnp.float32))[:, None]
    lo = jnp.zeros((uv.shape[0], 3), jnp.float32)
    hi = jnp.zeros((uv.shape[0], 3), jnp.float32)
    for k in range(L):
        # Static per-level sampling, masked per ray (uniform shapes; the
        # pyramid tail levels are tiny so the extra taps are cheap).
        sk = _bilinear_flat(flat, mat_ids, uv, sides[k], offs[k])
        lo = jnp.where((k0 == k)[:, None], sk, lo)
        hi = jnp.where((jnp.minimum(k0 + 1, L - 1) == k)[:, None], sk, hi)
    return lo * (1 - frac) + hi * frac


def tri_texel_density(uvs: np.ndarray, tri_verts: np.ndarray,
                      size: int) -> np.ndarray:
    """Per-triangle texels-per-world-unit (LOD source): sqrt(uv area /
    world area) * atlas side. Degenerate tris get density 0 (-> level 0)."""
    duv1 = uvs[:, 1] - uvs[:, 0]
    duv2 = uvs[:, 2] - uvs[:, 0]
    uv_area = np.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    e1 = tri_verts[:, 1] - tri_verts[:, 0]
    e2 = tri_verts[:, 2] - tri_verts[:, 0]
    w_area = np.linalg.norm(np.cross(e1, e2), axis=1)
    ok = w_area > 1e-20
    return (np.sqrt(np.where(ok, uv_area / np.where(ok, w_area, 1.0), 0.0))
            * size).astype(np.float32)


def cone_lod(density, hit_t, cos_theta, pixel_angle):
    """Ray-cone LOD: footprint = t * pixel_angle / |cos theta|; lod =
    log2(footprint * texel density)."""
    foot = hit_t * pixel_angle / jnp.maximum(jnp.abs(cos_theta), 0.1)
    return jnp.log2(jnp.maximum(foot * density, 1e-6))
