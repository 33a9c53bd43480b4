"""HLBVH: SAH top-tree over Morton clusters + on-device LBVH bottoms.

Capability parity: the reference's HLBVH builder (expected rt/bvh/HLBVH/*;
Pantaleoni-Luebke 2010 / Garanzha-Pantaleoni-McAllister 2011 lineage;
mount empty -- SURVEY.md SS0/SS4.4): Morton codes + radix sort, treelets
from the TOP code bits, a SAH tree over the coarse clusters, fast
linear emission inside each treelet, bottom-up refit.

Composition here:
  1. bvh/lbvh.py's radix-trie sweep runs in FOREST mode on device
     (cluster_shift = 30 - hlbvh_top_bits): rows whose top Morton bits
     differ root independent treelet subtrees; the sweep reports each
     cluster's root in final child encoding.
  2. Cluster AABBs (segment min/max over the Morton-sorted triangle
     boxes) feed the host binned-SAH top builder with ONE cluster per
     leaf (bvh/sbvh.py build_sah_over_boxes).
  3. Splice: top-tree nodes come first (root stays node 0), bottom nodes
     follow with child indices shifted; top leaves are replaced by the
     cluster roots. The woop/tri_index arrays come straight from the
     device build (leaf runs are unaffected by the top).

Compared to plain LBVH, the SAH top fixes the Morton grid's worst
artifact: badly proportioned top-level splits on irregular scenes.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ntrace_tpu.bvh.flatten import FlatBVH
from ntrace_tpu.bvh.lbvh import build_lbvh_flat, lbvh_device
from ntrace_tpu.bvh.sbvh import build_sah_over_boxes
from ntrace_tpu.core import BuildConfig, Scene


def build_hlbvh_flat(scene: Scene, cfg: BuildConfig = BuildConfig()) -> FlatBVH:
    if scene.num_tris < 2:
        return build_lbvh_flat(scene, cfg)
    tv = scene.tri_verts()
    tlo = tv.min(axis=1)
    thi = tv.max(axis=1)
    lo, hi = scene.bbox()
    shift = max(30 - cfg.hlbvh_top_bits, 3)
    out = lbvh_device(
        jnp.asarray(tlo), jnp.asarray(thi), jnp.asarray(tv),
        jnp.asarray(lo), jnp.asarray(hi),
        max_leaf=cfg.max_leaf_size, cluster_shift=shift,
    )
    n_clusters = int(out["n_clusters"])
    node_count = int(out["node_count"])
    leaf_count = int(out["leaf_count"])
    if n_clusters < 2 or node_count == 0:
        # One cluster (or fully degenerate): plain LBVH covers it.
        return build_lbvh_flat(scene, cfg)

    order = np.asarray(out["order"])
    cluster_ids = np.asarray(out["cluster_ids"])
    croots = np.asarray(out["cluster_roots"])[:n_clusters]

    # Cluster AABBs: segment min/max over Morton-sorted triangle boxes.
    starts = np.flatnonzero(
        np.diff(np.concatenate([[-1], cluster_ids])) != 0
    )
    slo = tlo[order]
    shi = thi[order]
    clo = np.minimum.reduceat(slo, starts, axis=0)
    chi = np.maximum.reduceat(shi, starts, axis=0)

    # SAH top tree, one cluster per leaf. The splice below reads exactly
    # one cluster id per top leaf; a multi-box leaf (max_depth cutoff or
    # the non-finite-split fallback in the SAH builder) would silently
    # drop clusters, so fall back to the plain LBVH in that case.
    top = build_sah_over_boxes(clo, chi, cfg)
    if (top.leaf_count != 1).any():
        return build_lbvh_flat(scene, cfg)
    T = top.num_inner

    # Bottom nodes: shift internal child indices by T.
    bot = np.asarray(out["nodes"])[:node_count].copy()
    for lane in (12, 13):
        c = bot[:, lane:lane + 1].view(np.int32)
        c[c >= 0] += T

    # Top nodes in flat layout; leaves -> cluster roots.
    top_nodes = np.zeros((T, 16), dtype=np.float32)
    tl, th = top.child_lo, top.child_hi  # (T,2,3)
    top_nodes[:, 0], top_nodes[:, 1] = tl[:, 0, 0], th[:, 0, 0]
    top_nodes[:, 2], top_nodes[:, 3] = tl[:, 0, 1], th[:, 0, 1]
    top_nodes[:, 4], top_nodes[:, 5] = tl[:, 1, 0], th[:, 1, 0]
    top_nodes[:, 6], top_nodes[:, 7] = tl[:, 1, 1], th[:, 1, 1]
    top_nodes[:, 8], top_nodes[:, 9] = tl[:, 0, 2], th[:, 0, 2]
    top_nodes[:, 10], top_nodes[:, 11] = tl[:, 1, 2], th[:, 1, 2]
    enc = np.empty((T, 2), dtype=np.int32)
    for c in range(2):
        ref = top.child[:, c]
        is_leaf = ref < 0
        leaf_ids = np.where(is_leaf, ~ref, 0)
        cluster = top.tri_order[top.leaf_first[leaf_ids]]  # 1 box per leaf
        croot = croots[cluster]
        enc[:, c] = np.where(
            is_leaf,
            np.where(croot >= 0, croot + T, croot),
            ref,  # internal top child: top indices are final (offset 0)
        )
    top_nodes[:, 12] = enc[:, 0].view(np.float32)
    top_nodes[:, 13] = enc[:, 1].view(np.float32)

    nodes = np.concatenate([top_nodes, bot])
    w_used = scene.num_tris + leaf_count
    return FlatBVH(
        nodes=nodes,
        woop=np.asarray(out["woop"])[:w_used],
        tri_index=np.asarray(out["tri_index"])[:w_used],
        num_tris=scene.num_tris,
        sah_cost=0.0,
    )
