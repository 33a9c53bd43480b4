"""On-device LBVH builder: structural invariants + traversal vs brute force.

SURVEY.md SS5's LBVH property list: parent/child consistency, one root,
coverage partition, bounds containment -- plus the strongest check: golden
traversal of the flattened LBVH equals brute-force intersection.
"""

import numpy as np
import pytest

from ntrace_tpu.bvh.flatten import flat_children
from ntrace_tpu.bvh.golden import brute_force_mt
from ntrace_tpu.bvh.lbvh import build_lbvh_flat
from ntrace_tpu.core import BuildConfig
from ntrace_tpu.ops.woop import LEAF_END_BITS
from ntrace_tpu.scenes import get_scene, make_random_soup
from ntrace_tpu.trace.cpu import trace_cpu_golden
from tests.conftest import random_rays
from tests.test_bvh import assert_hits_match_brute


def _decode(flat):
    ch = flat_children(flat)
    m0x_bits = flat.woop[:, 0:1].view(np.int32)[:, 0]
    sent = m0x_bits == LEAF_END_BITS
    return ch, sent


class TestLBVHStructure:
    @pytest.mark.parametrize("n_tris,max_leaf", [(100, 1), (1000, 4), (5000, 8)])
    def test_invariants(self, n_tris, max_leaf):
        scene = make_random_soup(n_tris=n_tris, seed=13)
        flat = build_lbvh_flat(scene, BuildConfig(builder="lbvh", max_leaf_size=max_leaf))
        ch, sent = _decode(flat)
        n_nodes = flat.nodes.shape[0]

        inner = ch[ch >= 0]
        assert (inner < n_nodes).all() and (inner > 0).all(), "bad inner links"
        counts = np.bincount(inner, minlength=n_nodes)
        assert counts[0] == 0 and (counts[1:] == 1).all(), "not a tree"

        # Leaf offsets point at non-sentinel rows; runs cover all tris once.
        offs = ~ch[ch < 0]
        assert (offs < flat.woop.shape[0]).all()
        assert not sent[offs].any()
        ids = flat.tri_index[flat.tri_index >= 0]
        assert np.array_equal(np.sort(ids), np.arange(scene.num_tris))

        # Child bounds contain their leaf triangles.
        tv = scene.tri_verts()
        node_lo = np.stack([flat.nodes[:, [0, 2, 8]], flat.nodes[:, [4, 6, 10]]], 1)
        node_hi = np.stack([flat.nodes[:, [1, 3, 9]], flat.nodes[:, [5, 7, 11]]], 1)
        for i in range(min(n_nodes, 200)):
            for c in range(2):
                ref = ch[i, c]
                if ref < 0:
                    row = ~ref
                    tris = []
                    while not sent[row]:
                        tris.append(flat.tri_index[row])
                        row += 1
                    box_lo = tv[tris].min(axis=(0, 1))
                    box_hi = tv[tris].max(axis=(0, 1))
                    assert (box_lo >= node_lo[i, c] - 1e-4).all()
                    assert (box_hi <= node_hi[i, c] + 1e-4).all()

    def test_duplicate_positions(self):
        """Many tris at the same location (duplicate Morton codes)."""
        base = make_random_soup(n_tris=50, seed=3)
        v = np.concatenate([base.positions] + [base.positions[:30]] * 4)
        t = np.arange(v.shape[0] // 3 * 3, dtype=np.int32)[: (v.shape[0] // 3) * 3].reshape(-1, 3)
        from ntrace_tpu.core import Scene

        scene = Scene(v, t, name="dups")
        flat = build_lbvh_flat(scene, BuildConfig(builder="lbvh", max_leaf_size=2))
        ids = flat.tri_index[flat.tri_index >= 0]
        assert np.array_equal(np.sort(ids), np.arange(scene.num_tris))


class TestLBVHTraversal:
    @pytest.mark.parametrize("n_tris,max_leaf,seed", [
        (500, 1, 7), (500, 4, 7), (5000, 4, 11), (5000, 8, 11),
    ])
    def test_matches_brute_force(self, rng, n_tris, max_leaf, seed):
        scene = make_random_soup(n_tris=n_tris, seed=seed)
        flat = build_lbvh_flat(scene, BuildConfig(builder="lbvh", max_leaf_size=max_leaf))
        o, d, tmin, tmax = random_rays(rng, 1200)
        rec = trace_cpu_golden(flat, o, d, tmin, tmax)
        brute = brute_force_mt(scene, o, d, tmin, tmax)
        assert (rec.tri >= 0).mean() > 0.1
        assert_hits_match_brute(rec, brute, t_rtol=2e-4)

    def test_structured_scene(self, rng):
        scene = get_scene("conference", n_tris=6000)
        flat = build_lbvh_flat(scene, BuildConfig(builder="lbvh", max_leaf_size=4))
        o, d, tmin, tmax = random_rays(rng, 800, extent=9.0)
        rec = trace_cpu_golden(flat, o, d, tmin, tmax)
        brute = brute_force_mt(scene, o, d, tmin, tmax)
        assert_hits_match_brute(rec, brute, t_rtol=2e-4)


class TestHLBVH:
    @pytest.mark.parametrize("n_tris,max_leaf", [(2000, 4), (8000, 8)])
    def test_matches_brute_force(self, rng, n_tris, max_leaf):
        from ntrace_tpu.bvh.hlbvh import build_hlbvh_flat

        scene = make_random_soup(n_tris=n_tris, seed=23)
        flat = build_hlbvh_flat(
            scene, BuildConfig(builder="hlbvh", max_leaf_size=max_leaf)
        )
        o, d, tmin, tmax = random_rays(rng, 1200)
        rec = trace_cpu_golden(flat, o, d, tmin, tmax)
        brute = brute_force_mt(scene, o, d, tmin, tmax)
        assert (rec.tri >= 0).mean() > 0.1
        assert_hits_match_brute(rec, brute, t_rtol=2e-4)

    def test_structure_and_coverage(self):
        from ntrace_tpu.bvh.flatten import flat_children
        from ntrace_tpu.bvh.hlbvh import build_hlbvh_flat

        scene = get_scene("fairy", n_tris=5000)
        flat = build_hlbvh_flat(scene, BuildConfig(builder="hlbvh"))
        ch = flat_children(flat)
        n_nodes = flat.nodes.shape[0]
        inner = ch[ch >= 0]
        assert (inner < n_nodes).all() and (inner > 0).all()
        counts = np.bincount(inner, minlength=n_nodes)
        assert counts[0] == 0 and (counts[1:] == 1).all(), "not a tree"
        ids = flat.tri_index[flat.tri_index >= 0]
        assert np.array_equal(np.sort(ids), np.arange(scene.num_tris))

    def test_renders_identically_to_other_builders(self):
        from ntrace_tpu.core import RenderConfig
        from ntrace_tpu.render import render_frame

        scene = get_scene("conference", n_tris=4000)
        r_h = render_frame(scene, cfg=RenderConfig(width=48, height=32),
                           build_cfg=BuildConfig(builder="hlbvh"))
        r_m = render_frame(scene, cfg=RenderConfig(width=48, height=32),
                           build_cfg=BuildConfig(builder="median"))
        np.testing.assert_array_equal(r_h.hit_tri, r_m.hit_tri)

    def test_single_cluster_falls_back(self):
        """Tiny tight scene (one Morton cluster) must still build."""
        from ntrace_tpu.bvh.hlbvh import build_hlbvh_flat

        scene = make_random_soup(n_tris=50, seed=2, extent=0.001)
        flat = build_hlbvh_flat(scene, BuildConfig(builder="hlbvh"))
        ids = flat.tri_index[flat.tri_index >= 0]
        assert np.array_equal(np.sort(ids), np.arange(scene.num_tris))


def test_duplicate_code_clusters_fat_leaves_bounded_depth():
    """Duplicate-Morton-code clusters must become fat leaves, not
    index-order chains: a >128-deep chain silently overflows a 64-entry
    traversal stack (caught on full-conference LBVH)."""
    rng = np.random.default_rng(0)
    base = make_random_soup(n_tris=1000, seed=9)
    tv = base.tri_verts().copy()
    for k in range(5):
        tv[k * 120:(k + 1) * 120] = tv[k * 120]  # 120 identical tris x5
    pos = tv.reshape(-1, 3)
    idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
    from ntrace_tpu.core import Scene
    scene = Scene(positions=pos, indices=idx, name="dupes")
    flat = build_lbvh_flat(scene, BuildConfig(builder="lbvh", max_leaf_size=8))
    enc = np.ascontiguousarray(flat.nodes[:, 12:14]).view(np.int32)
    depth, stack = 0, [(0, 1)]
    while stack:
        nd, dp = stack.pop()
        depth = max(depth, dp)
        for c in enc[nd]:
            if c >= 0:
                stack.append((int(c), dp + 1))
    assert depth <= 64, f"duplicate chains leaked into the tree: depth {depth}"
    from ntrace_tpu.bvh.golden import brute_force_mt
    from ntrace_tpu.trace.cpu import trace_cpu_golden
    from tests.conftest import random_rays
    o, d, tn, tx = random_rays(np.random.default_rng(1), 256)
    rec = trace_cpu_golden(flat, o, d, tn, tx)
    ref = brute_force_mt(scene, o, d, tn, tx)
    np.testing.assert_array_equal(rec.tri, ref.tri)
