"""SAH kd-tree builder + flattener (NTrace's headline addition).

Capability parity: NTrace extends the Aila-Laine framework with kd-trees
(expected rt/kdtree/NaiveKDTreeBuilder + FastKDTreeBuilder and
rt/cuda/CudaKDTree; Vinkler's papers; mount empty -- SURVEY.md SS0/SS3.2).
This is a from-scratch EXACT-SAH kd builder of the Wald-Havran quality
class: every candidate plane (clipped reference-AABB min/max events) on
all three axes is evaluated per node with exact left/right counts from
sorted event positions, empty-cell cut-offs get the classic lambda=0.8
bonus, and straddling references' boxes are clipped to their cells so
deeper SAH sees true extents. (The per-node-resort O(N log^2 N)
formulation rather than the O(N log N) maintained-event-list one: same
trees, simpler host code at our scene scales.) Emits a flattened layout
sharing the framework's unified-table conventions:

  node row (float32[16]):
    col 0      : split position (canonicalized away from -0.0)
    col 1      : bitcast int32 split axis (0/1/2)
    cols 12,13 : bitcast int32 children (below-split child first);
                 >=0 node row, <0 ~woopOffset leaf run
  leaf rows   : the SAME woop-record runs + 0x80000000 sentinels as the
                BVH layout (bvh/flatten.py), so leaf machinery is shared.

"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ntrace_tpu.bvh.flatten import _leaf_rows
from ntrace_tpu.core import BuildConfig, Scene
from ntrace_tpu.ops.woop import woopify


@dataclass
class FlatKDTree:
    nodes: np.ndarray      # (N, 16) float32
    woop: np.ndarray       # (W, 12) float32
    tri_index: np.ndarray  # (W,) int32
    root_lo: np.ndarray    # (3,) scene bounds (ray clip at entry)
    root_hi: np.ndarray
    num_tris: int = 0

    def nbytes(self) -> int:
        return self.nodes.nbytes + self.woop.nbytes + self.tri_index.nbytes


def build_kdtree(scene: Scene, cfg: BuildConfig = BuildConfig()) -> FlatKDTree:
    tv = scene.tri_verts().astype(np.float32)
    n = scene.num_tris
    ref_tri = np.arange(n, dtype=np.int32)
    ref_lo = tv.min(axis=1)
    ref_hi = tv.max(axis=1)
    root_lo = ref_lo.min(axis=0)
    root_hi = ref_hi.max(axis=0)

    # kd trees want deeper recursion and smaller leaves than BVHs.
    max_depth = min(cfg.max_depth, 24)
    max_leaf = max(cfg.max_leaf_size, 4)

    child_rows: list[list[int]] = []
    split_pos: list[float] = []
    split_axis: list[int] = []
    leaf_first: list[int] = []
    leaf_count: list[int] = []
    order_parts: list[np.ndarray] = []
    order_pos = 0

    tri_arr = [ref_tri]
    lo_arr = [ref_lo]
    hi_arr = [ref_hi]

    def make_leaf(idx) -> int:
        nonlocal order_pos
        tris = np.sort(np.unique(tri_arr[0][idx])).astype(np.int32)
        if len(tris) == 0:  # empty cell: a 0-tri leaf is illegal; emit a
            # single-poison-tri leaf is wasteful -- instead reuse any tri
            # id 0 with a poison woop record? Simplest: empty leaves carry
            # one sentinel-only run (count 0 handled by _leaf_rows? no).
            tris = np.array([0], np.int32)  # run exists; woop poisoned below
        leaf_first.append(order_pos)
        leaf_count.append(len(tris))
        order_parts.append(tris)
        order_pos += len(tris)
        return ~(len(leaf_first) - 1)

    empty_leaf_marks: list[int] = []

    EMPTY_BONUS = 0.8  # Wald-Havran lambda: discount cutting off empty space

    def exact_split(lo, hi, box_lo, box_hi):
        """Exact SAH over every candidate plane (clipped ref AABB min/max
        events, all 3 axes) -- the Wald-Havran quality class, in the
        per-node-resort O(N log^2 N) formulation. Returns
        (sah, axis, plane) or (inf, -1, 0)."""
        best = (np.inf, -1, 0.0)
        d = box_hi - box_lo
        for axis in range(3):
            if d[axis] <= 0:
                continue
            a1, a2 = (axis + 1) % 3, (axis + 2) % 3
            other = d[a1] * d[a2]
            peri = d[a1] + d[a2]
            area = 2.0 * (other + d[axis] * peri)
            starts = np.sort(lo[:, axis])
            ends = np.sort(hi[:, axis])
            planes = np.unique(np.concatenate([starts, ends]))
            planes = planes[(planes > box_lo[axis]) & (planes < box_hi[axis])]
            if not len(planes):
                continue
            # Nl(p) = refs starting strictly left of p; Nr(p) = refs ending
            # strictly right of p (planar-at-p refs sit in both -- the
            # standard conservative classification without the planar set).
            nl = np.searchsorted(starts, planes, side="left")
            nr = len(ends) - np.searchsorted(ends, planes, side="right")
            wl = planes - box_lo[axis]
            wr = box_hi[axis] - planes
            sah = (cfg.sah_node_cost
                   + cfg.sah_tri_cost * (nl * 2.0 * (other + wl * peri)
                                         + nr * 2.0 * (other + wr * peri))
                   / area)
            sah = np.where((nl == 0) | (nr == 0), sah * EMPTY_BONUS, sah)
            k = int(np.argmin(sah))
            if sah[k] < best[0]:
                best = (float(sah[k]), axis, float(planes[k]))
        return best

    def build(idx, box_lo, box_hi, lo, hi, depth) -> int:
        count = len(idx)
        if count == 0:
            leaf = make_leaf(idx)
            empty_leaf_marks.append(~leaf)
            return leaf
        if count <= max_leaf or depth >= max_depth:
            return make_leaf(idx)
        sah, axis, plane = exact_split(lo, hi, box_lo, box_hi)
        if axis < 0 or sah >= cfg.sah_tri_cost * count:
            return make_leaf(idx)

        go_l = lo[:, axis] < plane
        go_r = hi[:, axis] > plane
        on_plane = ~(go_l | go_r)  # degenerate refs exactly on the plane
        lsel = go_l | on_plane
        li = idx[lsel]
        ri = idx[go_r]
        # Clip straddling refs' boxes to their cells so deeper exact SAH
        # sees true (Wald-Havran "perfect split"-lite) extents.
        l_lo, l_hi = lo[lsel], hi[lsel].copy()
        l_hi[:, axis] = np.minimum(l_hi[:, axis], plane)
        r_lo, r_hi = lo[go_r].copy(), hi[go_r]
        r_lo[:, axis] = np.maximum(r_lo[:, axis], plane)
        node = len(child_rows)
        child_rows.append([0, 0])
        split_pos.append(plane)
        split_axis.append(axis)
        bl_hi = box_hi.copy(); bl_hi[axis] = plane
        br_lo = box_lo.copy(); br_lo[axis] = plane
        c0 = build(li, box_lo, bl_hi, l_lo, l_hi, depth + 1)
        c1 = build(ri, br_lo, box_hi, r_lo, r_hi, depth + 1)
        child_rows[node] = [c0, c1]
        return node

    import sys

    sys.setrecursionlimit(100000)
    root = build(np.arange(n, dtype=np.int64), root_lo.copy(), root_hi.copy(),
                 ref_lo, ref_hi, 0)

    if root < 0:  # whole scene one leaf: emit a trivial split node
        empty = make_leaf(np.array([], dtype=np.int64))
        empty_leaf_marks.append(~empty)
        child_rows.append([root, empty])
        split_pos.append(float(root_hi[0]))
        split_axis.append(0)

    # ---- flatten: node rows + shared leaf machinery ----------------------
    leaf_first_a = np.asarray(leaf_first, np.int32)
    leaf_count_a = np.asarray(leaf_count, np.int32)
    tri_order = np.concatenate(order_parts).astype(np.int32)
    ordered, dst_rows, sent_rows, w_total = _leaf_rows(
        leaf_first_a, leaf_count_a, tri_order
    )
    w = woopify(tv[ordered])
    w[:, 0] += np.float32(0.0)
    # Poison the runs of empty cells (their single placeholder tri must
    # never report a hit).
    woop = np.zeros((w_total, 12), np.float32)
    woop[dst_rows] = w
    sent = np.zeros((12,), np.float32)
    sent[0] = np.int32(-0x80000000).view(np.float32)
    woop[sent_rows] = sent
    tri_index = np.full((w_total,), -1, np.int32)
    tri_index[dst_rows] = ordered.astype(np.int32)
    counts = leaf_count_a.astype(np.int64)
    new_first = np.concatenate([[0], np.cumsum(counts + 1)[:-1]]).astype(np.int64)
    for leaf_id in empty_leaf_marks:
        row = int(new_first[leaf_id])
        woop[row] = 0.0
        woop[row, 7] = -1.0
        woop[row, 11] = -1.0
        tri_index[row] = -1

    nn = len(child_rows)
    nodes = np.zeros((nn, 16), np.float32)
    nodes[:, 0] = np.asarray(split_pos, np.float32)
    nodes[:, 0] += 0.0
    nodes[:, 1] = np.asarray(split_axis, np.int32).view(np.float32)
    ch = np.asarray(child_rows, np.int32)
    is_leaf = ch < 0
    leaf_ids = np.where(is_leaf, ~ch, 0)
    enc = np.where(is_leaf, ~(new_first[leaf_ids].astype(np.int32)), ch)
    nodes[:, 12] = enc[:, 0].astype(np.int32).view(np.float32)
    nodes[:, 13] = enc[:, 1].astype(np.int32).view(np.float32)

    return FlatKDTree(
        nodes=nodes, woop=woop, tri_index=tri_index,
        root_lo=root_lo, root_hi=root_hi, num_tris=n,
    )


def kd_to_flatbvh(kd: FlatKDTree):
    """Re-express a kd-tree as a FlatBVH of its CELL boxes.

    A kd cell is an axis-aligned box, so the kd hierarchy is exactly a BVH
    whose child "bounds" are the two half-cells at each split plane. In that
    form every BVH engine (the ww kernel under auto on a GPU) traverses it
    directly: the slab test against a cell box IS the kd interval clip
    ([cell entry, cell exit] intersected with [tmin, hitT]), near-first
    child ordering reproduces front-to-back descent,
    and the per-lane hitT clamp reproduces kd early exit (cells entirely
    beyond the current hit are culled). Leaf runs (woop rows + sentinels +
    duplicated straddling refs) are byte-identical between the two layouts,
    so they transfer verbatim.

    This replaces the reference's dedicated kd traversal kernels (expected
    fermi_kdtree_while_while, SURVEY.md SS3.3) with a reuse of the BVH
    engines; the interval-stack engine (trace/kdtree_jax.py) remains as
    the semantics reference.
    """
    from ntrace_tpu.bvh.flatten import FlatBVH

    kn = kd.nodes
    N = kn.shape[0]
    axis = np.ascontiguousarray(kn[:, 1]).view(np.int32)
    split = kn[:, 0]
    children = np.ascontiguousarray(kn[:, 12:14]).view(np.int32)  # (N, 2)

    lo = np.zeros((N, 3), np.float32)
    hi = np.zeros((N, 3), np.float32)
    lo[0], hi[0] = kd.root_lo, kd.root_hi
    out = np.zeros((N, 16), np.float32)
    out[:, 12:14] = children.view(np.float32).reshape(N, 2)

    frontier = np.array([0], np.int64)
    while len(frontier):
        ax = axis[frontier]
        sp = split[frontier]
        f = np.arange(len(frontier))
        c_lo = [lo[frontier].copy(), lo[frontier].copy()]
        c_hi = [hi[frontier].copy(), hi[frontier].copy()]
        c_hi[0][f, ax] = sp   # below-split child
        c_lo[1][f, ax] = sp   # above-split child
        # flatten.py lane order: c0 x/y in 0..3, c1 x/y in 4..7, z in 8..11.
        for s, (base_xy, base_z) in enumerate(((0, 8), (4, 10))):
            out[frontier, base_xy + 0] = c_lo[s][:, 0]
            out[frontier, base_xy + 1] = c_hi[s][:, 0]
            out[frontier, base_xy + 2] = c_lo[s][:, 1]
            out[frontier, base_xy + 3] = c_hi[s][:, 1]
            out[frontier, base_z + 0] = c_lo[s][:, 2]
            out[frontier, base_z + 1] = c_hi[s][:, 2]
        nxt = []
        for s in range(2):
            ch = children[frontier, s]
            m = ch >= 0
            if m.any():
                lo[ch[m]] = c_lo[s][m]
                hi[ch[m]] = c_hi[s][m]
                nxt.append(ch[m].astype(np.int64))
        frontier = np.concatenate(nxt) if nxt else np.empty(0, np.int64)

    return FlatBVH(nodes=out, woop=kd.woop, tri_index=kd.tri_index,
                   num_tris=kd.num_tris, sah_cost=0.0)
