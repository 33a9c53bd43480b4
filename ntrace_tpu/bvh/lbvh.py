"""LBVH: Morton-code BVH built ON DEVICE from sort/scan/scatter primitives.

Capability parity: the reference's GPU HLBVH/LBVH builders (expected
rt/bvh/HLBVH/*, Pantaleoni-Luebke 2010 / Garanzha 2011 / Karras 2012
lineage; mount empty -- SURVEY.md SS0): Morton codes from centroids, radix
sort, hierarchy emission, bottom-up AABB refit, woopify, same flattened
layout as the offline path.

Redesign (NOT the CUDA algorithm): Karras' per-node binary searches are
gather-bound, so hierarchy emission here is the RADIX-TRIE sweep: 30
passes over the bit planes of the sorted codes, where segment splits,
node allocation, and parent linking are pure elementwise ops + cumulative
scans + scatters.
Compressed-trie topology (chains collapse -- no single-child nodes) falls
out naturally because a segment only materializes a node at a level where
its current bit actually changes. Child AABBs come from a sparse-table
(log n shifted min/max passes) with exactly 2 small row-gathers per child
-- replacing the reference's atomic bottom-up refit.

Leaves: a segment stops splitting once it holds <= max_leaf_size tris (or
its Morton bits are exhausted -- duplicate-code clusters may exceed the
leaf limit, as in any Morton builder). Triangles inside a leaf are
contiguous in Morton order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ntrace_tpu.bvh.flatten import FlatBVH
from ntrace_tpu.core import BuildConfig, Scene
from ntrace_tpu.ops.morton import morton_codes_3d

_I32_MAX = np.int32(2**31 - 1)


def _mset(arr, idx, val, mask):
    """Masked scatter: arr[idx] = val where mask (others dropped).

    unique_indices is a real promise everywhere this is used: live target
    slots are distinct (cumsum-allocated or distinct rows), and the masked-
    off rows all collapse onto one out-of-bounds index that XLA drops
    before any collision handling.
    """
    oob = arr.shape[0]
    return arr.at[jnp.where(mask, idx, oob)].set(
        val, mode="drop", unique_indices=True)


def _device_woopify(tv):
    """f32 on-device Woop transform (closed-form adjugate; see ops/woop.py.

    The offline flattener inverts in f64 for sliver robustness; on-device
    rebuild-every-frame paths accept f32 (reference GPU builders are f32
    throughout)."""
    p0, p1, p2 = tv[:, 0], tv[:, 1], tv[:, 2]
    e1 = p1 - p0
    e2 = p2 - p0
    n = jnp.cross(e1, e2)
    det = jnp.sum(n * n, axis=1)
    ok = det != 0.0
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)[:, None]
    r0 = jnp.cross(e2, n) * inv_det
    r1 = jnp.cross(n, e1) * inv_det
    r2 = n * inv_det
    t0 = -jnp.sum(r0 * p0, axis=1)
    t1 = -jnp.sum(r1 * p0, axis=1)
    t2 = -jnp.sum(r2 * p0, axis=1)
    w = jnp.concatenate(
        [r2, (-t2)[:, None], r0, t0[:, None], r1, t1[:, None]], axis=1
    ).astype(jnp.float32)
    # Poison degenerates (never hit): m0=0, m1.w=m2.w=-1.
    poison = jnp.zeros((12,), jnp.float32).at[7].set(-1.0).at[11].set(-1.0)
    w = jnp.where(ok[:, None], w, poison[None, :])
    # m0.x must never alias the -0.0 leaf sentinel.
    return w.at[:, 0].set(w[:, 0] + 0.0)


@partial(jax.jit, static_argnames=("max_leaf", "cluster_shift"))
def lbvh_device(tri_lo, tri_hi, tri_verts, scene_lo, scene_hi, max_leaf=4,
                cluster_shift=0):
    """Build a flattened LBVH (or, for HLBVH, an LBVH FOREST) on device.

    tri_lo/tri_hi: (n,3) f32 triangle AABBs; tri_verts: (n,3,3) f32.
    cluster_shift=0: one tree rooted at node 0 (plain LBVH).
    cluster_shift=k>0: rows whose (code >> k) differ start independent
      root segments ("clusters", the HLBVH treelets); the per-cluster
      subtree roots are reported in cluster_roots (final child encoding:
      >=0 internal node index, <0 ~woopOffset leaf) for the host to
      splice under a SAH top tree (bvh/hlbvh.py).
    Returns dict of padded arrays:
      nodes (n-1, 16) f32, woop (2n, 12) f32, tri_index (2n,) i32,
      node_count, leaf_count, and forest metadata.
    Unused node/woop rows are zeros / sentinels and are unreferenced.
    """
    n = tri_lo.shape[0]
    cent = (tri_lo + tri_hi) * jnp.float32(0.5)
    codes = morton_codes_3d(jnp, cent, scene_lo, scene_hi)
    codes, order = jax.lax.sort((codes, jnp.arange(n, dtype=jnp.int32)), num_keys=1)

    iota = jnp.arange(n, dtype=jnp.int32)
    ncap = max(n - 1, 1)

    # --- radix-trie sweep state ---
    if cluster_shift > 0:
        top = codes >> cluster_shift
        prev_top = jnp.concatenate([top[:1] - 1, top[:-1]])
        boundary = top != prev_top  # row 0 always True (forced diff)
        ordinal = jnp.cumsum(boundary.astype(jnp.int32)) - 1
        parent_slot = jnp.where(boundary, -(ordinal + 2), -1)
    else:
        boundary = jnp.zeros((n,), jnp.bool_).at[0].set(True)
        ordinal = jnp.zeros((n,), jnp.int32)
        parent_slot = jnp.full((n,), -1, jnp.int32)  # at seg-start rows
    terminal = jnp.zeros((n,), jnp.bool_)  # at seg-start rows
    children = jnp.zeros((ncap, 2), jnp.int32)
    cluster_roots = jnp.zeros((n,), jnp.int32)
    rng_s = jnp.zeros((ncap,), jnp.int32)
    rng_p = jnp.zeros((ncap,), jnp.int32)
    rng_e = jnp.zeros((ncap,), jnp.int32)
    leaf_first = jnp.zeros((n,), jnp.int32)
    leaf_count = jnp.zeros((n,), jnp.int32)
    leaf_next0 = jnp.int32(0)

    if cluster_shift > 0:
        # Clusters already at or below the leaf limit become leaves now
        # (they would otherwise never be "created" by a split).
        bkey0 = jnp.where(boundary, iota, n)
        nb0 = jax.lax.cummin(
            jnp.concatenate([bkey0[1:], jnp.array([n], jnp.int32)]),
            axis=0, reverse=True,
        )
        cnt0 = nb0 - iota
        pre = boundary & (cnt0 <= max_leaf)
        psum = jnp.cumsum(pre.astype(jnp.int32))
        pidx = psum - 1
        leaf_first = _mset(leaf_first, pidx, iota, pre)
        leaf_count = _mset(leaf_count, pidx, cnt0, pre)
        terminal = _mset(terminal, iota, jnp.ones((n,), jnp.bool_), pre)
        cluster_roots = _mset(cluster_roots, ordinal, ~pidx, pre)
        leaf_next0 = psum[-1]

    def level(l, st):
        (boundary, terminal, parent_slot, children, cluster_roots,
         rng_s, rng_p, rng_e, leaf_first, leaf_count,
         node_next, leaf_next) = st
        bit = 29 - l
        bits = (codes >> bit) & 1
        prev_bits = jnp.concatenate([bits[:1], bits[:-1]])
        change = (bits != prev_bits) & (~boundary)
        change = change.at[0].set(False)

        # Next segment boundary after each row (position-key reverse cummin).
        bkey = jnp.where(boundary, iota, n)
        nb = jax.lax.cummin(
            jnp.concatenate([bkey[1:], jnp.array([n], jnp.int32)]),
            axis=0, reverse=True,
        )
        ckey = jnp.where(change, iota, n)
        fc = jax.lax.cummin(ckey, axis=0, reverse=True)

        seg = boundary & (~terminal)
        e = nb
        p = fc
        split = seg & (p < e)

        # Allocate internal nodes (one per splitting segment).
        alloc = split.astype(jnp.int32)
        node_idx = node_next + jnp.cumsum(alloc) - 1

        # Link to parent (or record a cluster root: ps <= -2 marks the
        # segment as cluster -(ps)-2's root-to-be in forest mode).
        ps = parent_slot
        has_parent = split & (ps >= 0)
        pr = jnp.where(has_parent, ps >> 1, ncap)
        pc = jnp.where(has_parent, ps & 1, 0)
        children = children.at[pr, pc].set(node_idx, mode="drop",
                                           unique_indices=True)
        is_marker = split & (ps <= -2)
        cluster_roots = _mset(cluster_roots, -ps - 2, node_idx, is_marker)

        rng_s = _mset(rng_s, node_idx, iota, split)
        rng_p = _mset(rng_p, node_idx, p, split)
        rng_e = _mset(rng_e, node_idx, e, split)

        left_n = p - iota           # left child tri count (valid at split rows)
        right_n = e - p
        lleaf = split & (left_n <= max_leaf)
        rleaf = split & (right_n <= max_leaf)

        lsum = jnp.cumsum(lleaf.astype(jnp.int32))
        lidx = leaf_next + lsum - 1
        rsum = jnp.cumsum(rleaf.astype(jnp.int32))
        ridx = leaf_next + lsum[-1] + rsum - 1

        leaf_first = _mset(leaf_first, lidx, iota, lleaf)
        leaf_count = _mset(leaf_count, lidx, left_n, lleaf)
        leaf_first = _mset(leaf_first, ridx, p, rleaf)
        leaf_count = _mset(leaf_count, ridx, right_n, rleaf)

        # Immediate leaf children links.
        children = _mset(
            children.reshape(-1), node_idx * 2, ~lidx, lleaf
        ).reshape(ncap, 2)
        children = _mset(
            children.reshape(-1), node_idx * 2 + 1, ~ridx, rleaf
        ).reshape(ncap, 2)

        # Non-leaf children become new segments awaiting their own split.
        parent_slot = _mset(parent_slot, iota, node_idx * 2, split & (~lleaf))
        parent_slot = _mset(parent_slot, p, node_idx * 2 + 1, split & (~rleaf))
        terminal = _mset(terminal, iota, jnp.ones((n,), jnp.bool_), lleaf)
        terminal = _mset(terminal, p, jnp.ones((n,), jnp.bool_), rleaf)
        # Right subsegment start becomes a boundary.
        boundary = _mset(boundary, p, jnp.ones((n,), jnp.bool_), split)

        node_next = node_next + alloc.sum()
        leaf_next = leaf_next + lsum[-1] + rsum[-1]
        return (boundary, terminal, parent_slot, children, cluster_roots,
                rng_s, rng_p, rng_e, leaf_first, leaf_count,
                node_next, leaf_next)

    st = (boundary, terminal, parent_slot, children, cluster_roots,
          rng_s, rng_p, rng_e, leaf_first, leaf_count,
          jnp.int32(0), leaf_next0)
    st = jax.lax.fori_loop(0, 30, level, st)
    (boundary, terminal, parent_slot, children, cluster_roots,
     rng_s, rng_p, rng_e, leaf_first, leaf_count, node_next, leaf_next) = st

    # Residual segments (duplicate codes / bits exhausted): force leaves.
    bkey = jnp.where(boundary, iota, n)
    nb = jax.lax.cummin(
        jnp.concatenate([bkey[1:], jnp.array([n], jnp.int32)]), axis=0,
        reverse=True,
    )
    resid_p = boundary & (~terminal) & (parent_slot >= 0)
    resid_m = boundary & (~terminal) & (parent_slot <= -2)
    resid = resid_p | resid_m
    rsum = jnp.cumsum(resid.astype(jnp.int32))
    ridx = leaf_next + rsum - 1
    leaf_first = _mset(leaf_first, ridx, iota, resid)
    leaf_count = _mset(leaf_count, ridx, nb - iota, resid)
    ps = parent_slot
    pr = jnp.where(resid_p, ps >> 1, ncap)
    pc = jnp.where(resid_p, ps & 1, 0)
    children = children.at[pr, pc].set(~ridx, mode="drop",
                                       unique_indices=True)
    cluster_roots = _mset(cluster_roots, -ps - 2, ~ridx, resid_m)
    leaf_next = leaf_next + rsum[-1]

    # --- bounds: sparse table over sorted tri AABBs ---------------------
    slo = tri_lo[order]
    shi = tri_hi[order]
    packed = jnp.concatenate([slo, -shi], axis=1)  # min-reduces both
    logn = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    tables = [packed]
    for k in range(1, logn + 1):
        half = 1 << (k - 1)
        prev = tables[-1]
        shifted = jnp.concatenate([prev[half:], jnp.full((half, 6), np.inf, jnp.float32)])
        tables.append(jnp.minimum(prev, shifted))
    table = jnp.stack(tables)  # (logn+1, n, 6)

    def range_bounds(a, b):
        """min/max over sorted rows [a, b) (b > a). Returns (lo(…,3), hi)."""
        length = b - a
        k = 31 - jax.lax.clz(jnp.maximum(length, 1))
        k = jnp.minimum(k, logn)
        flat = table.reshape(-1, 6)
        r1 = flat[k * n + a]
        r2 = flat[k * n + jnp.maximum(b - (1 << k), a)]
        m = jnp.minimum(r1, r2)
        return m[..., 0:3], -m[..., 3:6]

    lo0, hi0 = range_bounds(rng_s, rng_p)
    lo1, hi1 = range_bounds(rng_p, rng_e)

    # --- leaf woop offsets & final child encoding -----------------------
    leaf_id_full = jnp.arange(n, dtype=jnp.int32)
    is_leaf_slot = leaf_id_full < leaf_next
    # Rows (in sorted-tri space) that begin a leaf run:
    leaf_start_row = jnp.zeros((n,), jnp.bool_)
    leaf_start_row = _mset(leaf_start_row, leaf_first,
                           jnp.ones((n,), jnp.bool_), is_leaf_slot)
    # Every row belongs to exactly one contiguous leaf run; a row's woop
    # destination shifts right by one sentinel per COMPLETED earlier run.
    runs_incl = jnp.cumsum(leaf_start_row.astype(jnp.int32))  # starts <= i
    woop_off_leaf = leaf_first + runs_incl[leaf_first] - 1  # (n,) valid < leaf_next

    is_leaf_child = children < 0
    leaf_ids = jnp.where(is_leaf_child, ~children, 0)
    enc = jnp.where(is_leaf_child, ~woop_off_leaf[leaf_ids], children)

    # --- node records ----------------------------------------------------
    nodes = jnp.zeros((ncap, 16), jnp.float32)
    nodes = nodes.at[:, 0].set(lo0[:, 0]).at[:, 1].set(hi0[:, 0])
    nodes = nodes.at[:, 2].set(lo0[:, 1]).at[:, 3].set(hi0[:, 1])
    nodes = nodes.at[:, 4].set(lo1[:, 0]).at[:, 5].set(hi1[:, 0])
    nodes = nodes.at[:, 6].set(lo1[:, 1]).at[:, 7].set(hi1[:, 1])
    nodes = nodes.at[:, 8].set(lo0[:, 2]).at[:, 9].set(hi0[:, 2])
    nodes = nodes.at[:, 10].set(lo1[:, 2]).at[:, 11].set(hi1[:, 2])
    nodes = nodes.at[:, 12].set(jax.lax.bitcast_convert_type(enc[:, 0], jnp.float32))
    nodes = nodes.at[:, 13].set(jax.lax.bitcast_convert_type(enc[:, 1], jnp.float32))
    # Zero out unused node rows (beyond node_next) for hygiene.
    node_mask = (jnp.arange(ncap) < node_next)[:, None]
    nodes = jnp.where(node_mask, nodes, 0.0)

    # --- woop array in sorted-tri order with sentinel rows ---------------
    wcap = 2 * n
    w = _device_woopify(tri_verts[order])
    dst = iota + runs_incl - 1  # shift by #sentinels inserted before row i
    sent_val = jax.lax.bitcast_convert_type(jnp.int32(-0x80000000), jnp.float32)
    woop = jnp.zeros((wcap, 12), jnp.float32)
    woop = woop.at[dst].set(w, mode="drop", unique_indices=True)
    sent_rows = woop_off_leaf + leaf_count  # per leaf slot
    woop = woop.at[jnp.where(is_leaf_slot, sent_rows, wcap), 0].set(
        sent_val, mode="drop", unique_indices=True
    )
    tri_index = jnp.full((wcap,), -1, jnp.int32)
    tri_index = tri_index.at[dst].set(order.astype(jnp.int32), mode="drop",
                                      unique_indices=True)

    # Forest metadata: cluster roots in FINAL child encoding.
    cr_leaf = cluster_roots < 0
    cr_final = jnp.where(
        cr_leaf, ~woop_off_leaf[jnp.where(cr_leaf, ~cluster_roots, 0)],
        cluster_roots,
    )
    return dict(nodes=nodes, woop=woop, tri_index=tri_index,
                node_count=node_next, leaf_count=leaf_next,
                cluster_roots=cr_final, cluster_ids=ordinal, order=order,
                n_clusters=ordinal[-1] + 1)


@partial(jax.jit, static_argnames=("max_leaf", "_ablate"))
def lbvh_device_fast(tri_lo, tri_hi, tri_verts, scene_lo, scene_hi,
                     max_leaf=4, _ablate: str = "",
                     compact_cap: int | None = None):
    """Single-pass LBVH emission: the per-frame rebuild path.

    The 30-level radix sweep (lbvh_device above, kept for the HLBVH forest
    mode) is scatter-bound: ~12 full-array scatters per level. This
    builder emits the SAME class of tree (the Karras-2012 binary radix
    tree, viewed as a Cartesian tree over boundary split-levels) with a
    single pass of scans and exactly TWO full-array scatters:

      - delta[i] = common-prefix length of sorted codes (i-1, i); the tree
        over boundaries is the Cartesian tree of (delta, i) priorities.
      - parent/range/side per boundary come from all-nearest-smaller-
        values (ANSV), computed with two (31, n) 2-D scans -- one row per
        of the 31 possible delta values, cummax/cummin along rows -- plus
        a 31-way select chain. No per-node binary searches (gather-bound),
        no per-level scatters.
      - leaf pruning by range size (subtrees with <= max_leaf rows become
        leaves), record assembly, and child AABBs (lane-packed sparse
        range-min table) are elementwise + 3 row-gathers.
      - the only scatters: the kept-child -> parent-slot link, and the
        woop/tri-index row placement (gap rows pre-initialized to the
        0x80000000 leaf sentinel, so no separate sentinel scatter).

    Node records are emitted COMPACT: nodes has `compact_cap` rows (auto:
    ~n*3.2/(max_leaf+4)), the first node_count are valid, child links are
    final dense compact ids, and `root` is a compact id. If node_count
    exceeds the cap (spine-shaped radix trees), links past the cap were
    dropped -- the host wrapper detects this and retries with
    compact_cap=n, which is always sufficient. Returns dict(nodes
    (ncap,16), woop (2n,12), tri_index (2n,), kept (n,), root,
    node_count, leaf_count, order).
    """
    n = tri_lo.shape[0]
    if n >= (1 << 24):
        raise ValueError("lbvh_device_fast: tri ids ride a float32 value "
                         "lane, exact only below 2**24 tris")
    iota = jnp.arange(n, dtype=jnp.int32)
    cent = (tri_lo + tri_hi) * jnp.float32(0.5)
    codes = morton_codes_3d(jnp, cent, scene_lo, scene_hi)
    # num_keys=2: index tiebreak makes the permutation deterministic for
    # duplicate codes (golden-image stability). All per-tri payload rides
    # through the sort as extra operands instead of a post-sort row
    # gather.
    tvf = tri_verts.reshape(n, 9)
    sorted_ops = jax.lax.sort(
        (codes, iota)
        + tuple(tri_lo[:, j] for j in range(3))
        + tuple(tri_hi[:, j] for j in range(3))
        + tuple(tvf[:, j] for j in range(9)),
        num_keys=2)
    codes, order = sorted_ops[0], sorted_ops[1]
    slo = jnp.stack(sorted_ops[2:5], axis=1)
    shi = jnp.stack(sorted_ops[5:8], axis=1)
    tv_s = jnp.stack(sorted_ops[8:17], axis=1).reshape(n, 3, 3)

    def _early(live):
        """Prefix-ablation return: everything computed so far stays live
        through `live`; downstream is dead code. Results WRONG by design."""
        return dict(
            nodes=jnp.zeros((n, 16), jnp.float32).at[0, 0].set(live),
            woop=jnp.zeros((2 * n, 12), jnp.float32),
            tri_index=jnp.zeros((2 * n,), jnp.int32),
            kept=jnp.zeros((n,), jnp.bool_), root=jnp.int32(0),
            node_count=jnp.int32(0), leaf_count=jnp.int32(0), order=order)

    if _ablate == "ret_sort":
        return _early(codes.sum().astype(jnp.float32) * 1e-9 + slo.sum()
                      + shi.sum() + tv_s.sum())

    # Boundary split-levels: delta in [0, 30], D[0] = -1 (virtual root).
    x = codes[1:] ^ codes[:-1]
    d = jnp.where(x == 0, jnp.int32(30), jax.lax.clz(x) - 2)
    D = jnp.concatenate([jnp.full((1,), -1, jnp.int32), d])

    # ANSV by value class: prio(i) = (D[i], i) lex, all distinct.
    #   NSL(i) = nearest j < i with D[j] <= D[i]  (ties -> left is rootier)
    #   NSR(i) = nearest j > i with D[j] <  D[i]
    # packed = (pos << 5) | (D + 1): cummax/cummin by position, the delta
    # of the argmax rides along in the low bits.
    if _ablate == "scans":   # WRONG tree: prices the (31,n) ANSV scans
        nsl = jnp.maximum(iota - 1, 0) << 5 | 1
        nsr = jnp.minimum(iota + 1, n) << 5 | 1
    C = 31
    cs = jnp.arange(C, dtype=jnp.int32)[:, None]
    packed = (iota << 5) | (D + 1)
    big = (jnp.int32(n) << 5) | 31
    # The (31, n) class scans are the ANSV core.
    cmax = lambda v: jax.lax.cummax(v, axis=1)
    cmin_rev = lambda v: jax.lax.cummin(v, axis=1, reverse=True)
    if _ablate == "scans":
        P = jnp.broadcast_to(packed[None, :], (C, n))
    else:
        P = cmax(jnp.where(D[None, :] <= cs, packed[None, :], -1))
    Ps = jnp.concatenate(
        [jnp.full((C, 1), -1, jnp.int32), P[:, :-1]], axis=1)
    if _ablate == "scans":
        Q = jnp.broadcast_to(packed[None, :], (C, n))
    else:
        Q = cmin_rev(jnp.where(D[None, :] < cs, packed[None, :], big))
    Qs = jnp.concatenate(
        [Q[:, 1:], jnp.full((C, 1), big, jnp.int32)], axis=1)
    if _ablate != "scans":
        nsl = Ps[0]
        nsr = Qs[0]
        for c in range(1, C):
            m = D == c
            nsl = jnp.where(m, Ps[c], nsl)
            nsr = jnp.where(m, Qs[c], nsr)
    if _ablate == "ret_ansv":
        return _early((nsl.sum() + nsr.sum()).astype(jnp.float32) * 1e-9
                      + slo.sum() + shi.sum() + tv_s.sum())
    a = jax.lax.shift_right_logical(nsl, 5)   # range start row (0 if none)
    dl = (nsl & 31) - 1
    b = jax.lax.shift_right_logical(nsr, 5)   # range end row (n if none)
    dr = (nsr & 31) - 1

    # Parent = the deeper (larger-priority) of the two nearest-smaller
    # neighbours; NSL == virtual row 0 always loses to a real NSR.
    prio_l = ((dl + 1) << 25) | a
    prio_r = ((dr + 1) << 25) | b
    no_r = b >= n
    root_f = (a <= 0) & no_r
    par_left = no_r | (prio_l > prio_r)
    parent = jnp.where(par_left, a, b)
    side = jnp.where(par_left, jnp.int32(1), jnp.int32(0))
    size = b - a
    # D == 30 boundaries separate DUPLICATE codes: splitting them yields
    # index-order chains whose depth is unbounded (a >128-deep chain
    # silently overflows a 64-entry traversal stack -- caught on
    # full-conference LBVH). Like any Morton builder, duplicate clusters
    # become one fat leaf instead: only real-bit boundaries are kept.
    kept = (iota >= 1) & (size > max_leaf) & (D < 30)

    # Leaf runs: boundary r is interior to a leaf iff node r was pruned,
    # so leaves start at row 0 and at every kept boundary.
    leaf_start = kept | (iota == 0)
    runs_incl = jnp.cumsum(leaf_start.astype(jnp.int32))
    lcount = runs_incl[-1]
    dst = iota + runs_incl - 1          # woop row of sorted tri r; also
    #                                     woopoff(s) for any run start s.

    # A child interval is a LEAF iff it contains no kept boundary (covers
    # both the size rule and duplicate clusters: the child root would be
    # the interval's min-priority boundary, which is kept iff any is).
    pk = jax.lax.cummax(jnp.where(kept, iota, -1))       # last kept <= i
    nk = jax.lax.cummin(jnp.where(kept, iota, n), reverse=True)
    pks = jnp.concatenate([jnp.full((1,), -1, jnp.int32), pk[:-1]])
    nks = jnp.concatenate([nk[1:], jnp.full((1,), n, jnp.int32)])
    lleaf = pks <= a      # no kept boundary strictly inside (a, i)
    rleaf = nks >= b      # no kept boundary strictly inside (i, b)

    if _ablate == "ret_dst":
        return _early((dst.sum() + parent.sum() + side.sum()
                       + kept.sum() + lleaf.sum() + rleaf.sum()
                       + lcount).astype(jnp.float32) * 1e-9
                      + slo.sum() + shi.sum() + tv_s.sum())
    # Child AABBs: sparse range-min table over sorted tri AABBs, built
    # LANE-PACKED rather than as a (levels, n, 6) table with a minor dim
    # of 6. Three layout choices:
    #   1. levels live in (6, n) orientation -- minor dim n, full
    #      128-lane rows -- so the ~21 shifted-min passes stream at
    #      bandwidth instead of 6/128 lane occupancy;
    #   2. the two probes that need real gathers (left child's range
    #      start `a`, right child's range end `b - 2^k1`) read ONE
    #      position-major (n, L*6) copy whose minor dim ~126 is a full
    #      lane tile: one FULL-ROW gather each (gather cost is per-ROW),
    #      then the 6-lane level group is selected on the gathered value
    #      (fuses; no minor-6 buffer is ever materialized);
    #   3. the two own-position probes (i - 2^k0 and i) never gather:
    #      they stay as select chains over the (6, n) levels.
    pbT = jnp.stack([sorted_ops[2], sorted_ops[3], sorted_ops[4],
                     -sorted_ops[5], -sorted_ops[6], -sorted_ops[7]],
                    axis=0)             # (6, n) lane-packed lo/-hi
    logn = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    L = logn + 1
    levels = [pbT]
    # ("bounds" ablate builds level 0 only and fakes the boxes below.)
    for k in range(1, L if _ablate != "bounds" else 1):
        half = 1 << (k - 1)
        prev = levels[-1]
        pad = jnp.full((6, min(half, n)), np.inf, jnp.float32)
        levels.append(jnp.minimum(
            prev, jnp.concatenate([prev[:, half:], pad], axis=1)))
    big = jnp.stack(levels)             # (L, 6, n) lane-packed

    def k_of(sz):
        return jnp.minimum(31 - jax.lax.clz(jnp.maximum(sz, 1)), logn)

    # --- compact-to-kept: every remaining per-node pass (probes, links,
    # record assembly) runs over the KEPT nodes only -- about 0.37n /
    # 0.20n / 0.05n of the boundaries at max_leaf 4 / 8 / 32 -- instead
    # of all n boundaries. ncap is a STATIC cap with headroom over those
    # fractions; radix trees can be spine-shaped in the worst case, so
    # the host wrapper retries with compact_cap=n (always safe) if
    # node_count overflows the cap. The compaction scatter itself is
    # monotone (cumsum slots), the cheap scatter class.
    if compact_cap is None:
        ncap = min(n, int(n * 3.2 / (max_leaf + 4)) + 256)
    else:
        ncap = min(max(compact_cap, 8), n)
    ncap = min(-(-ncap // 8) * 8, n)  # keep sliceable: csrt operands are (n,)
    # Compaction rides ONE stable multi-operand sort (kept-first, then
    # boundary order) -- the same trick as the 17-operand Morton sort.
    # The alternative (cumsum-slot scatter + an (n, 8) packed row
    # gather) allocates a 512 MB minor-8 padded buffer per build and
    # measurably poisons chained builds.
    csrt = jax.lax.sort(
        ((~kept).astype(jnp.int32), iota, a, b, dst,
         lleaf.astype(jnp.int32), rleaf.astype(jnp.int32),
         parent, side, root_f.astype(jnp.int32)),
        num_keys=2)
    cidx = csrt[1][:ncap]
    a_c, b_c, dst_i = csrt[2][:ncap], csrt[3][:ncap], csrt[4][:ncap]
    lleaf_c, rleaf_c = csrt[5][:ncap] > 0, csrt[6][:ncap] > 0
    parent_c, side_c = csrt[7][:ncap], csrt[8][:ncap]
    root_c = csrt[9][:ncap] > 0
    kposi = jnp.cumsum(kept.astype(jnp.int32)) - 1   # compact slot per row
    node_count = jnp.maximum(kposi[-1] + 1, 0)
    ic = jnp.arange(ncap, dtype=jnp.int32)
    cvalid = ic < node_count
    k0 = k_of(cidx - a_c)
    k1 = k_of(b_c - cidx)
    if _ablate == "ret_table":
        return _early(big.sum() * 1e-9
                      + (dst.sum() + kept.sum()).astype(jnp.float32)
                      + tv_s.sum())
    # Position-major copy for the gathered probes: one 2-D transpose
    # (both sides lane-rich: minor dims n and L*6~126).
    if _ablate != "bounds":
        Tpos = big.reshape(L * 6, n).T       # (n, L*6)
    if _ablate == "ret_tabmat":   # force MATERIALIZING Tpos (gather
        # consumers need the real buffer; big.sum() can stream-fuse)
        probe = Tpos[(iota * 977) % n]
        return _early(probe.sum() * 1e-9
                      + (dst.sum() + kept.sum()).astype(jnp.float32)
                      + tv_s.sum())

    L2 = 1 << int(np.ceil(np.log2(L)))   # levels padded to a power of 2

    def _gsel(rows126, kk):
        """Select level group kk (6 lanes) from gathered (m, L*6) rows.

        STAYS RANK-2: a (m, L, 6) reshape would materialize with its
        minor dim 6 padded to a 128-wide tile by backends that tile the
        minor dim. Instead mask the wrong levels to inf on
        the flat lanes, then fold the level dimension by halving --
        every intermediate is 2-D and lane-dense."""
        m = rows126.shape[0]
        g = jnp.concatenate(
            [rows126,
             jnp.full((m, (L2 - L) * 6), np.inf, jnp.float32)], axis=1)
        lane_lvl = jax.lax.broadcasted_iota(jnp.int32, g.shape, 1) // 6
        g = jnp.where(lane_lvl == kk[:, None], g, np.inf)
        w = L2 * 6
        while w > 6:
            w //= 2
            g = jnp.minimum(g[:, :w], g[:, w:2 * w])
        return g

    if _ablate != "bounds":
        # All four probes are compact full-row gathers + in-register
        # level-group selects, all per kept node.
        r1_0 = _gsel(Tpos[jnp.clip(a_c, 0, n - 1)], k0)
        r2_0 = _gsel(Tpos[jnp.clip(cidx - (1 << k0), 0, n - 1)], k0)
        r1_1 = _gsel(Tpos[cidx], k1)
        r2_1 = _gsel(Tpos[jnp.clip(b_c - (1 << k1), 0, n - 1)], k1)
        dst_a = dst[jnp.clip(a_c, 0, n - 1)]  # left-child run offsets
        m0 = jnp.minimum(r1_0, r2_0)
        m1 = jnp.minimum(r1_1, r2_1)
    else:  # "bounds": WRONG boxes by design; keeps assembly live
        dst_a = dst[jnp.clip(a_c, 0, n - 1)]
        m0 = (jnp.stack([a_c, b_c, dst_i, parent_c, side_c, cidx], axis=1)
              .astype(jnp.float32) + big.sum() * 1e-30)
        m1 = m0
    if _ablate == "ret_gather":
        return _early((r1_0.sum() + r2_1.sum()) * 1e-9
                      + dst_a.sum().astype(jnp.float32) * 1e-9 + tv_s.sum())

    enc0 = jnp.where(lleaf_c, ~dst_a, 0)
    enc1 = jnp.where(rleaf_c, ~dst_i, 0)
    enc = jnp.stack([enc0, enc1], axis=1)
    # The single link scatter, now in COMPACT space: each non-root kept
    # node writes its COMPACT id into its parent's child slot, so the
    # emitted links are final dense node ids (the host only moves the
    # root to index 0). Updates are SORTED BY TARGET first: scatter cost
    # depends on index locality, and parent slots arrive in child order;
    # the small 2-operand sort turns a random scatter into a monotone one.
    pcomp = kposi[jnp.clip(parent_c, 0, n - 1)]
    flat_t = jnp.where(cvalid & (~root_c), pcomp * 2 + side_c, 2 * ncap)
    st, sv = jax.lax.sort((flat_t, ic), num_keys=1)
    enc = enc.reshape(-1).at[st].set(
        sv, mode="drop", unique_indices=True).reshape(ncap, 2)
    lo0, hi0 = m0[:, 0:3], -m0[:, 3:6]
    lo1, hi1 = m1[:, 0:3], -m1[:, 3:6]

    if _ablate == "ret_bounds":
        return _early(m0.sum() * 1e-9 + m1.sum() * 1e-9
                      + enc.sum().astype(jnp.float32) * 1e-9 + tv_s.sum())
    # Assemble node records with masking on the INT side and bitcast as
    # the very last step into its lane: f32 arithmetic (where/select/
    # relayout) over bitcast int lanes can FLUSH DENORMALS TO ZERO on a
    # backend that flushes them -- small int bit patterns are denormal
    # floats (chip_smoke.py reports whether XLA keeps them).
    cols = [lo0[:, 0], hi0[:, 0], lo0[:, 1], hi0[:, 1],
            lo1[:, 0], hi1[:, 0], lo1[:, 1], hi1[:, 1],
            lo0[:, 2], hi0[:, 2], lo1[:, 2], hi1[:, 2]]
    enc0m = jnp.where(cvalid, enc[:, 0], 0)
    enc1m = jnp.where(cvalid, enc[:, 1], 0)
    zero_c = jnp.zeros((ncap,), jnp.float32)
    # ONE stack instead of 16 chained .at[:, lane].set() updates -- each
    # update rewrites the whole (ncap, 16) buffer (128-lane padded).
    nodes = jnp.stack(
        [jnp.where(cvalid, c, 0.0) for c in cols]
        + [jax.lax.bitcast_convert_type(enc0m, jnp.float32),
           jax.lax.bitcast_convert_type(enc1m, jnp.float32),
           zero_c, zero_c], axis=1)

    # Woop rows + tri ids: INVERT the placement (scatter cost grows with
    # the element count, a row gather's with the row count). So: ONE
    # 1-column scatter builds the output->input map (src1, 0 =
    # sentinel/gap row), then ONE 13-column row gather + select places the
    # payload. Unmapped rows ARE the leaf-end sentinel (lane0 bits
    # 0x80000000, tri_index -1). The id lane carries the tri id as a float
    # VALUE (exact below 2^24), never a bitcast: bitcast small ints are
    # denormals, which a flushing f32 data path would zero.
    w = _device_woopify(tv_s)
    wcap = 2 * n
    sent_val = jax.lax.bitcast_convert_type(
        jnp.int32(-0x80000000), jnp.float32)
    init_row = jnp.zeros((13,), jnp.float32).at[0].set(
        sent_val).at[12].set(-1.0)
    payload13 = jnp.concatenate(
        [w, order.astype(jnp.float32)[:, None]], axis=1)
    if _ablate == "scatter":
        wout = jnp.tile(init_row[None, :], (wcap, 1))
    else:
        src1 = jnp.zeros((wcap,), jnp.int32).at[dst].set(
            iota + 1, mode="drop", unique_indices=True)
        gathered = payload13[jnp.maximum(src1 - 1, 0)]
        wout = jnp.where((src1 > 0)[:, None], gathered, init_row[None, :])
    woop = wout[:, :12]
    tri_index = wout[:, 12].astype(jnp.int32)

    if _ablate == "ret_nodes":
        return _early(nodes.sum() * 1e-9 + tv_s.sum())
    root = jnp.argmax(cvalid & root_c).astype(jnp.int32)   # COMPACT id
    return dict(nodes=nodes, woop=woop, tri_index=tri_index, kept=kept,
                root=root, node_count=node_count, leaf_count=lcount,
                order=order)


def build_lbvh_flat(scene: Scene, cfg: BuildConfig = BuildConfig()) -> FlatBVH:
    """Host wrapper: fast device build -> compacted host FlatBVH."""
    tv = scene.tri_verts()
    if scene.num_tris < 2:
        from ntrace_tpu.bvh.flatten import flatten_bvh
        from ntrace_tpu.bvh.median import build_median_bvh

        return flatten_bvh(build_median_bvh(scene, cfg), scene)
    tlo = tv.min(axis=1)
    thi = tv.max(axis=1)
    lo, hi = scene.bbox()
    args = (jnp.asarray(tlo), jnp.asarray(thi), jnp.asarray(tv),
            jnp.asarray(lo), jnp.asarray(hi))
    out = lbvh_device_fast(*args, max_leaf=cfg.max_leaf_size)
    nc = int(out["node_count"])
    if nc > out["nodes"].shape[0]:
        # Spine-shaped radix tree overflowed the compact cap: rerun with
        # the always-sufficient cap (exact either way, just slower).
        out = lbvh_device_fast(*args, max_leaf=cfg.max_leaf_size,
                               compact_cap=scene.num_tris)
        nc = int(out["node_count"])
    if nc == 0:  # n <= max_leaf: no internal nodes emitted
        from ntrace_tpu.bvh.flatten import flatten_bvh
        from ntrace_tpu.bvh.median import build_median_bvh

        return flatten_bvh(build_median_bvh(scene, cfg), scene)
    nodes = np.asarray(out["nodes"])[:nc]
    woop = np.asarray(out["woop"])
    tri_index = np.asarray(out["tri_index"])
    root = int(out["root"])
    lc = int(out["leaf_count"])
    n = scene.num_tris
    # Device links are already dense compact ids; just move root -> 0.
    perm = np.concatenate(
        [[root], np.delete(np.arange(nc, dtype=np.int64), root)])
    remap = np.empty(nc, np.int32)
    remap[perm] = np.arange(nc, dtype=np.int32)
    nd = np.ascontiguousarray(nodes[perm])
    for lane in (12, 13):
        e = np.ascontiguousarray(nd[:, lane]).view(np.int32)
        internal = e >= 0
        e[internal] = remap[e[internal]]
        nd[:, lane] = e.view(np.float32)
    w_used = n + lc
    return FlatBVH(
        nodes=nd,
        woop=woop[:w_used],
        tri_index=tri_index[:w_used],
        num_tris=n,
        sah_cost=0.0,
    )
