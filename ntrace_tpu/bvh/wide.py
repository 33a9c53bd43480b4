"""Wide (8-ary) BVH: collapse the binary tree into 64-column fetch rows.

Why: a lockstep XLA engine pays per step, whatever the row width of its
gather, so an 8-wide node per fetch cuts inner steps ~2.6x vs binary, and
packing 4 Woop triangles per leaf row cuts leaf steps 4x. (The reference's
64-byte node was sized for GPU cache lines; this 256-byte row is sized
for step count; not yet measured on a GPU.)

Wide unified-table layout, rows are float32[64]:
  node row (one per 8-ary node):
    cols 6k..6k+5, k=0..7 : child k slabs (lo.x, hi.x, lo.y, hi.y, lo.z, hi.z)
    cols 48..55           : bitcast int32 child references
                            (>=0 node row; <0 ~leafRow; row0 is the root)
    empty slots           : slabs at +3e38 (hits only beyond any tmax;
                            engine requires ray tmax < 1e38)
  leaf row (ceil(count/4) per leaf + terminator):
    cols 12k..12k+11, k=0..3 : Woop records m0|m1|m2 (poisoned when padded)
    cols 48..51              : bitcast int32 triangle ids (-1 padding)
    terminator row           : col 0 carries the 0x80000000 sentinel bits
All real m0.x values are canonicalized away from -0.0, as are node col-0
slab values, so the sentinel test stays unambiguous.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ntrace_tpu.bvh.flatten import FlatBVH, flat_children
from ntrace_tpu.ops.woop import LEAF_END_BITS

EMPTY_SLAB = np.float32(3e38)
LEAF_PACK = 4
ARITY = 8


@dataclass
class WideTable:
    table: np.ndarray   # (M, 64) float32: node rows then leaf rows
    n_node_rows: int

    def nbytes(self) -> int:
        return self.table.nbytes


def _binary_slots(flat: FlatBVH):
    """Decode per-binary-node child slots: enc (N,2) and bounds (N,2,3,2)."""
    ch = flat_children(flat)
    n = flat.nodes
    lo = np.stack([n[:, [0, 2, 8]], n[:, [4, 6, 10]]], axis=1)   # (N,2,3)
    hi = np.stack([n[:, [1, 3, 9]], n[:, [5, 7, 11]]], axis=1)
    return ch, lo, hi


def _leaf_runs(flat: FlatBVH):
    """Map every leaf's woop offset -> list of triangle row indices."""
    m0x = flat.woop[:, 0:1].view(np.int32)[:, 0]
    sent = m0x == LEAF_END_BITS
    runs = {}
    ch = flat_children(flat)
    offs = np.unique(~ch[ch < 0])
    sent_pos = np.flatnonzero(sent)
    for off in offs:
        end = sent_pos[np.searchsorted(sent_pos, off)]
        runs[int(off)] = (int(off), int(end))  # [off, end) woop rows
    return runs


def build_wide_table(flat: FlatBVH) -> WideTable:
    ch, blo, bhi = _binary_slots(flat)
    runs = _leaf_runs(flat)

    # ---- pack leaves: 4 woop records per row + terminator ---------------
    leaf_rows = []
    leaf_row_of = {}  # old woop offset -> packed local row index
    for off, (a, b) in runs.items():
        leaf_row_of[off] = len(leaf_rows)
        recs = flat.woop[a:b]
        ids = flat.tri_index[a:b]
        cnt = b - a
        for s in range(0, cnt, LEAF_PACK):
            row = np.zeros((64,), np.float32)
            k = min(LEAF_PACK, cnt - s)
            row[: 12 * k] = recs[s:s + k].reshape(-1)
            # Poison padded slots (m1.w = m2.w = -1 -> u < 0 miss).
            for p in range(k, LEAF_PACK):
                row[12 * p + 7] = -1.0
                row[12 * p + 11] = -1.0
            idrow = np.full((LEAF_PACK,), -1, np.int32)
            idrow[:k] = ids[s:s + k]
            row[48:52] = idrow.view(np.float32)
            leaf_rows.append(row)
        term = np.zeros((64,), np.float32)
        term[0] = np.int32(LEAF_END_BITS).view(np.float32)
        term[48:52] = np.full((4,), -1, np.int32).view(np.float32)
        leaf_rows.append(term)
    leaf_rows = np.stack(leaf_rows) if leaf_rows else np.zeros((0, 64), np.float32)

    # ---- collapse binary -> 8-ary (preorder, root stays row 0) ----------
    wide_children: list[list[tuple]] = []  # per wide node: [(enc,lo,hi),...]
    wide_of_binary = {}

    def gather_slots(b):
        """Collapse binary node b into up to ARITY child slots."""
        slots = [(ch[b, k], blo[b, k], bhi[b, k]) for k in range(2)]
        while len(slots) < ARITY:
            # Expand the inner child with the largest surface area.
            best, best_area = -1, -1.0
            for i, (enc, lo, hi) in enumerate(slots):
                if enc >= 0:
                    d = np.maximum(hi - lo, 0)
                    area = d[0] * d[1] + d[1] * d[2] + d[2] * d[0]
                    if area > best_area:
                        best, best_area = i, area
            if best < 0:
                break
            enc, _, _ = slots.pop(best)
            slots.extend(
                (ch[enc, k], blo[enc, k], bhi[enc, k]) for k in range(2)
            )
        return slots

    order = []  # wide node -> its slots
    stack = [0]
    alloc = {0: 0}
    order.append(None)
    while stack:
        b = stack.pop()
        w = alloc[b]
        slots = gather_slots(b)
        order[w] = slots
        for enc, lo, hi in slots:
            if enc >= 0:
                alloc[enc] = len(order)
                order.append(None)
                stack.append(enc)

    nn = len(order)
    nodes = np.zeros((nn, 64), np.float32)
    # Fill: need wide ids for inner children -> alloc maps binary->wide.
    for w, slots in enumerate(order):
        enc_row = np.zeros((8,), np.int32)
        for k in range(ARITY):
            if k < len(slots):
                enc, lo, hi = slots[k]
                nodes[w, 6 * k:6 * k + 6] = [lo[0], hi[0], lo[1], hi[1], lo[2], hi[2]]
                if enc >= 0:
                    enc_row[k] = alloc[enc]
                else:
                    enc_row[k] = ~leaf_row_of[int(~enc)]
            else:
                nodes[w, 6 * k:6 * k + 6] = [EMPTY_SLAB] * 6
                enc_row[k] = 0
        nodes[w, 48:56] = enc_row.view(np.float32)
    # col 0 must never alias the sentinel bit pattern (-0.0 -> +0.0).
    nodes[:, 0] += 0.0

    table = np.concatenate([nodes, leaf_rows])
    return WideTable(table=np.ascontiguousarray(table), n_node_rows=nn)
