"""Morton-order pixel permutation (~ rt/ray/PixelTable.{cpp,hpp}).

The reference precomputes a Z-curve ordering of pixel indices so that
consecutive primary rays are screen-coherent (warps trace nearby pixels).
The same ordering helps every engine here: coherent rays visit the same
nodes, so warps and lockstep batches finish together.
"""

from __future__ import annotations

import numpy as np

from ntrace_tpu.ops.morton import morton2d

_cache: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}


def pixel_table(width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (index_to_pixel, pixel_to_index), both (W*H,) int32.

    index_to_pixel[i] = linear pixel id (y*W + x) of ray slot i, ordered by
    2D Morton code of (x, y); pixel_to_index is the inverse permutation
    (~ PixelTable::getIndexToPixel / getPixelToIndex).
    """
    key = (width, height)
    if key in _cache:
        return _cache[key]
    x = np.arange(width, dtype=np.int64)
    y = np.arange(height, dtype=np.int64)
    xx, yy = np.meshgrid(x, y)  # (H, W)
    codes = morton2d(np, xx.ravel(), yy.ravel())
    order = np.argsort(codes, kind="stable").astype(np.int32)  # slot -> (y*W+x)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=np.int32)
    _cache[key] = (order, inv)
    return order, inv
