"""Polygon fill, bit-equal to cv2.fillPoly at its defaults.

The JAX package rasterises labelme polygons with cv2.fillPoly(mask,
polygon[None], value) (LINE_8, shift 0). cv2 is not a dependency of the
port, so this is a copy of OpenCV's algorithm (imgproc/drawing.cpp):

1. CollectPolyEdges: every edge of the closed polygon is first drawn as an
   8-connected Bresenham line (LineIterator, left to right, clipped to the
   image by clipLine); each edge that is not horizontal becomes a
   fixed-point edge (16 fractional bits of x, x stepping by dx a row,
   truncating division); where the line leaves the image, the edge's x
   comes from the clipped end points, and its rows too where the clipped
   points' rows differ.
2. FillEdgeCollection: the edges sorted by (y0, x, dx) enter an active
   list sorted by x as the scanline reaches their top row and leave it at
   their bottom row; each scanline fills between consecutive pairs (the
   even-odd rule), from ceil(x_left) to floor(x_right), and a bubble sort
   restores the x order after the edges step.

Coordinates are Python integers, so the int64 arithmetic of the C code is
exact here; its truncating divisions are spelled out.
"""
import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _div(a, b):
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(width, height, x1, y1, x2, y2):
    """OpenCV's clipLine on int64 points: (inside, x1, y1, x2, y2)."""
    if width <= 0 or height <= 0:
        return False, x1, y1, x2, y2
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _outside(mask, x1, y1, x2, y2):
    h, w = mask.shape[:2]
    return not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h)


def _line(mask, x1, y1, x2, y2, value):
    """OpenCV's Line at 8-connectivity: a LineIterator left to right over
    the clipped segment."""
    h, w = mask.shape[:2]
    if _outside(mask, x1, y1, x2, y2):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    delta_x = delta_y = 1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    if dy < 0:
        dy, delta_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
        delta_x, delta_y = delta_y, delta_x
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    # each step moves along the major axis, and along the minor one too
    # when err < 0
    major = (0, delta_x) if vert else (delta_x, 0)
    minor = (delta_y, 0) if vert else (0, delta_y)
    x, y = x1, y1
    for _ in range(dx + 1):
        mask[y, x] = value
        if err < 0:
            err += minus_delta + plus_delta
            x += major[0] + minor[0]
            y += major[1] + minor[1]
        else:
            err += minus_delta
            x += major[0]
            y += major[1]


class _Edge:
    __slots__ = ('y0', 'y1', 'x', 'dx', 'next')

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx = y0, y1, x, dx
        self.next = None


def _collect_edges(mask, points, value, edges):
    """CollectPolyEdges at LINE_8, shift 0, offset 0."""
    h, w = mask.shape[:2]
    pt0 = (int(points[-1][0]) << XY_SHIFT, int(points[-1][1]))
    for px, py in points:
        pt1 = (int(px) << XY_SHIFT, int(py))
        t0 = ((pt0[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt0[1])
        t1 = ((pt1[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt1[1])
        _line(mask, t0[0], t0[1], t1[0], t1[1], value)
        c0, c1 = list(pt0), list(pt1)
        if _outside(mask, t0[0], t0[1], t1[0], t1[1]):
            # the edge's x from the clipped end points, its rows too where
            # they still differ
            _, ax, ay, bx, by = _clip_line(w, h, t0[0], t0[1], t1[0], t1[1])
            if ay != by:
                c0[1], c1[1] = ay, by
            c0[0], c1[0] = ax << XY_SHIFT, bx << XY_SHIFT
        if pt0[1] != pt1[1]:
            dx = _div(c1[0] - c0[0], c1[1] - c0[1])
            if pt0[1] < pt1[1]:
                edge = _Edge(pt0[1], pt1[1], 0, dx)
                edge.x = c0[0] + (edge.y0 - c0[1]) * dx
            else:
                edge = _Edge(pt1[1], pt0[1], 0, dx)
                edge.x = c1[0] + (edge.y0 - c1[1]) * dx
            edges.append(edge)
        pt0 = pt1


def _fill_edges(mask, edges, value):
    """FillEdgeCollection at LINE_8."""
    h, w = mask.shape[:2]
    total = len(edges)
    if total < 2:
        return
    y_min = min(e.y0 for e in edges)
    y_max = max(e.y1 for e in edges)
    ends = [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    x_min = min(min(e.x for e in edges), min(ends))
    x_max = max(max(e.x for e in edges), max(ends))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx))
    edges.append(_Edge(y0=1 << 62))  # the sentinel
    head = _Edge()
    i = 0
    e = edges[0]
    y_max = min(y_max, h)
    for y in range(e.y0, y_max):
        draw = False
        clip = y < 0
        prelast, last = head, head.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                # the edge ends: drop it from the active list
                prelast.next = last.next
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:
                # the edge starts: insert it
                prelast.next = e
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if not clip:
                    left, right = ((prelast, keep_prelast)
                                   if keep_prelast.x > prelast.x
                                   else (keep_prelast, prelast))
                    # from ceil(x_left) to floor(x_right)
                    x1 = (left.x + XY_ONE - 1) >> XY_SHIFT
                    x2 = right.x >> XY_SHIFT
                    if x1 < w and x2 >= 0:
                        mask[y, max(x1, 0):min(x2, w - 1) + 1] = value
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # the bubble sort of the active list by x
        keep_prelast = None
        while True:
            prelast, last = head, head.next
            last_exchange = None
            while last is not keep_prelast and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next = te
                    last.next = te.next
                    te.next = last
                    prelast = te
                    if last_exchange is None:
                        last_exchange = prelast
                else:
                    prelast, last = last, te
            if last_exchange is None:
                break
            keep_prelast = last_exchange
            if keep_prelast is head.next or keep_prelast is head:
                break


def fill_poly(mask, polygon, value):
    """cv2.fillPoly(mask, polygon[None], value) on a 2D mask, in place, at
    LINE_8 and shift 0; returns the mask. polygon: (n, 2) integer (x, y)
    vertices, n >= 1."""
    polygon = np.asarray(polygon)
    if polygon.ndim != 2 or polygon.shape[1] != 2 or len(polygon) == 0:
        raise ValueError(f'a polygon is (n >= 1, 2) vertices, got '
                         f'{polygon.shape}')
    if not np.issubdtype(polygon.dtype, np.integer):
        raise ValueError('polygon vertices must be integers')
    edges = []
    _collect_edges(mask, polygon.tolist(), value, edges)
    _fill_edges(mask, edges, value)
    return mask
