"""cv2's filled shapes and nearest resize in numpy, pixel for pixel.

The scenario generator (``tools/make_synthetic_dataset.py``) draws with
``cv2.rectangle``, ``cv2.ellipse``, ``cv2.fillPoly`` and ``cv2.boxPoints``
and resizes its noise with ``INTER_NEAREST``; the card host has no cv2.
This module repeats OpenCV's integer rasterisers (``imgproc/drawing.cpp``,
8-connected lines, no anti-aliasing) on (H, W, 3) uint8 arrays:

* a line from integer points is Bresenham's, clipped to the image first
  and walked left to right (``LineIterator``); an edge in 16-bit fixed point
  is ``Line2``'s DDA;
* ``rectangle`` and ``ellipse`` fill a convex polygon scanline by scanline
  (``FillConvexPoly``), its edges drawn as lines first;
* ``ellipse`` is the polygon of ``ellipse2Poly`` over OpenCV's ``SinTable``
  (sin of whole degrees rounded to 7 digits, as float32), the angle rounded
  to a whole degree, a vertex every 5-90° by the larger axis;
* ``fillPoly`` fills by an active edge list (``FillEdgeCollection``),
  its edges drawn as lines first; a span runs from ceil(left edge) to
  floor(right edge), and an edge that leaves the image is first moved to
  its clipped endpoints.

These are OpenCV 5.0's rules, probed against it pixel for pixel on random
shapes in and across the image's edges (``tests/test_torch_scenarios.py``);
``boxPoints`` computes each corner from the centre, in float32.

Integer division truncates toward zero and ``>>`` floors, as in C++.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_INT_MAX = 2**31 - 1

# OpenCV's SinTable: sin(0..450 degrees) rounded to 7 digits, as float32
SIN_TABLE = np.float32(np.round(np.sin(np.deg2rad(np.arange(451))), 7))


def _tdiv(a: int, b: int) -> int:
    """C integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _round_half_even(v: float) -> int:
    """``cvRound`` of a double: the nearest integer, ties to even."""
    return int(np.rint(v))


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """``clipLine`` on a w×h image (any fixed-point scale): (inside, x1, y1,
    x2, y2), the endpoints moved onto the border as OpenCV moves them."""
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
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


def _line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """``Line``: the 8-connected line between integer points."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # walked left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0


def _line2(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], color) -> None:
    """``Line2``: the line between points in XY_SHIFT fixed point."""
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        dy = (dy ^ j) - j
        if j:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        dx = (dx ^ i) - i
        if i:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex_poly(img: np.ndarray, v: Sequence[Tuple[int, int]], color, shift: int) -> None:
    """``FillConvexPoly`` (8-connected) of points with ``shift`` fractional
    bits."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = (1 << shift) >> 1
    half = XY_ONE >> 1
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << up, py << up)
        if shift == 0:
            _line(img, p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT, p[0] >> XY_SHIFT, p[1] >> XY_SHIFT, color)
        else:
            _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:  # for (; edges-- > 0; )
                    more = edges > 0
                    edges -= 1
                    if not more:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
                        e[4] = ty
                        e[3] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + half) >> XY_SHIFT
            xx2 = (edge[right][2] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = color
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def _collect_poly_edges(img: np.ndarray, v: Sequence[Tuple[int, int]], color) -> List[_Edge]:
    """``CollectPolyEdges`` (8-connected, integer points): each edge drawn
    as a line; the non-horizontal ones, clipped to the image, returned."""
    h, w = img.shape[:2]
    out = []
    pt0 = (v[-1][0] << XY_SHIFT, v[-1][1])
    for px, py in v:
        pt1 = (px << XY_SHIFT, py)
        t0 = [(pt0[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt0[1]]
        t1 = [(pt1[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt1[1]]
        _line(img, t0[0], t0[1], t1[0], t1[1], color)
        c0, c1 = list(pt0), list(pt1)
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
            # the edge takes its clipped endpoints' x, and their y unless
            # the clipped segment is flat
            _, a0, b0, a1, b1 = _clip_line(w, h, t0[0], t0[1], t1[0], t1[1])
            if b0 != b1:
                c0[1], c1[1] = b0, b1
            c0[0], c1[0] = a0 << XY_SHIFT, a1 << XY_SHIFT
        if pt0[1] != pt1[1]:
            dx = _tdiv(c1[0] - c0[0], c1[1] - c0[1])
            if pt0[1] < pt1[1]:
                out.append(_Edge(pt0[1], pt1[1], c0[0] + (pt0[1] - c0[1]) * dx, dx))
            else:
                out.append(_Edge(pt1[1], pt0[1], c1[0] + (pt1[1] - c1[1]) * dx, dx))
        pt0 = pt1
    return out


def _fill_edge_collection(img: np.ndarray, edges: List[_Edge], color) -> None:
    """``FillEdgeCollection`` (8-connected): even-odd spans between the
    active edges, scanline by scanline, each from ceil(left) to
    floor(right)."""
    h, w = img.shape[:2]
    total = len(edges)
    if total < 2:
        return
    y_min, y_max = _INT_MAX, -_INT_MAX - 1
    x_min, x_max = 2**63 - 1, -1
    for e in edges:
        x1 = e.x + (e.y1 - e.y0) * e.dx
        y_min, y_max = min(y_min, e.y0), max(y_max, e.y1)
        x_min, x_max = min(x_min, e.x, x1), max(x_max, e.x, x1)
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx))
    edges.append(_Edge(y0=_INT_MAX))
    tmp = _Edge()
    i = 0
    e = edges[0]
    y_max = min(y_max, h)
    for y in range(e.y0, y_max):
        prelast, last = tmp, tmp.next
        draw = False
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last.next
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:
                prelast.next = e
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if y >= 0:
                    if keep_prelast.x > prelast.x:
                        x1, x2 = (prelast.x + XY_ONE - 1) >> XY_SHIFT, keep_prelast.x >> XY_SHIFT
                    else:
                        x1, x2 = (keep_prelast.x + XY_ONE - 1) >> XY_SHIFT, prelast.x >> XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = color
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # bubble sort of the active list by x
        keep_prelast = None
        while True:
            prelast, last = tmp, tmp.next
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
            if keep_prelast is tmp.next or keep_prelast is tmp:
                break


def _color(img: np.ndarray, color) -> np.ndarray:
    return np.asarray([int(c) for c in color][: img.shape[2]], img.dtype)


def rectangle_filled(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int], color) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, -1)``: both corners included,
    clipped to the image."""
    (x1, y1), (x2, y2) = pt1, pt2
    _fill_convex_poly(img, [(x1, y1), (x2, y1), (x2, y2), (x1, y2)], _color(img, color), 0)


def _ellipse_points(center: Tuple[int, int], axes: Tuple[int, int], angle: int,
                    delta: int) -> List[Tuple[float, float]]:
    """``ellipse2Poly``'s vertices (its double version) of a whole ellipse
    turned by a whole-degree ``angle``, one every ``delta`` degrees."""
    angle %= 360
    cos_a, sin_a = float(SIN_TABLE[450 - angle]), float(SIN_TABLE[angle])
    pts = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        x = axes[0] * float(SIN_TABLE[450 - a])
        y = axes[1] * float(SIN_TABLE[a])
        pts.append((center[0] + x * cos_a - y * sin_a, center[1] + x * sin_a + y * cos_a))
    return pts


def ellipse_filled(img: np.ndarray, center: Tuple[int, int], axes: Tuple[int, int], angle: float, color) -> None:
    """``cv2.ellipse(img, center, axes, angle, 0, 360, color, -1)`` of
    integer center and axes."""
    cx, cy = (int(c) << XY_SHIFT for c in center)
    aw, ah = (abs(int(a)) << XY_SHIFT for a in axes)
    r = (max(aw, ah) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if r < 3 else 30 if r < 10 else 18 if r < 15 else 5
    v: List[Tuple[int, int]] = []
    for px, py in _ellipse_points((cx, cy), (aw, ah), _round_half_even(angle), delta):
        qx = _round_half_even(px / XY_ONE) << XY_SHIFT
        qy = _round_half_even(py / XY_ONE) << XY_SHIFT
        p = (qx + _round_half_even(px - qx), qy + _round_half_even(py - qy))
        if not v or p != v[-1]:
            v.append(p)
    if len(v) == 1:
        v = [(cx, cy)] * 2
    _fill_convex_poly(img, v, _color(img, color), XY_SHIFT)


def fill_poly(img: np.ndarray, pts: np.ndarray, color) -> None:
    """``cv2.fillPoly(img, [pts], color)`` of one contour of int32 points."""
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    c = _color(img, color)
    _fill_edge_collection(img, _collect_poly_edges(img, v, c), c)


def box_points(center: Tuple[float, float], size: Tuple[float, float], angle: float) -> np.ndarray:
    """``cv2.boxPoints(((cx, cy), (w, h), angle))``: the four corners of a
    rotated rectangle, (4, 2) float32, in OpenCV's order and float32
    arithmetic."""
    f = np.float32
    cx, cy, w, h = f(center[0]), f(center[1]), f(size[0]), f(size[1])
    rad = float(f(angle)) * np.pi / 180.0  # the float angle, in double
    b = f(np.cos(rad)) * f(0.5)
    a = f(np.sin(rad)) * f(0.5)
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    p2 = (cx + a * h + b * w, cy - b * h + a * w)
    p3 = (cx - a * h + b * w, cy + b * h + a * w)
    return np.array([p0, p1, p2, p3], np.float32)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)``: source
    index ``floor(d / (dst / src))``, capped at the last."""
    dst_w, dst_h = int(size[0]), int(size[1])
    src_h, src_w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(dst_w) * (1.0 / (dst_w / src_w))).astype(np.int64), src_w - 1)
    ys = np.minimum(np.floor(np.arange(dst_h) * (1.0 / (dst_h / src_h))).astype(np.int64), src_h - 1)
    return img[ys][:, xs]


def _circle_filled(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """``Circle(..., fill=1)``: Bresenham's circle, filled by spans."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < w - radius and radius <= cy < h - radius

    def hline(y, x1, x2):
        img[y, x1:x2 + 1] = color

    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            hline(y11, x11, x12)
            hline(y12, x11, x12)
            hline(y21, x21, x22)
            hline(y22, x21, x22)
        elif x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            if 0 <= y11 < h:
                hline(y11, x11, x12)
            if 0 <= y12 < h:
                hline(y12, x11, x12)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                if 0 <= y21 < h:
                    hline(y21, x21, x22)
                if 0 <= y22 < h:
                    hline(y22, x21, x22)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], color, thickness: int,
                flags: int) -> None:
    """``ThickLine`` of XY_SHIFT points wider than 1, 8-connected: the convex
    quadrilateral about the segment and a filled circle at each end that
    ``flags`` names (1: start, 2: end)."""
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _round_half_even(dy * r), _round_half_even(dx * r)
        quad = [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)]
        _fill_convex_poly(img, quad, color, XY_SHIFT)
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            _circle_filled(img, (p[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p[1] + (XY_ONE >> 1)) >> XY_SHIFT,
                           (thickness + (XY_ONE >> 1)) >> XY_SHIFT, color)


def polyline(img: np.ndarray, pts: Sequence[Tuple[int, int]], closed: bool, color, thickness: int) -> None:
    """``PolyLine`` of integer points (``cv2.polylines`` / the outline of
    ``cv2.rectangle``), 8-connected, at ``thickness`` >= 1: a width-1 side
    is ``Line`` between the rounded points, as ``ThickLine`` draws it."""
    v = [(int(x) << XY_SHIFT, int(y) << XY_SHIFT) for x, y in pts]
    flags = 2 + (not closed)
    p0 = v[-1] if closed else v[0]
    for p in v[(0 if closed else 1):]:
        if thickness <= 1:
            _line(img, (p0[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p0[1] + (XY_ONE >> 1)) >> XY_SHIFT,
                  (p[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p[1] + (XY_ONE >> 1)) >> XY_SHIFT, color)
        else:
            _thick_line(img, p0, p, color, thickness, flags)
        p0 = p
        flags = 2
