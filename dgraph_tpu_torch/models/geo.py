"""GeoJSON geometry: distance, containment, intersection, cell covers.

Library-free re-provision of the reference's geo stack
(types/geofilter.go:65 near/within/contains/intersects over go-geom +
S2, types/s2index.go cell covers). Differences, by design:

- Cells are a lon/lat square grid at levels 5..12 (level 8 = 1
  cell/degree, each level doubles the resolution) instead of S2's
  spherical hierarchy. Same ancestor-lookup pattern: a stored geometry
  is indexed at every level where its cover stays under _MAX_CELLS; a
  query covers its region per level and unions coarse->fine lookups.
- Point-in-polygon runs planar on lon/lat (ray cast with holes);
  distances are spherical (haversine). For region sizes where a graph
  database's geo filters are used, this matches reference results; the
  S2 edge cases (poles, antimeridian-crossing polygons) are out of
  scope and documented here.

Geometries are GeoJSON dicts: Point, Polygon (first ring exterior,
rest holes), MultiPolygon.
"""

from __future__ import annotations

import math
from typing import Iterator

EARTH_R_M = 6_371_000.8
# level 2 (~64 deg/cell) covers the whole world in <=18 cells, so every
# geometry gets indexed and every query region gets a non-empty cover
# regardless of size (the round-2 advisor caught MIN_LEVEL=5 silently
# dropping >64-cell covers)
MIN_LEVEL = 2
MAX_LEVEL = 12
_MAX_CELLS = 64  # per level; beyond this, the level is skipped


class GeoError(ValueError):
    pass


def parse_geom(value) -> dict:
    if isinstance(value, str):
        import json
        value = json.loads(value)
    if not isinstance(value, dict) or "type" not in value \
            or "coordinates" not in value:
        raise GeoError(f"not a GeoJSON geometry: {value!r}")
    t = value["type"]
    if t not in ("Point", "Polygon", "MultiPolygon"):
        raise GeoError(f"unsupported geometry type {t!r}")
    return value


def _polygons(g: dict) -> list[list[list[tuple[float, float]]]]:
    """Geometry -> list of polygons, each a list of rings (lon, lat)."""
    t = g["type"]
    if t == "Polygon":
        polys = [g["coordinates"]]
    elif t == "MultiPolygon":
        polys = g["coordinates"]
    else:
        return []
    return [[[(float(x), float(y)) for x, y in ring] for ring in poly]
            for poly in polys]


def _points(g: dict) -> list[tuple[float, float]]:
    """All vertices of a geometry."""
    if g["type"] == "Point":
        c = g["coordinates"]
        return [(float(c[0]), float(c[1]))]
    return [pt for poly in _polygons(g) for ring in poly for pt in ring]


def haversine_m(a: tuple[float, float], b: tuple[float, float]) -> float:
    lon1, lat1, lon2, lat2 = map(math.radians,
                                 (a[0], a[1], b[0], b[1]))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    h = math.sin(dlat / 2) ** 2 + \
        math.cos(lat1) * math.cos(lat2) * math.sin(dlon / 2) ** 2
    return 2 * EARTH_R_M * math.asin(min(1.0, math.sqrt(h)))


def _ring_contains(ring: list[tuple[float, float]],
                   pt: tuple[float, float]) -> bool:
    """Ray cast; boundary points count as inside (matches the
    reference's Contains on vertices closely enough for filters)."""
    x, y = pt
    inside = False
    n = len(ring)
    for i in range(n):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % n]
        if (y1 > y) != (y2 > y):
            xin = (x2 - x1) * (y - y1) / (y2 - y1) + x1
            if x < xin:
                inside = not inside
            elif x == xin:
                return True  # on an edge
        elif y1 == y == y2 and min(x1, x2) <= x <= max(x1, x2):
            return True  # on a horizontal edge
    return inside


def geom_contains_point(g: dict, pt: tuple[float, float]) -> bool:
    if g["type"] == "Point":
        c = g["coordinates"]
        return float(c[0]) == pt[0] and float(c[1]) == pt[1]
    for poly in _polygons(g):
        if not poly:
            continue
        if _ring_contains(poly[0], pt) and \
                not any(_ring_contains(h, pt) for h in poly[1:]):
            return True
    return False


def _segments(g: dict) -> Iterator[tuple[tuple[float, float],
                                         tuple[float, float]]]:
    for poly in _polygons(g):
        for ring in poly:
            n = len(ring)
            for i in range(n):
                yield ring[i], ring[(i + 1) % n]


def _seg_intersect(p1, p2, p3, p4) -> bool:
    def orient(a, b, c):
        v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        return 0 if v == 0 else (1 if v > 0 else -1)

    def on_seg(a, b, c):
        return min(a[0], b[0]) <= c[0] <= max(a[0], b[0]) and \
            min(a[1], b[1]) <= c[1] <= max(a[1], b[1])

    o1, o2 = orient(p1, p2, p3), orient(p1, p2, p4)
    o3, o4 = orient(p3, p4, p1), orient(p3, p4, p2)
    if o1 != o2 and o3 != o4:
        return True
    return (o1 == 0 and on_seg(p1, p2, p3)) or \
        (o2 == 0 and on_seg(p1, p2, p4)) or \
        (o3 == 0 and on_seg(p3, p4, p1)) or \
        (o4 == 0 and on_seg(p3, p4, p2))


def geom_intersects(a: dict, b: dict) -> bool:
    """Any shared point (ref geofilter.go intersects)."""
    if a["type"] == "Point":
        return geom_contains_point(b, _points(a)[0])
    if b["type"] == "Point":
        return geom_contains_point(a, _points(b)[0])
    if any(geom_contains_point(b, p) for p in _points(a)):
        return True
    if any(geom_contains_point(a, p) for p in _points(b)):
        return True
    segs_b = list(_segments(b))
    return any(_seg_intersect(s1, s2, t1, t2)
               for s1, s2 in _segments(a) for t1, t2 in segs_b)


def geom_within(a: dict, b: dict) -> bool:
    """a entirely inside b: every vertex of a inside b and no edge
    crossings (ref geofilter.go within)."""
    if not all(geom_contains_point(b, p) for p in _points(a)):
        return False
    if a["type"] == "Point":
        return True
    segs_b = list(_segments(b))
    return not any(_seg_intersect(s1, s2, t1, t2)
                   for s1, s2 in _segments(a) for t1, t2 in segs_b)


def min_distance_m(g: dict, pt: tuple[float, float]) -> float:
    """Distance from pt to the geometry (0 if inside); vertex-based for
    polygon boundaries (adequate at filter granularity)."""
    if g["type"] != "Point" and geom_contains_point(g, pt):
        return 0.0
    return min(haversine_m(p, pt) for p in _points(g))


# -- cell covers (the index layer) -------------------------------------------


def _cells_per_deg(level: int) -> float:
    return 2.0 ** (level - 8)  # level 8 = 1 cell / degree


def _cell_of(pt: tuple[float, float], level: int) -> tuple[int, int]:
    cpd = _cells_per_deg(level)
    return int((pt[0] + 180.0) * cpd), int((pt[1] + 90.0) * cpd)


def _bbox(g: dict) -> tuple[float, float, float, float]:
    pts = _points(g)
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    return min(xs), min(ys), max(xs), max(ys)


def _bbox_cells(bbox, level: int) -> list[tuple[int, int]]:
    x0, y0 = _cell_of((bbox[0], bbox[1]), level)
    x1, y1 = _cell_of((bbox[2], bbox[3]), level)
    if (x1 - x0 + 1) * (y1 - y0 + 1) > _MAX_CELLS:
        return []
    return [(cx, cy) for cx in range(x0, x1 + 1)
            for cy in range(y0, y1 + 1)]


def cover_tokens(g: dict) -> list[str]:
    """Index-time cover: the geometry's bbox cells at every level where
    the cover stays under _MAX_CELLS (ref s2index.go indexCells: cover
    + ancestor cells)."""
    bbox = _bbox(g)
    toks = set()
    for level in range(MIN_LEVEL, MAX_LEVEL + 1):
        for cx, cy in _bbox_cells(bbox, level):
            toks.add(f"{level}/{cx}/{cy}")
    return sorted(toks)


def query_tokens(bbox: tuple[float, float, float, float]) -> list[str]:
    """Query-time cover of a search region: cells of the region at the
    finest level that stays under _MAX_CELLS, plus every coarser
    level's cells (the ancestor lookups — a large stored polygon is
    only indexed at coarse levels)."""
    toks: set[str] = set()
    for level in range(MIN_LEVEL, MAX_LEVEL + 1):
        cells = _bbox_cells(bbox, level)
        if not cells:
            break
        for cx, cy in cells:
            toks.add(f"{level}/{cx}/{cy}")
    return sorted(toks)


def expand_bbox_m(pt: tuple[float, float], meters: float
                  ) -> tuple[float, float, float, float]:
    """Bounding box of a circle around pt (for near())."""
    dlat = math.degrees(meters / EARTH_R_M)
    coslat = max(0.01, math.cos(math.radians(pt[1])))
    dlon = math.degrees(meters / (EARTH_R_M * coslat))
    return pt[0] - dlon, pt[1] - dlat, pt[0] + dlon, pt[1] + dlat
