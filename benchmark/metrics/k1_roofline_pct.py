"""k1_roofline_pct: kernel 1's camera call (``raster_prep_kernel`` and
``raster_walk_kernel`` under the eager frame's ``forward.raster``) against
its bound by bytes: each triangle of the frame's culled soup read once at
the 88 bytes of record a pixel test reads, the visibility (depth and
triangle id) written once, at the H100's 3.35 TB/s."""

from benchmark.harness.roofline import raster_bytes, roofline_pct

UNIT = "%"


def read(run):
    t = run["trace"]
    if not t or t.get("device_kind") != "cuda" or not t.get("k1_ms"):
        return None
    n_bytes = raster_bytes(round(t["k1_triangles"]), t["width"], t["height"])
    return roofline_pct(n_bytes, t["k1_ms"] * 1e-3)
