"""The table of peaks and the byte counts of the kernels the benchmark
rates against them."""

from __future__ import annotations

# NVIDIA H100 SXM, the data sheet's HBM3 bandwidth at the card's full power
H100_HBM_BYTES_PER_S = 3.35e12

# kernel 1's camera call: the record columns a pixel test reads per
# triangle (edges 0..8, z 9..11, w 12..14, bbox 15..18, top-left 19..21:
# 22 floats), and the visibility it writes per pixel (depth f32, triangle
# id i32). Both come from the frame's culled soup and its outputs, never
# from the kernel's own bin lists, so the count holds for any raster.
RASTER_TRI_BYTES = 22 * 4
RASTER_PIXEL_BYTES = 4 + 4


def raster_bytes(n_triangles: int, width: int, height: int) -> int:
    """Bytes a camera raster must move at least: each culled triangle read
    once, the visibility buffer written once."""
    return n_triangles * RASTER_TRI_BYTES + width * height * RASTER_PIXEL_BYTES


def roofline_pct(n_bytes: float, seconds: float, bandwidth: float = H100_HBM_BYTES_PER_S):
    """Share (%) of the bandwidth bound: the least time by bytes over the
    time taken; None without a time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * (n_bytes / bandwidth) / seconds
