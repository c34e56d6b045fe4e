"""Constants of the rasterization specification (``renderer_tpu.ops.raster_spec``).

The specification itself (clipless homogeneous edge functions, the
top-left fill rule, per-pixel w > 0 and 0 <= z <= 1, the lower triangle id
winning a depth tie) is written out in the JAX package's
``renderer_tpu/ops/raster_spec.py``; the port follows it and keeps its own
copy of the constants, so that it imports nothing of the JAX package.
"""

# det(M) sign that corresponds to a front-facing (glTF CCW) triangle.
FRONT_DET_SIGN = -1.0

# Depth buffer clear value (far plane).
DEPTH_CLEAR = 1.0

# tri_id value for "no triangle" in visibility buffers.
NO_TRIANGLE = -1
