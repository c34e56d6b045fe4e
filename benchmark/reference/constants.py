"""Constants the frozen reference shares with the scene tables it reads:
the rasterization specification's and the scene layout's column numbers.
They describe the input data, so the reference keeps its own copy."""

from __future__ import annotations

# det(M) sign of a front-facing (glTF CCW) triangle
FRONT_DET_SIGN = -1.0
# depth buffer clear value (far plane)
DEPTH_CLEAR = 1.0
# tri_id of "no triangle" in visibility buffers
NO_TRIANGLE = -1

# the scene's tri_rec columns: [pos c0..c2 (9) | nrm (9) | uv (6) | tan xyzw (12)]
TR_POS = 0
TR_NRM = 9
TR_UV = 18
TR_TAN = 24
TR_COLS = 36
# the scene's cluster rows (the object-space sphere and normal cone per 32 triangles)
CLUSTER = 32
CL_CENTER = 0
CL_RADIUS = 3
CL_AXIS = 4
CL_COS = 7
CL_SIN = 8
CL_COUNT = 9
CL_COLS = 12

