"""Per-stage operators (renderer_tpu.ops): geometry, raster, texture, PBR, AA."""
