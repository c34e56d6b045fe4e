"""Per-stage operators (renderer_tpu.ops): geometry, raster, texture, PBR, AA,
light cameras and ray-traced shadows, and the CUDA kernels' wrappers."""
