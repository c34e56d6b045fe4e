"""Frame graph declarations (renderer_tpu.passes)."""
