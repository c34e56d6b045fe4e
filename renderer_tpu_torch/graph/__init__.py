"""Diagnostics of the frame plan (``renderer_tpu.graph``)."""
