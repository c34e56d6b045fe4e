"""Utilities (``renderer_tpu.utils``)."""
