"""renderer_tpu_torch — the PyTorch + CUDA port of ``renderer_tpu``.

Module names follow the JAX package (``renderer_tpu``), which stays the
reference: each port module sits at the same path as its counterpart.
Plain tensor code is PyTorch; every kernel the JAX package wrote in Pallas
for the TPU is a kernel written by hand for Hopper under ``csrc/``, built at
first use into ``_build/``. This package imports neither ``jax`` nor
anything of the JAX package.

Ported so far (the base frame that ``bench.py`` times, exact shading path):
scene build, prepare, cull, the tile rasterizer (``ops/raster_cuda.py``),
PBR shading with textures and normal maps, edge AA, and the ``Renderer``;
and the ``rt`` switch's ray-traced shadows (``ops/rt_grid.py``, the
occlusion walk in ``ops/occlusion_cuda.py``). Entry points put their
tensors on the CUDA card unless given ``device=`` (``device.py``).
"""

__version__ = "0.1.0"
