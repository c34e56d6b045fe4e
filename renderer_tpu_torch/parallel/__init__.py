"""The split frame (``renderer_tpu.parallel``): the frame plan run over a
mesh of shards, geometry sharded by instance, the culled draw stream
gathered once, raster and shade sharded by rows with halo rows exchanged
between neighbouring shards, and the image rows gathered at the end
(``Renderer(spmd_mesh=...)``, ``passes/pipeline.py``)."""

from renderer_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    Shard,
    current_shard,
    make_mesh,
    render_frame_spmd,
    run_shards,
)
