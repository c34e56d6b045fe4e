"""The debug-AABB view (``renderer_tpu.ops.debug``): each visible
instance's mesh AABB as a solid box of 12 triangles, drawn in a flat
colour per instance."""

from __future__ import annotations

import torch

from renderer_tpu_torch.mathx.camera import _cross3
from renderer_tpu_torch.ops.geometry import TriangleSoup, _corner_map, mats44
from renderer_tpu_torch.scene.types import Scene

# outward-wound triangles over the unit box's corners, two per face: -x, +x,
# -y, +y, -z, +z. Corner index bits: 2 = x, 1 = y, 0 = z (set = +1).
_BOX_TRIS = (
    (0, 1, 3), (0, 3, 2),
    (4, 6, 7), (4, 7, 5),
    (0, 4, 5), (0, 5, 1),
    (2, 3, 7), (2, 7, 6),
    (0, 2, 6), (0, 6, 4),
    (1, 5, 7), (1, 7, 3),
)


def aabb_soup(scene: Scene, visible: torch.Tensor, clip_mats: torch.Tensor,
              model: torch.Tensor, capacity: int) -> TriangleSoup:
    """The box triangles of every instance in instance order, valid where
    the instance is visible, cut or zero-padded to ``capacity``. Boxes are
    built in object space from the mesh AABB and go through each
    instance's clip matrix; the normals are the face normals through its
    model matrix."""
    dev = visible.device
    clip_mats, model = mats44(clip_mats), mats44(model)
    mesh_id = scene.instances.mesh_id.long()
    n = mesh_id.shape[0]
    mn, mx = scene.meshes.mesh_aabb_min[mesh_id], scene.meshes.mesh_aabb_max[mesh_id]
    center = (mn + mx) * 0.5
    extent = (mx - mn) * 0.5
    bits = (torch.arange(8, device=dev)[:, None] >> torch.arange(2, -1, -1, device=dev)) & 1
    unit = bits.float() * 2.0 - 1.0  # (8, 3) corners in {-1, 1}
    corners = center[:, None, :] + extent[:, None, :] * unit[None]  # (N, 8, 3)
    # the triangles' corners as views of `corners`, stacked by one copy
    tri_pos = torch.stack([corners[:, c] for tri in _BOX_TRIS for c in tri], dim=1)
    tri_pos = tri_pos.reshape(n, 12, 3, 3)
    clip = _corner_map(tri_pos.reshape(n, 36, 3), clip_mats, True).reshape(n * 12, 3, 4)
    fn = _cross3(tri_pos[:, :, 1] - tri_pos[:, :, 0], tri_pos[:, :, 2] - tri_pos[:, :, 0])
    fn = _corner_map(fn, model, False)  # (N, 12, 3)
    t_total = n * 12
    soup = TriangleSoup(
        clip=clip,
        instance=torch.arange(n, device=dev).repeat_interleave(12),
        valid=visible.repeat_interleave(12),
        count=visible.sum(dtype=torch.int32) * 12,
        tri_idx=torch.zeros(t_total, dtype=torch.int64, device=dev),
        tex_lod=torch.zeros(t_total, dtype=torch.float32, device=dev),
        normal=fn[:, :, None, :].expand(n, 12, 3, 3).reshape(t_total, 3, 3),
        uv=torch.zeros((t_total, 3, 2), dtype=torch.float32, device=dev),
        tangent=torch.zeros((t_total, 3, 4), dtype=torch.float32, device=dev),
    )
    if t_total >= capacity:
        return soup._replace(**{f: getattr(soup, f)[:capacity] for f in soup._fields
                                if f != "count"})
    pad = capacity - t_total
    return soup._replace(**{
        f: torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        for f, x in soup._asdict().items() if f != "count"})


def instance_debug_colors(instance_ids: torch.Tensor) -> torch.Tensor:
    """(..., 3) colour per instance id: golden-ratio hue, HSV with s = 0.7,
    v = 0.9."""
    h = (instance_ids.float() * 0.61803398875) % 1.0
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    s, v = 0.7, 0.9
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = i.int() % 6

    def pick(*by_sector):
        out = by_sector[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, by_sector[k], out)
        return torch.as_tensor(out, dtype=torch.float32, device=h.device).expand(h.shape)

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)
