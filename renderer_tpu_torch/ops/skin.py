"""Linear-blend skinning and keyframe clips (``renderer_tpu.ops.skin``).

The pose pass samples every skin's active clip, builds the joint palettes
(world @ inverse bind) and rewrites the vertex pool's positions and
normals. The posed scene has no ``tri_rec`` (it caches rest-pose corners),
so its draw stream takes the per-corner expansion
(``geometry.expand_cull_sort_two_phase``).

The small matrix products are written as multiply-adds summed left to
right, never ``einsum``/``matmul``, so the CPU and the card round alike
and TF32 never enters.
"""

from __future__ import annotations

import torch

from renderer_tpu_torch.mathx.transforms import trs_matrix
from renderer_tpu_torch.scene.types import INTERP_CUBICSPLINE, INTERP_STEP, Scene, Skins


def set_active_clip(scene: Scene, skin: int, clip: int) -> Scene:
    """The scene with skin ``skin`` playing clip ``clip``."""
    active = scene.skins.active_clip.clone()
    active[skin] = clip
    return scene._replace(skins=scene.skins._replace(active_clip=active))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) @ (..., 4, 4), the inner sum taken left to right."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k : k + 1] * b[..., k : k + 1, :]
    return out


def sample_clips(skins: Skins, time: torch.Tensor) -> torch.Tensor:
    """Every skin's active clip at ``time`` (a () tensor, looping) ->
    joint palettes (S, J, 4, 4) = world_joint @ inverse_bind.

    LINEAR takes nlerp for quaternions (hemisphere-corrected), STEP the
    earlier key, CUBICSPLINE the hermite spline with per-key in/out
    tangents (quaternion components raw, then normalized)."""
    s_cap, j_cap = skins.parents.shape
    ar = torch.arange(s_cap, device=time.device)
    ci = torch.minimum(torch.clamp(skins.active_clip, min=0),
                       torch.clamp(skins.clip_count - 1, min=0)).long()

    def sel(arr):  # (S, C, ...) -> (S, ...)
        return arr[ar, ci]

    times, counts, durs, interp = (sel(skins.key_times), sel(skins.key_count),
                                   sel(skins.duration), sel(skins.interp))
    tt = torch.where(durs > 0, torch.remainder(time, torch.where(durs > 0, durs, 1.0)), 0.0)
    hi = torch.searchsorted(times.contiguous(), tt[:, None].contiguous(), right=True)[:, 0]
    hi = torch.minimum(torch.clamp(hi, min=1), torch.clamp(counts.long() - 1, min=1))
    lo = hi - 1
    t0, t1 = times[ar, lo], times[ar, hi]
    dt = t1 - t0
    f = torch.clamp(torch.where(dt > 0, (tt - t0) / torch.where(dt > 0, dt, 1.0), 0.0), 0.0, 1.0)
    dt = torch.clamp(dt, min=0.0)

    def take(arr, idx):  # (S, K, ...) -> (S, ...)
        return arr[ar, idx]

    def hermite(v0, b0, v1, a1, fk, dtk):
        f2 = fk * fk
        f3 = f2 * fk
        return ((2 * f3 - 3 * f2 + 1) * v0 + dtk * (f3 - 2 * f2 + fk) * b0
                + (-2 * f3 + 3 * f2) * v1 + dtk * (f3 - f2) * a1)

    def interpolate(vals, v_in, v_out, extra_dims):
        """(S, C, K, J, ...) keys -> (S, J, ...) in each skin's mode."""
        v = sel(vals)
        v0, v1 = take(v, lo), take(v, hi)
        b0, a1 = take(sel(v_out), lo), take(sel(v_in), hi)
        shape = (s_cap,) + (1,) * extra_dims
        fk, dtk = f.reshape(shape), dt.reshape(shape)
        linear = v0 + (v1 - v0) * fk
        mode = interp.reshape(shape)
        out = torch.where(mode == INTERP_STEP, v0, linear)
        return torch.where(mode == INTERP_CUBICSPLINE, hermite(v0, b0, v1, a1, fk, dtk), out)

    trans = interpolate(skins.key_t, skins.key_t_in, skins.key_t_out, 2)
    scale = interpolate(skins.key_s, skins.key_s_in, skins.key_s_out, 1)

    r_sel = sel(skins.key_r)
    r0, r1 = take(r_sel, lo), take(r_sel, hi)
    fk, dtk = f[:, None, None], dt[:, None, None]
    dot = (r0 * r1).sum(dim=-1, keepdim=True)
    rot_lin = r0 + (torch.where(dot < 0, -r1, r1) - r0) * fk
    rot_cub = hermite(r0, take(sel(skins.key_r_out), lo), r1, take(sel(skins.key_r_in), hi),
                      fk, dtk)
    mode_r = interp[:, None, None]
    rot = torch.where(mode_r == INTERP_STEP, r0, rot_lin)
    rot = torch.where(mode_r == INTERP_CUBICSPLINE, rot_cub, rot)
    rot = rot / torch.clamp(torch.linalg.vector_norm(rot, dim=-1, keepdim=True), min=1e-8)

    local = trs_matrix(trans, rot, scale)  # (S, J, 4, 4)
    # world = the parent chain (parents come before their children)
    eye = torch.eye(4, dtype=torch.float32, device=time.device).expand(s_cap, 4, 4)
    worlds = eye[:, None].expand(s_cap, j_cap, 4, 4).clone()
    for j in range(j_cap):
        p = skins.parents[:, j].long()
        parent_m = torch.where((p >= 0)[:, None, None], worlds[ar, torch.clamp(p, min=0)], eye)
        worlds[:, j] = _matmul(parent_m, local[:, j])
    return _matmul(worlds, skins.inverse_bind)


def pose_scene(scene: Scene, time: torch.Tensor) -> Scene:
    """The scene with its skinned vertices posed at ``time`` (a () tensor):
    linear-blend skinning over the vertex pool; rigid vertices keep their
    rest data. The posed scene carries no ``tri_rec`` and no
    ``cluster_data`` (both describe the rest pose)."""
    skins = scene.skins
    palettes = sample_clips(skins, time)  # (S, J, 4, 4)
    s_cap, j_cap = palettes.shape[:2]
    flat = palettes.reshape(s_cap * j_cap, 4, 4)

    vskin = skins.vertex_skin.long()
    skinned = skins.weights.sum(dim=-1) > 1e-6
    jidx = torch.clamp(vskin, min=0)[:, None] * j_cap + torch.clamp(skins.joints.long(), 0,
                                                                     j_cap - 1)
    mats = flat[jidx]  # (V, 4, 4, 4)
    w = skins.weights
    blend = w[:, 0, None, None] * mats[:, 0]
    for k in range(1, 4):
        blend = blend + w[:, k, None, None] * mats[:, k]

    pos, nrm = scene.meshes.positions, scene.meshes.normals

    def apply(m, v, rows, translate):
        out = m[:, :rows, 0] * v[:, 0, None] + m[:, :rows, 1] * v[:, 1, None]
        out = out + m[:, :rows, 2] * v[:, 2, None]
        return out + m[:, :rows, 3] if translate else out

    posed = apply(blend, pos, 3, True)
    posed_n = apply(blend, nrm, 3, False)
    posed_n = posed_n / torch.clamp(torch.linalg.vector_norm(posed_n, dim=-1, keepdim=True),
                                    min=1e-8)
    use = (skinned & (vskin >= 0))[:, None]
    return scene._replace(meshes=scene.meshes._replace(
        positions=torch.where(use, posed, pos), normals=torch.where(use, posed_n, nrm),
        tri_rec=None, cluster_data=None))
