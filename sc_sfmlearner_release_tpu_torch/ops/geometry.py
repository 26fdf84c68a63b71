"""Projective geometry of SC-Depth: backproject, transform, project, sample.

The counterpart of the JAX package's ``ops/geometry.py``, with its layouts:

  images      [B, H, W, C]
  depth maps  [B, H, W, 1]
  intrinsics  [B, 3, 3]
  pose vec    [B, 6] = (tx, ty, tz, rx, ry, rz)
  pose mat    [B, 3, 4] (target -> source)

The contractions are fp32 and precision-critical; the entry points turn
TF32 off (``disable_tf32``), the analogue of JAX's ``Precision.HIGHEST``.
There is one sampler, the warp kernel of ``ops/warp.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .warp import warp_sample


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel coordinates ``[H, W, 3]`` with entries (x, y, 1)."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Inverse of ``[..., 3, 3]`` matrices by their adjugate: elementwise, with
    no library solver and no host synchronization (``torch.linalg.inv``
    checks its result on the host)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a, co_b, co_c = e * i - f * h, f * g - d * i, d * h - e * g
    adj = torch.stack([
        co_a, c * h - b * i, b * f - c * e,
        co_b, a * i - c * g, c * d - a * f,
        co_c, b * g - a * h, a * e - b * d,
    ], dim=-1).reshape(m.shape)
    det = a * co_a + b * co_b + c * co_c
    return adj / det[..., None, None]


def pixel2cam(depth: torch.Tensor, intrinsics_inv: torch.Tensor) -> torch.Tensor:
    """Backproject ``depth`` ``[B, H, W]`` into camera points ``[B, H, W, 3]``."""
    _, h, w = depth.shape
    grid = pixel_grid(h, w, depth.dtype, depth.device)
    rays = torch.einsum("bij,hwj->bhwi", intrinsics_inv, grid)
    return rays * depth[..., None]


def cam2pixel(
    cam_coords: torch.Tensor, proj: torch.Tensor, padding_mode: str = "zeros"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project camera points ``[B, H, W, 3]`` with ``proj`` ``[B, 3, 4]``.

    Returns (normalized coords ``[B, H, W, 2]``, computed depth
    ``[B, H, W, 1]``). Depth is clamped to >= 1e-3; with ``"zeros"`` padding
    out-of-frame coordinates are pushed to 2 so the zero-padded sample never
    blends frame content with padding.
    """
    _, h, w, _ = cam_coords.shape
    rot, tr = proj[:, :, :3], proj[:, :, 3]
    p = torch.einsum("bij,bhwj->bhwi", rot, cam_coords) + tr[:, None, None, :]
    x, y = p[..., 0], p[..., 1]
    z = torch.clamp(p[..., 2], min=1e-3)

    x_norm = 2.0 * (x / z) / (w - 1.0) - 1.0
    y_norm = 2.0 * (y / z) / (h - 1.0) - 1.0
    if padding_mode == "zeros":
        two = torch.full((), 2.0, dtype=x_norm.dtype, device=x_norm.device)
        x_norm = torch.where(x_norm.abs() > 1.0, two, x_norm)
        y_norm = torch.where(y_norm.abs() > 1.0, two, y_norm)
    return torch.stack([x_norm, y_norm], dim=-1), z[..., None]


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles ``[B, 3]`` (x, y, z, radians) -> ``[B, 3, 3]``, R = Rx Ry Rz."""
    x, y, z = angle[:, 0], angle[:, 1], angle[:, 2]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    zeros, ones = torch.zeros_like(z), torch.ones_like(z)
    zmat = torch.stack([cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones], 1)
    ymat = torch.stack([cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy], 1)
    xmat = torch.stack([ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx], 1)
    as3 = lambda m: m.reshape(-1, 3, 3)
    return as3(xmat) @ as3(ymat) @ as3(zmat)


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """3-parameter quaternion ``[B, 3]`` (w from normalizing (1, x, y, z))
    -> rotation ``[B, 3, 3]``."""
    b = quat.shape[0]
    q = torch.cat([torch.ones((b, 1), dtype=quat.dtype, device=quat.device), quat], 1)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=1,
    ).reshape(b, 3, 3)


def pose_vec2mat(vec: torch.Tensor, rotation_mode: str = "euler") -> torch.Tensor:
    """6-DoF pose ``[B, 6]`` -> ``[B, 3, 4]`` transform."""
    translation = vec[:, :3, None]
    rot = vec[:, 3:]
    if rotation_mode == "euler":
        rot_mat = euler2mat(rot)
    elif rotation_mode == "quat":
        rot_mat = quat2mat(rot)
    else:
        raise ValueError(f"unknown rotation_mode: {rotation_mode}")
    return torch.cat([rot_mat, translation], dim=2)


def pose_mat4(mat34: torch.Tensor) -> torch.Tensor:
    """Lift ``[..., 3, 4]`` to homogeneous ``[..., 4, 4]``."""
    bottom = torch.zeros(mat34.shape[:-2] + (1, 4), dtype=mat34.dtype, device=mat34.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([mat34, bottom], dim=-2)


def invert_pose_mat4(mat4: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid ``[..., 4, 4]`` transform."""
    r_t = mat4[..., :3, :3].transpose(-1, -2)
    t_inv = -(r_t @ mat4[..., :3, 3:])
    return pose_mat4(torch.cat([r_t, t_inv], dim=-1))


def project_pixel_coords(
    depth: torch.Tensor, pose: torch.Tensor, intrinsics: torch.Tensor,
    padding_mode: str = "zeros",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backproject target pixels with ``depth`` ``[B, H, W, 1]``, transform by
    ``pose`` ``[B, 6]``, project into the source frame. Returns (coords
    ``[B, H, W, 2]``, computed depth ``[B, H, W, 1]``)."""
    cam_coords = pixel2cam(depth[..., 0], inv3x3(intrinsics))
    proj = intrinsics @ pose_vec2mat(pose)
    return cam2pixel(cam_coords, proj, padding_mode)


def inverse_warp(
    img: torch.Tensor, depth: torch.Tensor, pose: torch.Tensor,
    intrinsics: torch.Tensor, rotation_mode: str = "euler",
    padding_mode: str = "zeros",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-output warp of ``img`` ``[B, H, W, 3]`` by target ``depth``
    ``[B, H, W]``. Returns (warped image, valid mask ``[B, H, W]`` bool)."""
    cam_coords = pixel2cam(depth, inv3x3(intrinsics))
    proj = intrinsics @ pose_vec2mat(pose, rotation_mode)
    coords, _ = cam2pixel(cam_coords, proj, padding_mode)
    projected = warp_sample(img.contiguous(), coords.contiguous(), padding_mode)
    valid = coords.abs().amax(dim=-1) <= 1.0
    return projected, valid


def inverse_warp2(
    img: torch.Tensor, depth: torch.Tensor, ref_depth: torch.Tensor,
    pose: torch.Tensor, intrinsics: torch.Tensor, padding_mode: str = "zeros",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warp a source view (image + depth) into the target frame.

    Args:
      img: source image ``[B, H, W, 3]``.
      depth: target depth ``[B, H, W, 1]``.
      ref_depth: source depth ``[B, H, W, 1]``.
      pose: ``[B, 6]`` target -> source (euler).
      intrinsics: ``[B, 3, 3]``.

    Returns (projected image ``[B, H, W, 3]``, valid mask ``[B, H, W, 1]``
    float, projected source depth ``[B, H, W, 1]``, computed depth
    ``[B, H, W, 1]``).

    The source image is sampled without gradient (it is camera data); the
    source depth and the coordinates carry one. Depth and RGB are packed
    into one ``[B, H, W, 4]`` source so one kernel launch samples both.
    """
    coords, computed_depth = project_pixel_coords(depth, pose, intrinsics, padding_mode)
    packed = torch.cat([ref_depth.float(), img.detach().float()], dim=-1)
    sampled = warp_sample(packed, coords.contiguous(), padding_mode)
    projected_depth = sampled[..., 0:1].to(ref_depth.dtype)
    projected_img = sampled[..., 1:].to(img.dtype)
    valid = (coords.abs().amax(dim=-1) <= 1.0).to(img.dtype)
    return projected_img, valid[..., None], projected_depth, computed_depth
