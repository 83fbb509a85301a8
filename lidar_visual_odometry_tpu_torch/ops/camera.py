"""Pinhole camera model with radial-tangential distortion, ported from
``lidar_visual_odometry_tpu/ops/camera.py`` (≡ the reference's
``PinholeModel``, ``src/vloam/PinholeModel.cpp``): projection ``xyz_to_uv``
(``:98-153``), bounds test ``is_in_image`` (``:79-91``), over (..., 3)
tensors, and the undistortion of points (iterative) and of images (a source
map, ``:27-28``, and a bilinear remap, ``:192-200``). The intrinsics are plain
floats and the distortion a (5,) tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.device import resolve_device


@dataclass(frozen=True)
class Pinhole:
    """Intrinsics; ``dist`` holds k1 k2 p1 p2 k3."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    dist: torch.Tensor

    @staticmethod
    def from_config(cam, device="cuda") -> "Pinhole":
        """The camera of a ``CameraConfig``, its distortion on ``device``
        (the card unless the caller asks for the CPU; raises without a
        card)."""
        device = resolve_device(device)
        return Pinhole(
            float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
            cam.width, cam.height,
            torch.tensor([cam.d0, cam.d1, cam.d2, cam.d3, cam.d4], dtype=torch.float32,
                         device=device),
        )


def distort(cam: Pinhole, xn: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coords (..., 2)."""
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def project(cam: Pinhole, xyz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points (..., 3) → pixel (..., 2) + in-front mask."""
    z = xyz[..., 2]
    safe_z = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    xn = xyz[..., :2] / safe_z[..., None]
    xd = distort(cam, xn)
    uv = torch.stack([cam.fx * xd[..., 0] + cam.cx, cam.fy * xd[..., 1] + cam.cy], dim=-1)
    return uv, z > 1e-6


def normalized(cam: Pinhole, uv: torch.Tensor) -> torch.Tensor:
    """Pixel (..., 2) → normalized plane coords (rectified input;
    featureTracking's (p−c)/f, featureTracking.cpp:286-290). The JAX package
    divides by traced intrinsics, so this stays a division (not a product
    with the reciprocal)."""
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1)


def is_in_image(cam: Pinhole, uv: torch.Tensor, boundary: float = 0.0,
                scale: float = 1.0) -> torch.Tensor:
    """Bounds test at pyramid level ``scale`` (PinholeModel.cpp:79-91)."""
    w = cam.width * scale
    h = cam.height * scale
    return ((uv[..., 0] >= boundary) & (uv[..., 0] < w - boundary)
            & (uv[..., 1] >= boundary) & (uv[..., 1] < h - boundary))


def undistort_points(cam: Pinhole, uv: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Invert the distortion of pixel coords (..., 2) by ``iters`` fixed-point
    steps."""
    xn0 = normalized(cam, uv)
    xn = xn0
    for _ in range(iters):
        xn = xn - (distort(cam, xn) - xn0)
    return torch.stack([cam.fx * xn[..., 0] + cam.cx, cam.fy * xn[..., 1] + cam.cy], dim=-1)


def undistort_rectify_map(cam: Pinhole) -> torch.Tensor:
    """(H, W, 2) source-pixel map for image undistortion (≡
    ``cv::initUndistortRectifyMap`` with new K = K): for each undistorted
    output pixel, the distorted source location to sample. On the device of
    ``cam.dist``."""
    dev = cam.dist.device
    v, u = torch.meshgrid(torch.arange(cam.height, dtype=torch.float32, device=dev),
                          torch.arange(cam.width, dtype=torch.float32, device=dev),
                          indexing="ij")
    xd = distort(cam, normalized(cam, torch.stack([u, v], dim=-1)))
    return torch.stack([cam.fx * xd[..., 0] + cam.cx, cam.fy * xd[..., 1] + cam.cy], dim=-1)


def undistort_image(img: torch.Tensor, map_uv: torch.Tensor) -> torch.Tensor:
    """Bilinear remap through ``undistort_rectify_map`` (≡
    ``PinholeModel::undistort_image``, ``cv::remap`` INTER_LINEAR); the
    border clamps."""
    from .image import bilinear

    return bilinear(img, map_uv)
