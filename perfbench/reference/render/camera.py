"""Camera model of the reference viewer, batched.

Counterpart of `state_policy_diffusionmodel_tpu/render/camera.py`: zoom
SCALE*ZOOM = 16.2, the car held at window (W/2, H/4), rotation following the
velocity heading when |v| > 0.5 (else the hull angle), the 1000x800 window
squeezed onto the 96x96 state image and flipped by the glReadPixels
readback (car_racing.py:498-599). Scroll and angle broadcast against the
leading axes of the points.
"""

from __future__ import annotations

import torch

from ..physics.car import sqrt

STATE_W = 96
STATE_H = 96
WINDOW_W = 1000.0
WINDOW_H = 800.0
SCALE = 6.0
ZOOM = 2.7
CAM_ZOOM = SCALE * ZOOM  # 16.2


def camera_angle(hull_angle: torch.Tensor,
                 hull_vel: torch.Tensor) -> torch.Tensor:
    """car_racing.py:525-528; hull_angle (B,), hull_vel (B, 2)."""
    vx, vy = hull_vel[..., 0], hull_vel[..., 1]
    speed = sqrt(vx * vx + vy * vy)
    return torch.where(speed > 0.5, torch.atan2(vx, vy), -hull_angle)


def world_to_window(p: torch.Tensor, scroll: torch.Tensor,
                    angle: torch.Tensor) -> torch.Tensor:
    """World -> logical window coordinates (the car lands at (W/2, H/4))."""
    c, s = torch.cos(angle), torch.sin(angle)
    rel = p - scroll
    rx = CAM_ZOOM * (c * rel[..., 0] - s * rel[..., 1])
    ry = CAM_ZOOM * (s * rel[..., 0] + c * rel[..., 1])
    return torch.stack([rx + WINDOW_W / 2, ry + WINDOW_H / 4], -1)


def window_to_world(w: torch.Tensor, scroll: torch.Tensor,
                    angle: torch.Tensor) -> torch.Tensor:
    """Inverse of `world_to_window`."""
    c, s = torch.cos(angle), torch.sin(angle)
    rx = (w[..., 0] - WINDOW_W / 2) / CAM_ZOOM
    ry = (w[..., 1] - WINDOW_H / 4) / CAM_ZOOM
    px = c * rx + s * ry
    py = -s * rx + c * ry
    return torch.stack([px + scroll[..., 0], py + scroll[..., 1]], -1)


def pixel_window_centers(device) -> torch.Tensor:
    """(96, 96, 2) window coordinates of each pixel centre of the flipped
    state image: pixel (row r, col c) is framebuffer pixel (c, 95 - r)."""
    r = torch.arange(STATE_H, device=device)
    c = torch.arange(STATE_W, device=device)
    rr, cc = torch.meshgrid(r, c, indexing="ij")
    wx = (cc + 0.5) * (WINDOW_W / STATE_W)
    wy = (STATE_H - 1 - rr + 0.5) * (WINDOW_H / STATE_H)
    return torch.stack([wx, wy], -1).to(torch.float32)


def pixel_world_coords(scroll: torch.Tensor,
                       angle: torch.Tensor) -> torch.Tensor:
    """(..., 96, 96, 2) world coordinates of every pixel centre of the
    state image, for scroll (..., 2) and angle (...)."""
    scroll = torch.as_tensor(scroll)
    angle = torch.as_tensor(angle, device=scroll.device)
    return window_to_world(pixel_window_centers(scroll.device),
                           scroll[..., None, None, :],
                           angle[..., None, None])
