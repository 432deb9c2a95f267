"""Orbit camera: state and derivations replicating the reference app.

The camera always looks at the origin; the basis is derived two ways:

  * initial construction (utils.h:41-46):
      front = normalize(-pos); right = normalize(cross(front, world_up));
      up = normalize(cross(right, front))
  * per-frame re-derivation after input (myApp.cu:1106-1112):
      front = normalize(-pos); right = normalize(cross(prev_up, front));
      up = cross(front, right)            # NOT normalized

``top_left`` always uses the orthographic formula (utils.h:68-70), even in
conic mode; replicated on purpose.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from ..utils import transforms as T
from ..utils.device import resolve_device

_f32 = torch.float32
_FIELDS = ("position", "front", "right", "up", "top_left")


@dataclasses.dataclass(frozen=True)
class Camera:
    """Position, basis and the virtual screen's top-left corner, each [3]."""

    position: torch.Tensor
    front: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    top_left: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.position.device

    def to(self, device) -> "Camera":
        return Camera(*(getattr(self, k).to(device) for k in _FIELDS))

    @staticmethod
    def initial(
        position=(0.0, 0.0, 1.0),
        world_up=(0.0, 1.0, 0.0),
        screen_w: float = 2.0,
        screen_h: float = 2.0,
        device=None,
    ) -> "Camera":
        """AppData-construction-style derivation (utils.h:41-46,68-70)."""
        dev = resolve_device(device)
        pos = torch.as_tensor(position, dtype=_f32, device=dev)
        front = T.normalize(-pos)
        right = T.normalize(
            T.cross(front, torch.as_tensor(world_up, dtype=_f32, device=dev)))
        up = T.normalize(T.cross(right, front))
        top_left = pos + (screen_w / 2.0) * (-right) + up * (screen_h / 2.0)
        return Camera(pos, front, right, up, top_left)

    def rederive(self, screen_w: float = 2.0, screen_h: float = 2.0) -> "Camera":
        """processInput-style re-derivation (myApp.cu:1106-1112)."""
        front = T.normalize(-self.position)
        right = T.normalize(T.cross(self.up, front))
        up = T.cross(front, right)
        top_left = (
            self.position + (screen_w / 2.0) * (-right) + up * (screen_h / 2.0)
        )
        return Camera(self.position, front, right, up, top_left)

    def orbit(
        self,
        yaw_rad=0.0,
        pitch_rad=0.0,
        zoom=0.0,
        screen_w: float = 2.0,
        screen_h: float = 2.0,
    ) -> "Camera":
        """WASD/QE orbit step (myApp.cu:1088-1112): positive pitch = W
        (about -right), positive yaw = A (about up), zoom along front."""
        dev = self.device
        rot = T.matmul(T.rotate(T.identity(dev), pitch_rad, -self.right),
                       T.rotation(yaw_rad, self.up))
        trans = T.translate(
            T.identity(dev),
            self.front * torch.as_tensor(zoom, dtype=_f32, device=dev))
        pos = T.apply(T.matmul(rot, trans), self.position)
        return dataclasses.replace(self, position=pos).rederive(
            screen_w, screen_h)

    def look_at_origin_view(self) -> torch.Tensor:
        """glm::lookAt(position, origin, up): the a5 view matrix
        (kernel.cu:1197-1198)."""
        return T.look_at(self.position, torch.zeros_like(self.position),
                         self.up)


def save_preset(camera: Camera, path: str) -> None:
    """Persist a camera preset to JSON (the reference's key-M save,
    myApp.cu:1160-1175)."""
    with open(path, "w") as f:
        json.dump({k: getattr(camera, k).cpu().tolist() for k in _FIELDS},
                  f, indent=2)


def load_preset(path: str, device=None) -> Camera:
    """Restore a preset saved by :func:`save_preset` (key X,
    myApp.cu:1178-1186)."""
    dev = resolve_device(device)
    with open(path) as f:
        d = json.load(f)
    return Camera(*(torch.as_tensor(d[k], dtype=_f32, device=dev)
                    for k in _FIELDS))


def reset_preset(device=None) -> Camera:
    """The saved oblique camera preset (utils.h:77-81) used by key X."""
    dev = resolve_device(device)
    vals = (
        [0.456607, 0.693644, -0.55711],
        [-0.456606, -0.693643, 0.557109],
        [-0.19427, -0.533349, -0.823285],
        [0.868199, -0.484147, 0.108777],
        [1.51908, 0.742847, 0.374952],
    )
    return Camera(*(torch.as_tensor(v, dtype=_f32, device=dev) for v in vals))


def default_camera(device=None) -> Camera:
    """Initial camera at (0,0,1) looking at the origin (utils.h:41-46)."""
    return Camera.initial(device=device)
