"""Scene configuration, asset ingest and the SceneTensors scene."""

from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.obj_loader import Mesh, load_obj
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    SceneTensors,
    build_scene_tensors,
    load_scene,
)

__all__ = [
    "RenderConfig",
    "Mesh",
    "load_obj",
    "SceneTensors",
    "build_scene_tensors",
    "load_scene",
]
