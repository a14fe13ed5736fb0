from gpupathtracer_tpu_torch.scene.scenedata import (SceneData, SceneMeta,
                                                     load_scene, pack_scene,
                                                     scene_from_numpy)

__all__ = ["SceneData", "SceneMeta", "load_scene", "pack_scene",
           "scene_from_numpy"]
