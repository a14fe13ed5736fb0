"""Render configuration: the JAX package's jax-free ``config`` module, so
that one config object drives either package. Callers of the port take
these names from here."""

from gpupathtracer_tpu.config import (CameraConfig, RenderConfig,
                                      load_scene_txt)

__all__ = ["CameraConfig", "RenderConfig", "load_scene_txt"]
