"""The model API (``api.build_model``), the configuration and the
dry run's shapes, as ``repro.models``."""
from .api import Model, build_model
from .common import MeshCtx, ModelConfig, MoECfg, ShapeCfg, SHAPES, \
    shape_applicable

__all__ = ["Model", "build_model", "MeshCtx", "ModelConfig", "MoECfg",
           "ShapeCfg", "SHAPES", "shape_applicable"]
