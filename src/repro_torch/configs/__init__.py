from repro_torch.configs.base import (
    CheckpointPlan,
    MemoryPlan,
    MeshPlan,
    ModelConfig,
    MULTI_POD,
    PipelinePlan,
    RunConfig,
    ShapeConfig,
    SHAPES,
    SHAPES_BY_NAME,
    SINGLE_POD,
    TrainConfig,
)
from repro_torch.configs.registry import ARCHS, get_arch, list_archs, cells_for

__all__ = [
    "CheckpointPlan", "MemoryPlan", "MeshPlan", "ModelConfig", "MULTI_POD",
    "PipelinePlan", "RunConfig", "ShapeConfig", "SHAPES", "SHAPES_BY_NAME",
    "SINGLE_POD", "TrainConfig", "ARCHS", "get_arch", "list_archs",
    "cells_for",
]
