"""Registry of the 10 assigned architectures and their dry-run cells."""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES

from repro_torch.configs.command_r_35b import CONFIG as _command_r
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _danube
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2
from repro_torch.configs.smollm_135m import CONFIG as _smollm
from repro_torch.configs.whisper_medium import CONFIG as _whisper
from repro_torch.configs.llama4_maverick_400b import CONFIG as _llama4
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _command_r, _danube, _starcoder2, _smollm, _whisper,
        _llama4, _mixtral, _zamba2, _qwen2vl, _mamba2,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    # tolerate hyphen/underscore + prefix matches for CLI ergonomics
    norm = name.replace("_", "-").lower()
    for key, cfg in ARCHS.items():
        if key.lower() == norm or key.lower().startswith(norm):
            return cfg
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def list_archs() -> List[str]:
    return sorted(ARCHS)


def cells_for(arch: ModelConfig) -> List[Tuple[ModelConfig, ShapeConfig, str]]:
    """All (arch, shape, status) dry-run cells.  status is "run" or a skip
    reason (skips are sanctioned by the assignment and noted in DESIGN.md)."""
    cells = []
    for shape in SHAPES:
        status = "run"
        if shape.name == "long_500k" and not arch.sub_quadratic:
            status = "skip: pure full-attention arch (needs sub-quadratic)"
        cells.append((arch, shape, status))
    return cells


def all_cells() -> List[Tuple[ModelConfig, ShapeConfig, str]]:
    out = []
    for name in list_archs():
        out.extend(cells_for(ARCHS[name]))
    return out
