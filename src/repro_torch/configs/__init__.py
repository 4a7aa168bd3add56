from .base import SHAPES, MLACfg, MambaCfg, ModelConfig, MoECfg, ShapeCell, cell_applicable, shape_by_name
from .registry import get_config, get_smoke_config, list_archs
