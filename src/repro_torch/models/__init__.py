from repro_torch.models.config import ModelConfig, ShapeConfig, SHAPES
from repro_torch.models.model import LM

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "LM"]
