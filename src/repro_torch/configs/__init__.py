from .base import SHAPES, ArchConfig, ShapeCell, get_arch, list_archs

__all__ = ["SHAPES", "ArchConfig", "ShapeCell", "get_arch", "list_archs"]
