from .checkpointer import (ShapeDtype, latest_step, prune, restore,
                           restore_latest, save, stand_ins)

__all__ = ["save", "restore", "restore_latest", "latest_step", "prune",
           "ShapeDtype", "stand_ins"]
