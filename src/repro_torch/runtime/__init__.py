from .fault_tolerance import (RunnerConfig, StepRunner,
                              suggest_checkpoint_interval)

__all__ = ["RunnerConfig", "StepRunner", "suggest_checkpoint_interval"]
