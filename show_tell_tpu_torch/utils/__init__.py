from show_tell_tpu_torch.utils.logging import MetricsLogger
from show_tell_tpu_torch.utils.profiling import StepTimer

__all__ = ["MetricsLogger", "StepTimer"]
