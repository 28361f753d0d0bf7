from .metrics import mse, rel_l2, rmse
from .policy import Policy, get_policy
from .profiling import StepTimer, enable_nan_checks, trace
from .roofline import flops_per_point, step_report

__all__ = ["Policy", "get_policy", "trace", "StepTimer", "enable_nan_checks", "rel_l2", "mse",
           "rmse", "flops_per_point", "step_report"]
