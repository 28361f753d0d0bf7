from .metrics import mse, rel_l2, rmse
from .policy import Policy, get_policy
from .profiling import StepTimer, enable_nan_checks, trace

__all__ = ["Policy", "get_policy", "trace", "StepTimer", "enable_nan_checks", "rel_l2", "mse",
           "rmse"]
