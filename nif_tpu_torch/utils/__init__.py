from .metrics import mse, rel_l2, rmse
from .policy import Policy, get_policy

__all__ = ["Policy", "get_policy", "rel_l2", "mse", "rmse"]
