"""Data containers (counterpart of ``nif_tpu/data``): the point-wise
container. The sharded and grouped datasets, the native reader and the
device prefetch are not ported yet (ROADMAP Queue 1 item 7)."""
from .point_wise_data import PointWiseData

__all__ = ["PointWiseData"]
