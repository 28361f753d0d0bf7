"""Demo datasets (counterpart of ``nif_tpu/demo``)."""
from .datasets import CylinderFlow, TravelingWave, TravelingWaveHighFreq

__all__ = ["TravelingWave", "TravelingWaveHighFreq", "CylinderFlow"]
