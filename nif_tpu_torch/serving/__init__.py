from .export import predict, predict_grouped

__all__ = ["predict", "predict_grouped"]
