from .export import predict, predict_grouped, predict_shared_mesh

__all__ = ["predict", "predict_grouped", "predict_shared_mesh"]
