from .export import export_apply, load_exported, predict, predict_grouped, predict_shared_mesh

__all__ = ["predict", "predict_grouped", "predict_shared_mesh", "export_apply", "load_exported"]
