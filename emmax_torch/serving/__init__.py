from emmax_torch.serving.engine import GenerateOptions, ServingEngine

__all__ = ["ServingEngine", "GenerateOptions"]
