from emmax_torch.serving.engine import (GenerateOptions, ServingEngine,
                                        VisionCache)
from emmax_torch.serving.speculative import SpeculativeEngine

__all__ = ["ServingEngine", "GenerateOptions", "VisionCache",
           "SpeculativeEngine"]
