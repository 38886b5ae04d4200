from repro_torch.serving.perfmodel import SERVING_MODELS, ServingModel, SLO
from repro_torch.serving.engine import ServingEngine, SimResult
from repro_torch.serving.cluster import (ClusterEngine, DisaggEngine, HashRing,
                                         ROUTERS, make_cluster)

__all__ = ["ServingModel", "SERVING_MODELS", "SLO", "ServingEngine",
           "SimResult", "ClusterEngine", "DisaggEngine", "HashRing",
           "ROUTERS", "make_cluster"]
