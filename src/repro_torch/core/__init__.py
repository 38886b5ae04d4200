"""GreenCache core — the paper's contribution: carbon-aware KV cache
resource management (carbon model, cache store + LCS policy, storage
tiers, resource plans, profiler, solver). The predictors, geo router and
controller come with the controller's day."""
from repro_torch.core.carbon import CarbonModel, GRID_CI, HardwareSpec
from repro_torch.core.kvstore import CacheEntry, KVStore
from repro_torch.core.plan import PoolSpec, ResourcePlan, enumerate_plans
from repro_torch.core.policies import POLICIES, lcs_score

__all__ = ["CarbonModel", "HardwareSpec", "GRID_CI", "KVStore", "CacheEntry",
           "POLICIES", "lcs_score", "ResourcePlan", "PoolSpec",
           "enumerate_plans"]
