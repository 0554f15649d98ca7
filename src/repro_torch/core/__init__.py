"""HeterPS core of the port: cost model, scheduling plans, provisioning
(NumPy), the fused RL scheduler (``core.schedulers``, ``core.torch_cost``),
re-planning (``core.replan``) and the serve admission policy.  The names
below are the reference's ``repro.core`` exports; importing this package
loads NumPy only."""

from repro_torch.core.cost_model import (
    INFEASIBLE,
    BatchedCost,
    TrainingJob,
    batched_plan_cost,
    batched_soft_plan_cost,
    monetary_cost,
    pipeline_throughput,
    plan_cost,
    soft_plan_cost,
)
from repro_torch.core.plan import (
    ProvisioningPlan,
    SchedulingPlan,
    Stage,
    StageBatch,
    batched_build_stages,
    build_stages,
)
from repro_torch.core.profiles import (
    B_O,
    LAYER_KINDS,
    LayerProfile,
    PAPER_MODELS,
    paper_model_profiles,
    profile_layers,
)
from repro_torch.core.provision import (
    BatchedProvisioning,
    batched_provision,
    provision,
    provision_sta_ratio,
)
from repro_torch.core.resources import (
    CPU_CORE,
    TPU_V5E,
    V100,
    ResourceType,
    default_fleet,
    make_fleet,
)

__all__ = [
    "INFEASIBLE", "TrainingJob", "monetary_cost", "pipeline_throughput",
    "plan_cost", "soft_plan_cost", "ProvisioningPlan", "SchedulingPlan",
    "Stage", "build_stages", "B_O", "LAYER_KINDS", "LayerProfile",
    "PAPER_MODELS", "paper_model_profiles", "profile_layers", "provision",
    "provision_sta_ratio", "CPU_CORE", "TPU_V5E", "V100", "ResourceType",
    "default_fleet", "make_fleet",
    # batched evaluation path
    "BatchedCost", "StageBatch", "BatchedProvisioning",
    "batched_plan_cost", "batched_soft_plan_cost", "batched_build_stages",
    "batched_provision",
]
