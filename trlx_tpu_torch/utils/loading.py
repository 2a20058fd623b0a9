"""Registry lookups (counterpart of :mod:`trlx_tpu.utils.loading`)."""

from trlx_tpu_torch.orchestrator import get_orchestrator
from trlx_tpu_torch.pipeline import get_datapipeline as get_pipeline
from trlx_tpu_torch.trainer import get_trainer

__all__ = ["get_trainer", "get_pipeline", "get_orchestrator"]
