from .orchestrator import LossOrchestrator  # noqa: F401
from .zoo import LOSS_REGISTRY, get_loss  # noqa: F401
