"""Physical execution: host-orchestrated, device-computed."""

from hyperspace_tpu_torch.execution.executor import execute

__all__ = ["execute"]
