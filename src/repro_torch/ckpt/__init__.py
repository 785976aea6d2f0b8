"""Version-indexed global-model store of the port."""
from repro_torch.ckpt.checkpoint import CheckpointStore

__all__ = ["CheckpointStore"]
