"""Parameter trees on npz, and the version-indexed global-model store of
the port."""
from repro_torch.ckpt.checkpoint import (CheckpointStore, load_pytree,
                                         save_pytree)

__all__ = ["CheckpointStore", "load_pytree", "save_pytree"]
