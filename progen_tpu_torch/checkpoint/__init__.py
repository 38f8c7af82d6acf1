from progen_tpu_torch.checkpoint.store import CheckpointStore

__all__ = ["CheckpointStore"]
