"""Synthetic token pipeline (twin of ``repro.data``)."""
from repro_torch.data.pipeline import DataConfig, global_batch, host_shard

__all__ = ["DataConfig", "global_batch", "host_shard"]
