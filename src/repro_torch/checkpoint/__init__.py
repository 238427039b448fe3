"""Checkpoints of torch state (port of ``repro.checkpoint``): the atomic
pytree store and the CARD-deduplicated checkpoint store."""
from repro_torch.checkpoint.store import latest_step, list_steps, restore, save  # noqa: F401
from repro_torch.checkpoint.dedup_store import DedupCheckpointStore  # noqa: F401
