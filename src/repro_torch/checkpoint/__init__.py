"""Checkpointing of the torch train state (port of ``repro/checkpoint``)."""
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
