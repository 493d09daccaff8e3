"""Utilities: checkpointing (``utils.checkpoint``)."""
