"""Utilities: checkpointing (``utils.checkpoint``) and timing
(``utils.timing``)."""
