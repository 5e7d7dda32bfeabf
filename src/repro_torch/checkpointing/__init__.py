"""Fault-tolerant checkpoints (port of ``repro/checkpointing``)."""
