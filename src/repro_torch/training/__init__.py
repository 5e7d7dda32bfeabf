"""The BLaST trainer (port of ``repro/training``)."""
