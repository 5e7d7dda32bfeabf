"""Dense transformer family (port of ``repro/models``)."""
