"""Model configs (port of ``repro/configs``)."""
