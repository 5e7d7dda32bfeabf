"""Token data sources (port of ``repro/data``)."""
