"""BLaST core: block pruning, packing, sparse MLP (port of ``repro/core``)."""
