"""Traffic drivers, one file a kind, found by the ``driver`` name of a cell."""
