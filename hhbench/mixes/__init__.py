"""Traffic drivers, one a kind of traffic; ``traffic/<name>.json`` names
its driver under ``driver`` and holds its parameters."""
