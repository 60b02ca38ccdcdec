"""The LyMDO controller: slot physics, convex allocators, environment,
objective sweep, scenario grid and runners (port of ``repro.core``)."""
