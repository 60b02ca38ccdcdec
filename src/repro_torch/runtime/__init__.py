"""Training runtime of the port: checkpointing, straggler monitoring and
restart policies (port of ``repro.runtime`` but for its compressed gradient
sync, which needs the mesh)."""
