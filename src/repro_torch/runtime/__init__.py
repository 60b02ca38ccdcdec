"""Training runtime of the port: checkpointing (port of part of
``repro.runtime``)."""
