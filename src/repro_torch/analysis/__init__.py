"""Runtime analysis of the port (port of part of ``repro.analysis``): the
serving engine's sanitizer.  The reference's lint, contract, shard-check
and retrace layers come with a later slice."""
