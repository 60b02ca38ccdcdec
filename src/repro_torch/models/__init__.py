"""The decoder stack the paper partitions: shared primitives, attention,
FFN and the transformer entry points."""
