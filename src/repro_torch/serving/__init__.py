"""The ES tier: the paged KV pool, the continuous-batching engine and the
partitioned two-tier forward pass."""
