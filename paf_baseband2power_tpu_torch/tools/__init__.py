"""The repository's measurement tools on the port: ``host_runtime`` (the
ring and UDP capture on the host), ``multibeam`` (B beams through one
mesh of ranks against B serial pipelines) and ``scaling`` (weak scaling of
the sharded power step over ranks)."""
