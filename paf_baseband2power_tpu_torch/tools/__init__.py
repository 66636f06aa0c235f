"""The repository's measurement tools on the port: ``host_runtime`` (the
ring and UDP capture on the host), ``multibeam`` (B beams through one
mesh of ranks against B serial pipelines), ``scaling`` (weak scaling of
the sharded power step over ranks), ``spectra_bench`` (the PFB and the
composed modes on both layouts), ``soak_matrix`` (the live-topology soak
matrices) and ``scaling_budget`` (the weak-scaling budget from the card's
own times)."""
