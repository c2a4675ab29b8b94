"""Multi-device parallelism on torch.distributed (port of
constant_ph_tpu/parallel): the process-group layer (comm), pH replica
exchange and the replica batch over ranks (replica), the x-slab spatial
decomposition (spatial) and the multi-rank dry run (dryrun)."""
