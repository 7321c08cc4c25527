"""Data and tensor parallelism over `torch.distributed` (counterpart of
`mtasr_tpu/parallel/`): `multihost` joins the process group, `mesh` lays
the ranks out as dp x tp and shards models and batches, `collectives`
holds the tensor-parallel region operators."""
