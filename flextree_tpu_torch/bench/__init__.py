"""Benchmarks of the port: ``python -m flextree_tpu_torch.bench`` (the
allreduce and the fold; :mod:`.harness`)."""
