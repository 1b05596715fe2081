"""Distribution over ``torch.distributed``: sharding rules, gradient
compression and pipeline parallelism (the port of ``repro.distrib``)."""
