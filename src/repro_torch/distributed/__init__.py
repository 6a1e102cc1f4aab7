"""Parallelism over a ``torch.distributed`` process group: the relational
engine's data parallelism, its layout rules and collectives (``spmd``) and
the explicit row-sharded SumProd (``collectives``); the LM's placement on
a (data, model) device mesh, the reference's logical-axis rules as
DTensor placements and the gather its placed steps run on (``sharding``)."""
