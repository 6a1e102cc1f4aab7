"""Data parallelism of the relational engine over a ``torch.distributed``
process group: the layout rules and collectives (``spmd``) and the
explicit row-sharded SumProd (``collectives``)."""
