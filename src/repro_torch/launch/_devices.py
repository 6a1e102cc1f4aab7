"""The launch CLIs' shared ``--mesh`` flag.

``--mesh N`` runs the relational workload data-parallel over N ranks,
one process each, started by ``torchrun --nproc-per-node N``: on the CPU
over gloo, on CUDA over NCCL with one card a rank.  Every rank runs the
same seeded program; rank 0 prints.  (The JAX package's ``--devices``,
which splits one host into several XLA devices before JAX is imported,
has no counterpart here: a torch rank is a process.)
"""
from __future__ import annotations


def add_device_args(ap) -> None:
    """Register ``--mesh`` on a CLI parser (0 = one process, the default;
    -1 = every rank of the launched world)."""
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard factors data-parallel over N ranks; start the N "
                         "processes with torchrun --nproc-per-node N (0 = off, "
                         "-1 = the launched world)")


def resolve_mesh(args):
    """The data mesh ``args`` asks for, or None; ``--mesh N`` raises
    unless the launched world has N processes."""
    n = getattr(args, "mesh", 0)
    if not n:
        return None
    from .mesh import make_data_mesh

    return make_data_mesh(None if n < 0 else n, device=args.device)


def is_lead(mesh) -> bool:
    """True on the rank that prints and serves (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0


def barrier(mesh) -> None:
    """Wait for every rank of ``mesh`` (nothing to wait for without one)."""
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        dist.barrier(group=mesh.group)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
