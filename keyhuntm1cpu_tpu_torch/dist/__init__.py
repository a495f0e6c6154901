"""Multi-node distribution of the port: the coordinator/worker control
plane of keyhuntm1cpu_tpu/dist (the same wire protocol), with workers that
run the port's engines on the card.

    python -m keyhuntm1cpu_tpu_torch.dist.coordinator -p 17890 -r A:B -n UNITS
    python -m keyhuntm1cpu_tpu_torch.dist.worker -c HOST:17890 -f targets \\
        [-m bsgs|address|rmd160|xpoint|eth|minikeys] [--device cuda|cpu]
"""

__all__ = ["WorkCoordinator", "WorkUnit", "CoordinatorServer", "DistributedWorker"]


def __getattr__(name):
    # imported on first use, so that `python -m` of either module does not
    # find it imported already
    if name in ("WorkCoordinator", "WorkUnit", "CoordinatorServer"):
        from . import coordinator

        return getattr(coordinator, name)
    if name == "DistributedWorker":
        from .worker import DistributedWorker

        return DistributedWorker
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
