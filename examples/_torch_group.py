"""What the example twins (``examples/torch_*.py``) share: joining the
process group that ``torchrun`` describes, and printing from its first
process.  Imports nothing but torch."""

import contextlib
import os

import torch.distributed as dist


@contextlib.contextmanager
def process_group(backend: str | None):
    """Join the group that ``torchrun`` describes (``WORLD_SIZE`` > 1 in the
    environment) for the duration of the block, unless one exists already
    (then it stays the caller's).  gloo by default: several processes may
    share one card; nccl takes one card per process."""
    own = not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1
    if own:
        dist.init_process_group(backend or "gloo")
    try:
        yield dist.get_world_size() if dist.is_initialized() else 1
    finally:
        if own:
            dist.destroy_process_group()


def say(*args) -> None:
    """Print from the first process only (every process computes the same
    gathered figures)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*args, flush=True)


def add_device(ap) -> None:
    """The options every twin takes: device and kernel path."""
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card (the kernels); cpu: the plain PyTorch path")
    ap.add_argument("--kernel", default="auto", choices=["auto", "cuda", "ref"],
                    help="auto: the kernel on a CUDA tensor, the plain version on the CPU")


def add_common(ap) -> None:
    """The grid twins' shared options: device, kernel path, group backend."""
    add_device(ap)
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="process-group backend under torchrun (default gloo)")
    ap.add_argument("--dims", default=None, metavar="X,Y,Z",
                    help="global blocks per dim (default one block per process); a "
                         "multiple of the process layout under torchrun")


def device_arg(args):
    """``--device`` as the apps take it (None: the CUDA card, per process)."""
    return None if args.device == "cuda" else "cpu"


def dims_arg(args):
    """``--dims`` as the apps take it (None: one block per process)."""
    return None if args.dims is None else tuple(int(n) for n in args.dims.split(","))
