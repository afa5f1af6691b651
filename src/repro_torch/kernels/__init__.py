"""Hand-written CUDA kernels of the port, their plain versions and dispatch."""


def tma_ready(t) -> bool:
    """A bf16 view the tensor-core kernels' TMA loads can read as it is:
    16-byte aligned, its three leading strides positive multiples of 8
    elements (16 bytes)."""
    return t.data_ptr() % 16 == 0 and all(s > 0 and s % 8 == 0 for s in t.stride()[:3])
