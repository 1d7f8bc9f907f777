"""The port's hand-written CUDA kernels.  ``build`` compiles and binds
them; each kernel module registers its kernel and its ``mgtpu`` ops when
it is imported."""
import importlib

MODULES = ("segment_sum", "segment_max", "windowed", "dma_gather", "pathway")


def import_all() -> None:
    """Import every kernel module, so that ``build.REGISTRY`` holds every
    kernel and ``torch.ops.mgtpu`` every op."""
    for name in MODULES:
        importlib.import_module(f"{__name__}.{name}")
