__all__ = ["Generator"]


def __getattr__(name):
    # lazy: the kernels' modules import models.layers, and the generator
    # imports the kernels' modules
    if name == "Generator":
        from ctagan_tpu_torch.models.generator import Generator

        return Generator
    raise AttributeError(name)
