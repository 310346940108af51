__all__ = ["Discriminator", "Generator", "RegNet"]


def __getattr__(name):
    # lazy: the kernels' modules import models.layers, and the generator
    # imports the kernels' modules
    if name == "Generator":
        from ctagan_tpu_torch.models.generator import Generator

        return Generator
    if name == "RegNet":
        from ctagan_tpu_torch.models.reg import RegNet

        return RegNet
    if name == "Discriminator":
        from ctagan_tpu_torch.models.discriminator import Discriminator

        return Discriminator
    raise AttributeError(name)
