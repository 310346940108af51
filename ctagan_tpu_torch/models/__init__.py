__all__ = ["Discriminator", "Generator", "MultiScaleDiscriminator",
           "NLayerDiscriminator", "RegNet"]


def __getattr__(name):
    # lazy: the kernels' modules import models.layers, and the generator
    # imports the kernels' modules
    if name == "Generator":
        from ctagan_tpu_torch.models.generator import Generator

        return Generator
    if name == "RegNet":
        from ctagan_tpu_torch.models.reg import RegNet

        return RegNet
    if name in ("Discriminator", "NLayerDiscriminator",
                "MultiScaleDiscriminator"):
        from ctagan_tpu_torch.models import discriminator

        return getattr(discriminator, name)
    raise AttributeError(name)
