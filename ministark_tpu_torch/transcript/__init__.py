from .iopattern import IOPattern
from .sponge import DigestSponge
from .merlin import Merlin, Arthur

__all__ = ["IOPattern", "DigestSponge", "Merlin", "Arthur"]
