from .attrdict import AttrDict
from .configuration import ConfigLoader, read_yaml

__all__ = ["AttrDict", "ConfigLoader", "read_yaml"]
