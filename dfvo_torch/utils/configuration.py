"""Hierarchical YAML configuration system.

Counterpart of ``dfvo_tpu/utils/configuration.py``: a default YAML is
recursively merged with optional custom YAMLs into an attribute-style
config. Writing the merged config (``save_cfg``) comes with the CLI.
"""

import yaml

from .attrdict import AttrDict


def read_yaml(filename):
    """Load a YAML file into an AttrDict. Returns empty AttrDict for None."""
    if filename is None:
        return AttrDict()
    with open(filename, "r") as f:
        data = yaml.safe_load(f)
    return AttrDict(data or {})


def _merge_into(dst, src):
    """Recursively merge ``src`` into ``dst`` (src wins), in place."""
    for key, val in src.items():
        if (
            key in dst
            and isinstance(dst[key], dict)
            and isinstance(val, dict)
        ):
            _merge_into(dst[key], val)
        else:
            dst[key] = val
    return dst


class ConfigLoader:
    """Loads and merges a list of YAML configuration files (later files win)."""

    def merge_cfg(self, cfg_files):
        """Merge config files into a single AttrDict.

        Args:
            cfg_files: list of YAML paths, e.g. [default, custom]; entries may
                be None (skipped). Later files override earlier files.
        """
        cfg = AttrDict()
        for f in cfg_files:
            if f is not None:
                _merge_into(cfg, read_yaml(f))
        return cfg
