"""Hierarchical YAML configuration system.

Counterpart of ``dfvo_tpu/utils/configuration.py``: a default YAML is
recursively merged with optional custom YAMLs into an attribute-style
config; ``save_cfg`` writes the merged config with each value that
differs from the default annotated ``# |CHANGED|``.
"""

import os

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

    def save_cfg(self, cfg_files, file_path):
        """Write the merged config to ``file_path``; lines whose value
        differs from the default (the first file) end with
        ``# |CHANGED| default: <value>``. Returns the merged config."""
        default = self.merge_cfg(cfg_files[:1])
        merged = self.merge_cfg(cfg_files)
        lines = []
        _annotated_dump(merged, default, lines, indent=0)
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
        with open(file_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return merged


def _annotated_dump(merged, default, lines, indent):
    pad = "    " * indent
    for key, val in merged.items():
        dval = default.get(key, "__MISSING__") if isinstance(default, dict) else "__MISSING__"
        if isinstance(val, dict):
            lines.append(f"{pad}{key}:")
            _annotated_dump(val, dval if isinstance(dval, dict) else {}, lines, indent + 1)
            continue
        rendered = yaml.safe_dump({key: _plain(val)}, default_flow_style=True)
        rendered = rendered.strip().rstrip("}").lstrip("{")
        if val != dval:
            lines.append(f"{pad}{rendered}  # |CHANGED| default: {dval}")
        else:
            lines.append(f"{pad}{rendered}")


def _plain(val):
    if isinstance(val, AttrDict):
        return val.to_dict()
    if isinstance(val, tuple):
        return list(val)
    return val
