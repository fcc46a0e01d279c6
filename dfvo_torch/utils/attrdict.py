"""Attribute-style dictionary used for configurations.

Counterpart of ``dfvo_tpu/utils/attrdict.py``: configs support
``cfg.e_tracker.ransac.repeat`` access without the ``easydict`` dependency.
"""


class AttrDict(dict):
    """A dict whose items are also accessible as attributes, recursively."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d is None:
            d = {}
        d = dict(d)
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @classmethod
    def _convert(cls, value):
        if isinstance(value, dict) and not isinstance(value, AttrDict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._convert(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, self._convert(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e
