"""Attribute-access dict, the port's copy of videomamba_tpu/utils/easydict.py
(the reference's ``utils/easydict.py``).

Recursively wraps nested dicts/lists so config trees support both
``cfg["a"]["b"]`` and ``cfg.a.b``; attribute assignment keeps dict state in
sync (the property the reference's config merging relies on).
"""

from __future__ import annotations


class EasyDict(dict):
    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d is None:
            d = {}
        if kwargs:
            d = {**d, **kwargs}
        for k, v in d.items():
            setattr(self, k, v)
        # Class attributes defined by subclasses become instance entries.
        for k in self.__class__.__dict__.keys():
            if not (k.startswith("__") and k.endswith("__")) and k not in (
                "update", "pop"
            ):
                setattr(self, k, getattr(self, k))

    def __setattr__(self, name, value):
        if isinstance(value, (list, tuple)):
            value = type(value)(
                self.__class__(x) if isinstance(x, dict) else x for x in value
            )
        elif isinstance(value, dict) and not isinstance(value, self.__class__):
            value = self.__class__(value)
        super().__setattr__(name, value)
        super().__setitem__(name, value)

    __setitem__ = __setattr__

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def update(self, e=None, **f):
        d = e or dict()
        d.update(f)
        for k in d:
            setattr(self, k, d[k])

    def pop(self, k, *args):
        if hasattr(self, k):
            object.__delattr__(self, k)
        return super().pop(k, *args)
