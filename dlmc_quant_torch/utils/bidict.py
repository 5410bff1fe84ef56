"""Bidirectional dict with slice-based reverse lookup.

``d[:value]`` returns the key mapping to ``value``.  The port's own copy
of ``dlmc_quant_tpu/utils/bidict.py`` (ref: dlmc/utils/bidict.py:4-21).
"""

from __future__ import annotations


class BiDict(dict):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._inverse = {v: k for k, v in self.items()}

    def __setitem__(self, key, value):
        if isinstance(key, slice):
            raise TypeError("cannot assign through a reverse lookup")
        if key in self:
            self._inverse.pop(self[key], None)
        super().__setitem__(key, value)
        self._inverse[value] = key

    def __getitem__(self, key):
        if isinstance(key, slice):
            if key.start is None and key.stop is not None \
                    and key.step is None:
                return self._inverse[key.stop]
            raise KeyError(key)
        return super().__getitem__(key)

    def __delitem__(self, key):
        self._inverse.pop(self[key], None)
        super().__delitem__(key)

    def inverse(self, value):
        return self._inverse[value]
