"""Attribute-access dict used for all config trees.

Behavioral parity with the reference config container (dnnlib/util.py:41-54):
attribute get/set/del aliases item get/set/del.
"""


class EasyDict(dict):
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]
