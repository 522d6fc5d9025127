"""Packed CRDT keys, their merge, the columnar winner selection and the
device clock cache (port of ``corrosion_tpu.ops``).

Exports resolve lazily (PEP 562), as the reference's do: importing the
package loads none of its modules until a name is asked for.
"""

_KEYS = ("KeyCodec", "DEFAULT_CODEC")
_MERGE = ("merge_keys", "scatter_merge", "merge_cells")
_DEVCACHE = ("DeviceClockCache", "NumpyStore", "TorchStore",
             "default_enabled", "DEFAULT_SLOTS")

__all__ = list(_KEYS + _MERGE + _DEVCACHE)


def __getattr__(name):
    if name in _KEYS:
        from corrosion_tpu_torch.ops import keys

        return getattr(keys, name)
    if name in _MERGE:
        from corrosion_tpu_torch.ops import merge

        return getattr(merge, name)
    if name in _DEVCACHE:
        from corrosion_tpu_torch.ops import devcache

        return getattr(devcache, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
