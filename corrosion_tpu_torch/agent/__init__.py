"""The host agent's storage layer (port of ``corrosion_tpu.agent``):
``storage`` (the CRDT storage engine and its batched apply), ``pack``
(the value codec's Python twins), ``locks`` and ``metrics``, copies of
the reference's modules re-rooted on this package."""
