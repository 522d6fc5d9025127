"""Plain-Python helpers (port of ``corrosion_tpu.utils``)."""
