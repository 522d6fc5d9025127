"""Packed CRDT keys and their merge (port of ``corrosion_tpu.ops``)."""
