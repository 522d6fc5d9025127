"""Simulation runners (port of ``corrosion_tpu.sim``)."""
