"""Protocol models: gossip broadcast, anti-entropy sync and SWIM
membership (port of ``corrosion_tpu.models``)."""
