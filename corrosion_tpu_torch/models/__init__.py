"""Protocol models: gossip broadcast and anti-entropy sync (port of
``corrosion_tpu.models``)."""
