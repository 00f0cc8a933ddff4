"""Device fleet, wireless uplink and round-cost models (static part)."""
