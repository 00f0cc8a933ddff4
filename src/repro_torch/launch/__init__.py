"""Drivers: the chunked round engine and the `run_fl` CLI."""
