"""Serving: the batched server and the spot-aware request frontend."""
