"""Layers of the port's LM stack: norms, rotary, MLP, attention."""
