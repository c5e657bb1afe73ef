"""Models of the port: the dense decoder-only LM (``lm.py``), its config
(``config.py``), shared plumbing (``base.py``) and the factory
(``registry.py``)."""
