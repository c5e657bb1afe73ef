"""Models of the port: the dense decoder-only LM (``lm.py``), the Mamba2
SSM LM (``mamba_lm.py``), their config (``config.py``), shared plumbing
(``base.py``) and the factory (``registry.py``)."""
