"""Entry points (port of ``repro.launch``): ``serve``."""
