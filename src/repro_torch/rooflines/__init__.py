"""Roofline accounting of the dry-run (port of ``repro.rooflines``):
``roofline`` (the three-term step-time model on this card's constants),
``counter`` (matrix-product FLOPs and argument bytes from the port's own
step on meta tensors, where the reference parses compiled HLO) and
``report`` (the table of a dry-run's JSONs)."""
