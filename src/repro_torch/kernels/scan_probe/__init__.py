"""``scan_probe``: the fused SCAN reader-probe sweep (engine step 5c)."""
