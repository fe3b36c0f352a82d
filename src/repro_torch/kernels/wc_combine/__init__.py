"""``wc_combine``: run boundaries + in-run rank of a sorted key array."""
