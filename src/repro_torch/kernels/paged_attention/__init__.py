"""``paged_attention``: one-token GQA decode attention over a paged KV pool."""
