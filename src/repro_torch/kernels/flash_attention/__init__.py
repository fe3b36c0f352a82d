"""``flash_attention``: blockwise online-softmax GQA attention."""
