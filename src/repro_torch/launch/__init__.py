"""Entry points of the LM substrate: ``serve`` (prefill + greedy decode)."""
