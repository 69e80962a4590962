"""Models of the port: GPT-2 and its KV-cached decode path."""
