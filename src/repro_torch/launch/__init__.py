"""Entry points: ``serve`` (the flush-batching solve server and its CLI)."""
