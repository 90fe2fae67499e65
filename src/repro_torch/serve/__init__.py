"""Ring KV cache, paged adapter registry and the serving engine."""
