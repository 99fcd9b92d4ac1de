"""KV event types shared by engines (the mock engine itself is not ported)."""
