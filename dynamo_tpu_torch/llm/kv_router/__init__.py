"""KV-aware routing, worker side: the KV event and load-metrics publishers."""
