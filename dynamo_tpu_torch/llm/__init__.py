"""Serving-pipeline pieces the engine needs: protocol types, token block
hashing, the byte tokenizer and KV events."""
