"""Serving: batched prefill + KV-cache decode (engine.generate)."""
