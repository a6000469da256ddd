"""Tiered KV runtime (the SkyByte memory system applied to the KV cache)."""
