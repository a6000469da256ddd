"""Continuous-batching serving engine with the SkyByte scheduler."""
