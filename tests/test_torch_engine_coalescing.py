"""Port TieredEngine vs the JAX engine: the coalescing case of
tests/test_tiering.py — page writes ~ tokens / page_size, not ~ tokens."""
from test_torch_engine_cases import check_case


def test_engine_coalescing_matches_jax_and_dense():
    stats = check_case("coalescing", prompts={0: list(range(10, 34))}, n_new=32)
    assert stats.compactions >= 1
    assert stats.flushed_pages < stats.decoded_tokens
    assert stats.coalesce_ratio > 1.5
