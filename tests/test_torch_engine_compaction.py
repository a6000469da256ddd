"""Port TieredEngine vs the JAX engine and the port's dense decode: the
log-compaction case of tests/test_tiering.py (CPU, reduced qwen3-1.7b)."""
from test_torch_engine_cases import check_case


def test_engine_compaction_matches_jax_and_dense():
    stats = check_case("compaction")
    assert stats.compactions > 0
