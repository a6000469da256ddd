"""Port TieredEngine vs the JAX engine and the port's dense decode: the
pool-pressure case of tests/test_tiering.py (parks and promotions)."""
from test_torch_engine_cases import check_case


def test_engine_pool_pressure_matches_jax_and_dense():
    stats = check_case("pool_pressure")
    assert stats.parks > 0 and stats.promoted_pages > 0
