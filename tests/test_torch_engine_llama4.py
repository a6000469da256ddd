"""Port TieredEngine vs the JAX engine on reduced llama4-scout (top-1 of 4
experts and a shared expert, capacity-bounded): ServeStats equal, every
token a near tie of the replay of the engine's own batches (see
check_moe_case)."""
import pytest

from test_torch_engine_cases import check_moe_case


@pytest.mark.parametrize("case", ["compaction", "pool_pressure"])
def test_llama4_engine_matches_jax_and_replay(case):
    stats, _ = check_moe_case(case, "llama4-scout-17b-a16e")
    assert stats.compactions > 0
    if case == "pool_pressure":
        assert stats.parks > 0 and stats.promoted_pages > 0
