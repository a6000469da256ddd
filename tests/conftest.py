"""Shared test fixtures."""
import os

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True, scope="session")
def _no_engine_override():
    """A lingering REPRO_SIM_ENGINE (exported by benchmarks.run --engine
    sessions) overrides the cfg.engine the parity tests set explicitly,
    silently turning every reference-vs-batched comparison into a
    self-comparison. Strip it for the whole test session — unless
    REPRO_SIM_ENGINE_PIN=1 says the override is deliberate (scripts/ci.sh
    `ref` stage: the behavioural simulator subset forced onto the
    reference engine; never combine the pin with the parity suites)."""
    if os.environ.get("REPRO_SIM_ENGINE_PIN") == "1":
        yield
        return
    old = os.environ.pop("REPRO_SIM_ENGINE", None)
    yield
    if old is not None:
        os.environ["REPRO_SIM_ENGINE"] = old
