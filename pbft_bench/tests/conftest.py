"""The benchmark's own tests: `python -m pytest pbft_bench/tests -q` from
the repository's root (the repository's `pytest tests/` does not collect
them). Card-only tests carry the `cuda` marker and skip without a card,
deciding so inside the test."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
