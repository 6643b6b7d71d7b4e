"""pytest settings of the benchmark's own tests (not collected with the
repository's tests/): the `cuda` marker for tests that need the card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without one; "
        "the decision is made inside the test)")
