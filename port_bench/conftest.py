"""pytest settings of the benchmark's own tests (port_bench/tests)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one (decided in the test)")
