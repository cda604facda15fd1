"""pytest settings of the benchmark's own tests (python -m pytest hrbench -q)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips inside the test where torch.cuda.is_available() "
        "is False")
