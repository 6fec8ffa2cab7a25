"""Registers the ``gpu`` marker for the benchmark's tests (the repository's
``tests/conftest.py`` does not reach this folder)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA card (the benchmark's cells at their own "
        "sizes); skips with a reason where torch.cuda.is_available() is "
        "False")
