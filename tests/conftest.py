"""Shared pytest configuration: the derandomized hypothesis CI profile.

The scheduler-stress job (and tier-1 under ``REQUIRE_HYPOTHESIS=1``) must
be reproducible run-to-run, so CI loads a profile with ``derandomize=True``
(examples derived from the test, not the clock) and ``deadline=None``
(property bodies drive the full engine pipeline; wall-clock deadlines are
noise under thread contention). CI additionally passes
``--hypothesis-seed=0`` so even explicitly seeded features stay pinned.
"""

import os

try:
    from hypothesis import settings

    settings.register_profile(
        "ci", settings(derandomize=True, deadline=None, print_blob=True))
    if os.environ.get("REQUIRE_HYPOTHESIS") \
            or os.environ.get("HYPOTHESIS_PROFILE") == "ci":
        settings.load_profile("ci")
except ImportError:  # lean containers run the tests/_ht.py fallback instead
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA card and nvcc (the CUDA kernels of "
        "repro_torch); skips with a reason where torch.cuda.is_available() "
        "is False")
