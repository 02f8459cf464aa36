"""Shared fixtures.  NOTE: XLA device-count flags are NOT set here — smoke
tests and benches see 1 device; multi-device tests run via subprocess
(tests/multidev/)."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

try:
    # deterministic hypothesis profile for CI (HYPOTHESIS_PROFILE=ci):
    # derandomized with a fixed example budget so the property suite gives
    # the same verdict on every run of the same tree.  Loaded explicitly —
    # registering alone does nothing, and not every hypothesis version
    # honors the env var by itself.
    from hypothesis import settings as _hyp_settings
    _hyp_settings.register_profile(
        "ci", derandomize=True, max_examples=60, deadline=None,
        print_blob=True)
    if os.environ.get("HYPOTHESIS_PROFILE"):
        _hyp_settings.load_profile(os.environ["HYPOTHESIS_PROFILE"])
except ImportError:                     # property tests importorskip anyway
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")


def run_multidev(script: str, devices: int = 8, timeout: int = 600):
    """Run tests/multidev/<script> in a child python with N host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC
    path = os.path.join(REPO, "tests", "multidev", script)
    proc = subprocess.run([sys.executable, path], env=env, timeout=timeout,
                          capture_output=True, text=True)
    assert proc.returncode == 0, (
        f"{script} failed\n--- stdout ---\n{proc.stdout[-4000:]}"
        f"\n--- stderr ---\n{proc.stderr[-4000:]}")
    return proc.stdout
