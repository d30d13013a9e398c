"""The port's persistence sanitizer as a pytest plugin, the counterpart of
``tests/conftest.py``'s ``--pmem-sanitize`` fixtures for JAX's pmem:

    PYTHONPATH=src python -m pytest -p repro_torch.analysis.pytest_plugin \\
        --torch-pmem-sanitize tests/test_torch_checkpoint.py ...

With ``--torch-pmem-sanitize`` every test runs under a ``PMemSanitizer``
over the port's ``PMemRegion``/``PMemPool``, installed before the other
function-scope fixtures and removed after them (so a cluster's shutdown
runs inside the shimmed window and regions left dirty are caught).
Violations fail the test at teardown. ``torch_pmem_sanitizer`` is the
explicit capture-mode sanitizer for crash-state enumeration tests.
"""
from __future__ import annotations

import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--torch-pmem-sanitize", action="store_true", default=False,
        help="run every test under the port's persistence-order "
             "sanitizer (repro_torch.analysis.sanitizer)")


@pytest.fixture(autouse=True)
def _torch_pmem_sanitize(request):
    """With ``--torch-pmem-sanitize``: the test under the sanitizer, its
    violations raised at teardown; else ``None``."""
    if not request.config.getoption("--torch-pmem-sanitize"):
        yield None
        return
    from repro_torch.analysis.sanitizer import PMemSanitizer
    san = PMemSanitizer().install()
    try:
        yield san
    finally:
        san.uninstall()
    san.raise_violations()


@pytest.fixture()
def torch_pmem_sanitizer():
    """A capture-mode sanitizer (written bytes recorded, so
    ``crash_images()`` works), its violations raised at teardown."""
    from repro_torch.analysis.sanitizer import PMemSanitizer
    san = PMemSanitizer(capture=True).install()
    try:
        yield san
    finally:
        san.uninstall()
    san.raise_violations()
