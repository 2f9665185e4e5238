"""pytest plugin: the port's opt-in runtime lock-order run.

Load it by name::

    python -m pytest -p deeplearning4j_torch.analysis.lock_debug \\
        tests/test_torch_runtime.py tests/test_torch_generation.py

Every test then runs between :func:`instrument.install` and
:func:`instrument.uninstall`, so each serving lock built inside it is a
rank-checked ``OrderedLock``/``OrderedCondition``. A violation raised in
the test's thread fails it directly; one raised on a serving loop's
thread becomes that loop's crash (and a supervised loop restarts), so the
plugin also fails a test during which any violation was recorded,
naming it. It is the port's counterpart of the JAX package's
``DL4J_TPU_LOCK_DEBUG=1`` fixture in ``tests/conftest.py``, which wraps
the JAX classes only.
"""

from __future__ import annotations

import pytest

from deeplearning4j_torch.analysis import instrument


def _report(seen):
    return "lock-order violation(s) during the test:\n" + "\n".join(seen)


@pytest.fixture(autouse=True)
def _torch_lock_order_debug():
    del instrument.violations[:]
    instrument.install()
    try:
        yield
    finally:
        instrument.uninstall()
    # a violation in the test's own teardown
    seen = list(instrument.violations)
    del instrument.violations[:]
    if seen:
        pytest.fail(_report(seen), pytrace=False)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    """A test whose body passed while some thread raised a violation
    fails, naming it."""
    outcome = yield
    rep = outcome.get_result()
    if call.when == "call" and rep.passed and instrument.violations:
        seen = list(instrument.violations)
        del instrument.violations[:]
        rep.outcome = "failed"
        rep.longrepr = _report(seen)
