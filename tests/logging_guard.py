"""An autouse fixture for the CLI tests: ``setup_logging`` (the CLI's, in
both packages) binds a ``StreamHandler`` to the ``sys.stderr`` of the moment,
which pytest's capture closes when the test ends. Later tests in the same
worker would then log to a closed stream. The fixture puts the ``audioflow``
logger's handlers and level back after each test. Import it into a test
module to use it."""

import logging

import pytest


@pytest.fixture(autouse=True)
def restore_audioflow_logger():
    log = logging.getLogger("audioflow")
    handlers, level = log.handlers[:], log.level
    try:
        yield
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)
