"""A pytest plugin for a child pytest session: after each test's
teardown, without forcing a garbage collection, records the names of the
Python threads still alive; at the session's end writes
{test id: [thread names]} to the JSON file named by
$DVGGF_THREAD_CENSUS."""

import json
import os
import threading

_CENSUS = {}


def pytest_runtest_logfinish(nodeid, location):
    _CENSUS[nodeid] = sorted(t.name for t in threading.enumerate())


def pytest_sessionfinish(session, exitstatus):
    with open(os.environ["DVGGF_THREAD_CENSUS"], "w") as f:
        json.dump(_CENSUS, f)
