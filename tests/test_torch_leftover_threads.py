"""The snapshot-cache tests (tests/test_torch_snapshot_cache.py) leave no
thread of the port's running in their process: its decode pools, host
read-ahead, device prefetcher and checkpoint writers all end with the
test that started them, not at some later garbage collection.

The cases that start threads run in one child pytest session (its own
base temp directory, so xdist workers never share one); a plugin
(tests/_torch_thread_census.py) lists the Python threads alive after
each case's teardown, without forcing a collection. Only the main thread
may be left. (A reference test that ran after this file in one process,
test_native_tfrecord.py::test_build_imagenet_uses_native_tfrecord,
crashed now and then; its faulting thread is TensorFlow's own, in
tf.data's symbolic checkpoint of a parallel interleave, with no frame of
the port, so the child runs the port's cases alone.)"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The cases of the snapshot-cache file that start threads
_THREADED = ("fit_across_the_switch or command_line or concurrent_knob "
             "or next_into_lent_buffers or thread_knob")


def test_snapshot_cache_tests_leave_no_thread_running(tmp_path):
    census = tmp_path / "census.json"
    env = {**os.environ, "DVGGF_THREAD_CENSUS": str(census),
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(REPO, "tests"), REPO]
               + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist",
         "-p", "no:cacheprovider", "-p", "_torch_thread_census",
         f"--basetemp={tmp_path / 'child'}",
         "tests/test_torch_snapshot_cache.py", "-k", _THREADED],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "5 passed" in proc.stdout, proc.stdout[-2000:]
    with open(census) as f:
        left = json.load(f)
    assert len(left) == 5
    assert {k: v for k, v in left.items() if v != ["MainThread"]} == {}
