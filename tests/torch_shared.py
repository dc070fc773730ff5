"""Arrays that the xdist workers of one test run make once and share.

A test module imports ``shared_dir`` (a session fixture) and calls
``shared_arrays(shared_dir, name, make)``: the first worker that asks runs
``make()`` and writes its arrays into the run's shared directory; the
others wait on a lock and read them."""

import fcntl
import os

import numpy as np
import pytest


@pytest.fixture(scope="session")
def shared_dir(tmp_path_factory):
    """A directory that every xdist worker of one run sees (each worker's
    base temp is a child of it), or this process's own without xdist."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def shared_arrays(shared, name, make):
    """``make()`` (a dict of arrays), made by the first worker that asks and
    read from the shared directory by the others."""
    path = shared / f"{name}.npz"
    with open(shared / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = shared / f"{name}.tmp.npz"
            np.savez(tmp, **make())
            os.replace(tmp, path)
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
