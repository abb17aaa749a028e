"""One spawn of gloo ranks for every pytest worker of a session.

A module fixture of an xdist run runs on every worker that takes one of the
module's tests, so a fixture that spawns ranks would spawn them on each.
:func:`run_ranks_once` spawns once (``torch_dist_helpers.run_ranks``) and
shares the ranks' results through the session's temporary directory. Kept
apart from ``torch_dist_helpers``, which the spawned ranks import.
"""

import fcntl
import os

import torch
from torch_dist_helpers import run_ranks


def run_ranks_once(tmp_path_factory, key: str, world: int, body: str, *args) -> list:
    """:func:`run_ranks` once for every test worker of one session: the
    first worker to ask spawns the ranks and writes their results under the
    session's shared temporary directory (a lock held meanwhile), the others
    read them. A module fixture of an xdist run would spawn on every worker
    that takes one of the module's tests."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):  # each worker's base is <session>/popen-gwN
        root = root.parent
    done = os.path.join(str(root), f"{key}.pt")
    with open(os.path.join(str(root), f"{key}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(done):
            ranks = run_ranks(tmp_path_factory.mktemp(key), world, body, *args)
            torch.save(ranks, done + ".part")
            os.replace(done + ".part", done)
        return torch.load(done, weights_only=False)
