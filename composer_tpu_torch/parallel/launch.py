"""Starts the ranks of a mesh on one host.

The calling process becomes rank 0 and starts ranks 1 .. world - 1 itself,
each a process of its own (``torch.multiprocessing``, the spawn method);
they meet at a ``FileStore`` rendezvous in a fresh temporary directory.
A rank started here ignores SIGINT (Ctrl-C stops rank 0, which then stops
the others through the job's own messages) and logs only warnings and
errors. A rank that fails or does not finish in time fails the run: the
other ranks are terminated and ``run_ranks`` raises.
"""

from __future__ import annotations

import logging
import shutil
import signal
import tempfile

import torch
import torch.distributed as dist

from composer_tpu_torch.parallel import mesh as mesh_lib


def _child(target, rank: int, world: int, init_method: str, timeout, payload) -> None:
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    logging.getLogger().setLevel(logging.WARNING)
    mesh_lib.initialize_multihost(init_method, world, rank, timeout=timeout)
    try:
        target(payload, rank, world)
    finally:
        dist.destroy_process_group()


def _stop(children) -> None:
    for child in children:
        if child.is_alive():
            child.terminate()
    for child in children:
        child.join(10)
        if child.is_alive():
            child.kill()
            child.join()


def run_ranks(target, world: int, payload):
    """Runs ``target(payload, rank, world)`` on ``world`` ranks, rank 0 in
    this process, and returns rank 0's result. ``target`` must be a
    module-level function (the spawned ranks import it). The process groups'
    timeout, ``mesh.DEFAULT_TIMEOUT``, also bounds the other ranks' finishing
    once rank 0 has."""
    timeout = mesh_lib.DEFAULT_TIMEOUT
    store = tempfile.mkdtemp(prefix="composer-ranks-")
    init_method = f"file://{store}/store"
    context = torch.multiprocessing.get_context("spawn")
    children = [context.Process(target=_child, daemon=True,
                                args=(target, rank, world, init_method, timeout, payload))
                for rank in range(1, world)]
    for child in children:
        child.start()
    try:
        finished = False
        try:
            mesh_lib.initialize_multihost(init_method, world, 0, timeout=timeout)
            try:
                result = target(payload, 0, world)
            finally:
                dist.destroy_process_group()
            finished = True
        finally:
            if not finished:
                _stop(children)
        for rank, child in enumerate(children, start=1):
            child.join(timeout.total_seconds())
            if child.is_alive() or child.exitcode != 0:
                _stop(children)
                raise RuntimeError(f"rank {rank} of {world} failed (exit code "
                                   f"{child.exitcode})")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return result
