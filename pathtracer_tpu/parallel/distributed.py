"""Multi-host execution (SURVEY.md §2.4, §7 step 8).

The reference is single-browser/single-GPU; the scaling story here is
``jax.distributed``: N processes (one per host) initialize against a
coordinator, after which ``jax.devices()`` is the *global* device set and
every collective compiled by XLA (the ``psum`` in
``parallel.render._pool_sharded`` and in ``inverse.make_train_step``)
crosses process boundaries — NCCL between GPUs, Gloo/TCP on CPU (which is
how the N-process localhost test runs; tests/test_multihost.py).

Environment variables (all optional — flags win over env):

- ``PT_TPU_COORDINATOR``   e.g. "10.0.0.1:8476" or "127.0.0.1:8476"
- ``PT_TPU_NUM_PROCESSES`` total process count
- ``PT_TPU_PROCESS_ID``    this process's rank

Nothing is auto-detected: a multi-process run names its coordinator
(``localhost:<port>`` on one host), process count and rank.
"""

from __future__ import annotations

import os


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Wire this process into a multi-host JAX runtime.

    No-op when neither flags nor env request multi-process (single-host
    runs stay zero-config). Call once, before any other JAX API touches
    the backend.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "PT_TPU_COORDINATOR"
    )
    if num_processes is None and "PT_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PT_TPU_NUM_PROCESSES"])
    if process_id is None and "PT_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PT_TPU_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        # Single-process run.
        return

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_initialized() -> bool:
    import jax

    return jax.process_count() > 1


def process_index() -> int:
    import jax

    return jax.process_index()


def sync_global_devices(tag: str = "barrier") -> None:
    """Barrier across all processes (e.g. before process 0 writes a PNG)."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(tag)
