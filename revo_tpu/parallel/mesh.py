"""Device-mesh and multi-host runtime helpers.

The reference has no distributed capability (SURVEY.md §2.2); here the
idiomatic JAX stack: ``jax.distributed`` initialization for multi-host runs
(driven by env, no custom transport code) and named-mesh construction whose
axes the rest of revo_tpu shards over:

- "seq":  data parallelism over sequences / sequence segments
- "pair" / "edge": reduction parallelism for windowed BA / pose-graph blocks
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import jax


def maybe_distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when running multi-host.

    Arguments default from the standard env (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID); nothing is auto-detected, so a
    cluster must be described explicitly.  Returns True when a multi-host
    runtime was initialized.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    n = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    pid = (
        process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "-1") or -1)
    )
    if coordinator_address and n > 1 and pid >= 0:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=n,
            process_id=pid,
        )
        return True
    return False


def make_mesh(
    axis_names: Sequence[str] = ("seq",),
    axis_sizes: Optional[Tuple[int, ...]] = None,
    devices=None,
) -> jax.sharding.Mesh:
    """Named mesh over all (or given) devices.

    With one axis, every device lands on it; with several, ``axis_sizes``
    must multiply to the device count (the first axis may be -1 to infer).
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if axis_sizes is None:
        if len(axis_names) != 1:
            raise ValueError("axis_sizes required for multi-axis meshes")
        shape: Tuple[int, ...] = (n,)
    else:
        sizes = list(axis_sizes)
        if sizes.count(-1) == 1:
            known = int(np.prod([s for s in sizes if s != -1]))
            sizes[sizes.index(-1)] = n // known
        if int(np.prod(sizes)) != n:
            raise ValueError(
                f"mesh {tuple(sizes)} does not cover {n} devices"
            )
        shape = tuple(sizes)
    return jax.sharding.Mesh(
        devices.reshape(shape), axis_names=tuple(axis_names)
    )
