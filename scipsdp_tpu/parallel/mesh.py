"""Device-mesh scale-out for batched relaxation solves.

The reference's entire parallelism story is intra-process (BLAS threads,
optional OMP, and SCIP's concurrent-solver portfolio via SCIPsdpiClone,
sdpi.c:2144).  The device equivalents (SURVEY.md section 2.5):

* one chip: XLA kernel parallelism inside the batched IPM;
* one host, many chips: the open-node batch axis is sharded over a
  ``jax.sharding.Mesh`` axis ``"nodes"`` (the DP-like axis), and SDP blocks
  over ``"blocks"`` (the TP-like axis) — XLA inserts the psum/all-gather
  collectives for the cross-block reductions of the Schur complement over
  NVLink;
* many hosts: open-node partitioning per host with incumbent / dual-bound
  all-gather (parallel/multihost.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scipsdp_tpu.ops.ipm import IPMData, ipm_solve
from scipsdp_tpu.utils.config import IPMSettings


def mesh_key(mesh) -> Optional[tuple]:
    """Stable content key of a mesh for executable caches.  ``id(mesh)``
    is unsafe (CPython reuses ids after GC, aliasing a stale executable
    compiled for dead devices); axis names + device ids + shape are the
    identity that matters to a compiled graph."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names), mesh.devices.shape,
            tuple(d.id for d in mesh.devices.flat),
            getattr(mesh.devices.flat[0], "platform", "?"))


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("nodes",)) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices.

    With one axis the whole mesh is the node (batch) axis.  With two axes
    ("nodes", "blocks") devices are split evenly, blocks getting at most 2.
    """
    # LOCAL devices only: in a multi-host (jax.distributed) run each host
    # shards its own node batches over its own chips; the cross-host layer
    # is parallel/multihost.py (incumbent sync + work stealing), not a
    # global mesh
    devices = jax.local_devices()
    n = len(devices) if n_devices is None else n_devices
    if len(devices) < n:
        # only the CPU backend can offer virtual devices
        # (--xla_force_host_platform_device_count); on a GPU, too few
        # cards is an error
        hint = (f"; set XLA_FLAGS=--xla_force_host_platform_device_count="
                f"{n} for a virtual CPU mesh"
                if devices[0].platform == "cpu" else "")
        raise ValueError(
            f"mesh needs {n} devices, have {len(devices)} "
            f"{devices[0].platform} device(s){hint}")
    devices = np.asarray(devices[:n])
    if len(axes) == 1:
        return Mesh(devices.reshape(n), axes)
    assert len(axes) == 2
    nb = 2 if n % 2 == 0 else 1
    return Mesh(devices.reshape(n // nb, nb), axes)


def data_sharding(mesh: Mesh, data: IPMData) -> IPMData:
    """Sharding pytree for IPMData: per-bucket block axes sharded when the
    bucket's block count divides the mesh axis."""
    def bspec(t, ndim):
        blocks = None
        if "blocks" in mesh.axis_names:
            nb = mesh.shape["blocks"]
            if data.A[t].shape[0] % nb == 0:
                blocks = "blocks"
        return NamedSharding(mesh, P(*((blocks,) + (None,) * (ndim - 1))))

    nb_t = data.nbuckets
    return IPMData(
        A=tuple(bspec(t, 4) for t in range(nb_t)),
        C=tuple(bspec(t, 3) for t in range(nb_t)),
        dimmask=tuple(bspec(t, 2) for t in range(nb_t)),
        G=NamedSharding(mesh, P(None, None)),
        h=NamedSharding(mesh, P(None)),
        b_base=NamedSharding(mesh, P(None)),
        nvars=data.nvars,
        ndim_sdp=data.ndim_sdp,
        block_of=data.block_of,
    )


def sharded_solver(data: IPMData, settings: IPMSettings, mesh: Mesh):
    """Jitted batched IPM whose node-batch axis is sharded over the mesh.

    The returned function takes (b, lb, ub) with leading batch dimension a
    multiple of the "nodes" axis size.  Problem data is device-resident
    with blocks sharded over the "blocks" axis when the mesh has one.
    """
    dshard = data_sharding(mesh, data)
    data = jax.device_put(data, dshard)
    vec = NamedSharding(mesh, P("nodes", None))

    @functools.partial(
        jax.jit,
        in_shardings=(dshard, vec, vec, vec),
        donate_argnums=(),
    )
    def solve(d, b, lb, ub):
        return ipm_solve(d, b, lb, ub, settings=settings)

    return functools.partial(solve, data)
