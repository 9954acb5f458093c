"""scipsdp_tpu — a GPU-batched mixed-integer semidefinite programming (MISDP) framework.

A from-scratch re-design of the capabilities of SCIP-SDP (scipopt/SCIP-SDP
v4.4.0) for JAX/XLA on an NVIDIA GPU:

* ``models``   — problem data model + SDPA (.dat-s) / CBF readers & writers
                 (reference: src/scipsdp/reader_sdpa.c, reader_cbf.c).
* ``ops``      — batched dense linear algebra and the batched primal-dual
                 interior-point SDP solver that replaces the DSDP/SDPA/MOSEK
                 back-ends (reference: src/sdpi/sdpisolver_*.c).
* ``core``     — the solver-independent SDP interface (presolve + recovery
                 ladder, reference: src/sdpi/sdpi.c) and the vectorized
                 branch-and-bound orchestrator (replacing SCIP's tree +
                 src/scipsdp/relax_sdp.c / cons_sdp.c plugins).
* ``parallel`` — device-mesh scale-out: batched open-node relaxation solves
                 sharded over a ``jax.sharding.Mesh``.
* ``utils``    — config (mirrors SCIP-SDP's parameter names), statuses,
                 timing, logging.

The solver works in float64 by default (the reference's interior-point
back-ends are double precision; tolerances are 1e-5).  Set the environment
variable ``SCIPSDP_TPU_NO_X64=1`` before import to keep JAX in float32 mode.
"""

import os as _os

if not _os.environ.get("SCIPSDP_TPU_NO_X64"):
    import jax as _jax

    _jax.config.update("jax_enable_x64", True)

def compilation_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path, so later processes find what earlier ones cached)."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache for GPU runs of the
    entry points (the CLI, ``chip_smoke.py``, ``bench*.py``); returns the
    directory.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
    reads it, and only the entry thresholds are set here."""
    import jax as _jax

    cache = compilation_cache_dir()
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _os.makedirs(cache, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", cache)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache


from scipsdp_tpu.utils.config import Settings, default_settings  # noqa: E402
from scipsdp_tpu.utils.status import SolveStatus, SolverResultStatus  # noqa: E402
from scipsdp_tpu.models.problem import MISDP, SDPBlock, LinearConstraints  # noqa: E402
from scipsdp_tpu.models.io import read_problem  # noqa: E402
from scipsdp_tpu.core.branchbound import solve_misdp, BBResult  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Settings",
    "default_settings",
    "SolveStatus",
    "SolverResultStatus",
    "MISDP",
    "SDPBlock",
    "LinearConstraints",
    "read_problem",
    "solve_misdp",
    "BBResult",
    "enable_compilation_cache",
]
