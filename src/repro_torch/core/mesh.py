"""Mesh geometry for the port: ``(hosts, cores_per_host)`` resolution.

A plan core is one partition of the work (see :mod:`repro_torch.core.partition`);
``mesh_shape`` fixes how many there are.  This slice ports the geometry
helpers the engine needs; the two-level ``plan_hierarchical`` placement is
not ported yet (ROADMAP A4) and the ``"hierarchical"`` planner raises.
"""
from __future__ import annotations

import warnings

__all__ = [
    "MeshShapeError",
    "host_of_core",
    "resolve_mesh_shape",
]


class MeshShapeError(ValueError):
    """A mesh shape that cannot be planned or executed: non-integral
    geometry, a hosts/cores product disagreeing with ``n_cores``, or a
    plan whose core count does not match the devices the engine would
    execute on.  Subclasses ``ValueError`` so existing ``pytest.raises``
    guards keep matching; the message always says what to change."""


def resolve_mesh_shape(
    mesh_shape,
    n_cores,
    *,
    default_cores: int | None = None,
    warn: bool = True,
) -> tuple[int, int]:
    """Resolve the EngineConfig mesh fields to ``(hosts, cores_per_host)``.

    ``mesh_shape`` wins when given (a 2-sequence of positive ints; JSON
    round-trips deliver it as a list).  The legacy scalar ``n_cores`` keeps
    working as ``(1, n_cores)`` with a :class:`DeprecationWarning`; both
    given together must agree (``hosts * cores_per_host == n_cores``).
    Neither given resolves to ``(1, default_cores)`` — the engine passes
    ``torch.cuda.device_count()``.
    """
    if mesh_shape is not None:
        try:
            hosts, cph = (int(v) for v in mesh_shape)
        except (TypeError, ValueError):
            raise MeshShapeError(
                f"mesh_shape must be a (hosts, cores_per_host) pair of "
                f"positive ints, got {mesh_shape!r}"
            ) from None
        if hosts <= 0 or cph <= 0:
            raise MeshShapeError(
                f"mesh_shape entries must be positive, got {mesh_shape!r}"
            )
        if n_cores is not None and int(n_cores) != hosts * cph:
            raise MeshShapeError(
                f"mesh_shape {hosts}x{cph} = {hosts * cph} cores "
                f"disagrees with n_cores={n_cores}; drop the deprecated "
                "n_cores field (mesh_shape already determines it)"
            )
        return hosts, cph
    if n_cores is not None:
        if int(n_cores) <= 0:
            raise MeshShapeError(f"n_cores must be positive, got {n_cores}")
        if warn:
            warnings.warn(
                "EngineConfig.n_cores is deprecated: pass "
                f"mesh_shape=(1, {int(n_cores)}) instead (scalar n_cores "
                "plans a single-host mesh)",
                DeprecationWarning,
                stacklevel=3,
            )
        return 1, int(n_cores)
    return 1, int(default_cores or 1)


def host_of_core(core: int, cores_per_host: int) -> int:
    """Flat core id -> host id (cores are host-contiguous: host ``h`` owns
    ``[h*C, (h+1)*C)``)."""
    return core // max(cores_per_host, 1)
