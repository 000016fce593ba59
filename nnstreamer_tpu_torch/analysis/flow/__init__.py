"""flowcheck's runtime half: the declared conservation identities and
their check over live counter snapshots.

Port of the registry and runtime parts of
``nnstreamer_tpu/analysis/flow/``::

    from nnstreamer_tpu_torch.analysis.flow import check_identities
    check_identities(autoscaler.lifecycle(),
                     names=["fleet-replica-lifecycle"])

The static settlement analysis over the code is not ported
(``ROADMAP.md`` item 16).
"""
from .registry import (DECLARED_IDENTITIES, SPECS, Identity,  # noqa: F401
                       IdentityTerm, ResourceSpec, identities_by_name)
from .runtime import IdentityResult, check_identities  # noqa: F401

__all__ = [
    "ResourceSpec", "SPECS", "Identity", "IdentityTerm",
    "DECLARED_IDENTITIES", "identities_by_name", "check_identities",
    "IdentityResult",
]
