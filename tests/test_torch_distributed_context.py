"""``repro_torch.distributed.context``, the port of the reference's
``repro.distributed.context``: a re-export of the logical-axis context
that :mod:`repro_torch.partitioning` holds, also exported by
``repro_torch.distributed`` as the reference's package exports it."""
import pytest

import repro_torch.distributed as tdist
from repro_torch import partitioning
from repro_torch.distributed import context

NAMES = ["axis_rules", "constrain", "current_rules", "default_rules",
         "logical_to_spec"]


@pytest.mark.parametrize("name", NAMES)
def test_context_reexports_partitioning(name):
    """Each name is partitioning's own object, in the module and in the
    package."""
    assert getattr(context, name) is getattr(partitioning, name)
    assert getattr(tdist, name) is getattr(partitioning, name)


def test_context_names_match_reference():
    """The module exports what the reference's does."""
    from repro.distributed import context as jcontext
    assert sorted(context.__all__) == sorted(jcontext.__all__) == NAMES
    assert set(tdist.__all__) == set(NAMES)
