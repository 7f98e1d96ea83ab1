"""One train step of the Mamba2 and the Jamba hybrid (mamba2-370m, jamba-1.5-large-398b) configurations against ``repro.train``.

Split from ``test_torch_train.py`` (whose docstring states the
tolerances) so that ``--dist loadfile`` runs each config family on its
own worker; the checks are ``_torch_train_steps.py``'s.
"""

import pytest

from _torch_train_steps import (check_remat_equals_no_remat, check_train_step,
                                SSM_ARCHS)
from _torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_train_step_equals_reference(arch, grad_accum):
    check_train_step(arch, grad_accum)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b"])
def test_remat_equals_no_remat_bit_for_bit(arch):
    check_remat_equals_no_remat(arch)
