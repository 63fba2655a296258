"""Shared inputs of the port's parity tests (tests/test_torch_*.py): the
reference fit, carried across to the port as plain arrays, and plans
rebuilt from the reference's node classes."""
import dataclasses
import functools

import jax
import numpy as np

import repro.warehouse as RW
from repro.configs.workloads import COVID
from repro.core.offline import fit
from repro_torch.convert import SCALARS, TABLES, fitted_from_arrays


@functools.lru_cache(maxsize=None)
def ref_fitted():
    """The reference fit every parity test starts from (about 9 s on
    one CPU core; cached per process)."""
    return fit(COVID, n_cores=8, days_unlabeled=2.0, seed=0)


def arrays_of(fitted):
    arrays = {k: np.asarray(getattr(fitted, k)) for k in TABLES + SCALARS}
    arrays["configs"] = fitted.configs
    arrays["forecaster"] = jax.tree.map(np.asarray, fitted.forecaster)
    return arrays


def port_fitted(device="cpu"):
    """The reference fit as the port's ``Fitted`` on ``device``."""
    f = ref_fitted()
    return fitted_from_arrays(f.workload.name, arrays_of(f), device=device)


def ref_plan(plan):
    """The same plan built from the reference's node classes."""
    return tuple(getattr(RW, type(n).__name__)(**dataclasses.asdict(n))
                 for n in plan)


def table_arrays(tables):
    """A reference ``SwitchTables`` (one stream's or stacked) as the
    ``{field: array}`` that ``convert.switch_tables_from_arrays`` takes."""
    return {f.name: np.asarray(getattr(tables, f.name))
            for f in dataclasses.fields(tables)}
